from tasmania_jax.isentropic.dynamics.diagnostics import IsentropicDiagnostics
from tasmania_jax.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tasmania_jax.isentropic.dynamics.horizontal_fluxes import (
    IsentropicHorizontalFlux,
    IsentropicMinimalHorizontalFlux,
)
from tasmania_jax.isentropic.dynamics.prognostic import IsentropicPrognostic
from tasmania_jax.isentropic.state import (
    get_isentropic_state_from_brunt_vaisala_frequency,
    get_isentropic_state_from_temperature,
)

__all__ = [
    "IsentropicDiagnostics",
    "IsentropicDynamicalCore",
    "IsentropicHorizontalFlux",
    "IsentropicMinimalHorizontalFlux",
    "IsentropicPrognostic",
    "get_isentropic_state_from_brunt_vaisala_frequency",
    "get_isentropic_state_from_temperature",
]
