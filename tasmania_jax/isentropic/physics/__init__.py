from tasmania_jax.isentropic.physics.coriolis import IsentropicConservativeCoriolis
from tasmania_jax.isentropic.physics.diagnostics import (
    IsentropicDiagnostics,
    IsentropicVelocityComponents,
)
from tasmania_jax.isentropic.physics.horizontal_diffusion import (
    IsentropicHorizontalDiffusion,
)
from tasmania_jax.isentropic.physics.horizontal_smoothing import (
    IsentropicHorizontalSmoothing,
)
from tasmania_jax.isentropic.physics.turbulence import IsentropicSmagorinsky
from tasmania_jax.isentropic.physics.vertical_advection import (
    IsentropicVerticalAdvection,
    PrescribedSurfaceHeating,
)
from tasmania_jax.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
    IsentropicImplicitVerticalAdvectionPrognostic,
)
from tasmania_jax.isentropic.physics.sequential_tendency_stepper import (
    IsentropicVerticalAdvectionSTS,
)

__all__ = [
    "IsentropicConservativeCoriolis",
    "IsentropicDiagnostics",
    "IsentropicVelocityComponents",
    "IsentropicHorizontalDiffusion",
    "IsentropicHorizontalSmoothing",
    "IsentropicSmagorinsky",
    "IsentropicVerticalAdvection",
    "PrescribedSurfaceHeating",
    "IsentropicImplicitVerticalAdvectionDiagnostic",
    "IsentropicImplicitVerticalAdvectionPrognostic",
    "IsentropicVerticalAdvectionSTS",
]
