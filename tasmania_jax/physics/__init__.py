from tasmania_jax.physics.microphysics import (
    Clipping,
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentDiagnostic,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
    Precipitation,
    SedimentationFlux,
)
from tasmania_jax.physics.static_energy import DryStaticEnergy, MoistStaticEnergy
from tasmania_jax.physics.turbulence import Smagorinsky2d

__all__ = [
    "Clipping",
    "KesslerFallVelocity",
    "KesslerMicrophysics",
    "KesslerSaturationAdjustmentDiagnostic",
    "KesslerSaturationAdjustmentPrognostic",
    "KesslerSedimentation",
    "Precipitation",
    "SedimentationFlux",
    "DryStaticEnergy",
    "MoistStaticEnergy",
    "Smagorinsky2d",
]
