from tasmania_jax.physics.microphysics.kessler import (
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentDiagnostic,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
)
from tasmania_jax.physics.microphysics.utils import (
    Clipping,
    Precipitation,
    SedimentationFlux,
)

__all__ = [
    "KesslerFallVelocity",
    "KesslerMicrophysics",
    "KesslerSaturationAdjustmentDiagnostic",
    "KesslerSaturationAdjustmentPrognostic",
    "KesslerSedimentation",
    "Clipping",
    "Precipitation",
    "SedimentationFlux",
]
