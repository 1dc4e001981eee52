from tasmania_jax.dwarfs.diagnostics import HorizontalVelocity, WaterConstituent
from tasmania_jax.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_jax.dwarfs.horizontal_hyperdiffusion import HorizontalHyperDiffusion
from tasmania_jax.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_jax.dwarfs.vertical_damping import VerticalDamping

__all__ = [
    "HorizontalVelocity",
    "WaterConstituent",
    "HorizontalDiffusion",
    "HorizontalHyperDiffusion",
    "HorizontalSmoothing",
    "VerticalDamping",
]
