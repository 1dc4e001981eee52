from tasmania_jax.burgers.dynamics.advection import BurgersAdvection
from tasmania_jax.burgers.dynamics.dycore import BurgersDynamicalCore
from tasmania_jax.burgers.dynamics.stepper import BurgersStepper
from tasmania_jax.burgers.physics.diffusion import BurgersHorizontalDiffusion
from tasmania_jax.burgers.state import ZhaoSolutionFactory, ZhaoStateFactory

__all__ = [
    "BurgersAdvection",
    "BurgersDynamicalCore",
    "BurgersStepper",
    "BurgersHorizontalDiffusion",
    "ZhaoSolutionFactory",
    "ZhaoStateFactory",
]
