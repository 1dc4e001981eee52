"""tasmania-jax: a JAX framework for composable finite-difference
weather/climate models (JAX / XLA / shard_map).

Built from scratch with the capability surface of stubbiali/tasmania; see
SURVEY.md for the layer map.
"""

__version__ = "0.1.0"

from tasmania_jax import burgers, domain, dwarfs, framework, isentropic, parallel, physics  # noqa: F401
from tasmania_jax.framework.field import FieldArray  # noqa: F401
