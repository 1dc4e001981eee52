from tasmania_jax.domain import boundaries  # noqa: F401  (register subclasses)
from tasmania_jax.domain.domain import Domain
from tasmania_jax.domain.grid import Grid, NumericalGrid, PhysicalGrid
from tasmania_jax.domain.horizontal_boundary import HorizontalBoundary
from tasmania_jax.domain.horizontal_grid import (
    HorizontalGrid,
    NumericalHorizontalGrid,
    PhysicalHorizontalGrid,
)
from tasmania_jax.domain.topography import (
    NumericalTopography,
    PhysicalTopography,
    Topography,
)

__all__ = [
    "Domain",
    "Grid",
    "NumericalGrid",
    "PhysicalGrid",
    "HorizontalBoundary",
    "HorizontalGrid",
    "NumericalHorizontalGrid",
    "PhysicalHorizontalGrid",
    "NumericalTopography",
    "PhysicalTopography",
    "Topography",
]
