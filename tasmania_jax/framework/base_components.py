"""Grid/domain-aware component mixins.

JAX re-design of reference ``src/tasmania/framework/base_components.py:42,57,143``:
staggered-field shape inference from field-name conventions, domain/grid-type
plumbing, and physical-constants resolution.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from tasmania_jax.framework.field import field_shape
from tasmania_jax.utils.constants import get_physical_constants


class GridComponent:
    """Mixin exposing a grid + shape inference (reference ``base_components.py:57``)."""

    def __init__(self, grid) -> None:
        self._grid = grid

    @property
    def grid(self):
        return self._grid

    def get_field_shape(self, field_name: str) -> Tuple[int, int, int]:
        """Storage shape of ``field_name`` honouring the staggering naming
        convention (reference ``get_field_grid_shape``, ``base_components.py:68-89``)."""
        g = self._grid
        return field_shape(field_name, (g.nx, g.ny, g.nz))


class DomainComponent(GridComponent):
    """Mixin binding a component to a domain + grid type
    (reference ``base_components.py:143``)."""

    allowed_grid_types = ("numerical", "physical")

    def __init__(self, domain, grid_type: str = "numerical") -> None:
        if grid_type not in self.allowed_grid_types:
            raise ValueError(
                f"grid_type must be one of {self.allowed_grid_types}, got {grid_type!r}"
            )
        self._domain = domain
        self._grid_type = grid_type
        grid = (
            domain.numerical_grid if grid_type == "numerical" else domain.physical_grid
        )
        super().__init__(grid)

    @property
    def domain(self):
        return self._domain

    @property
    def grid_type(self) -> str:
        return self._grid_type

    @property
    def horizontal_boundary(self):
        return self._domain.horizontal_boundary


class PhysicalConstantsComponent:
    """Mixin resolving physical constants with user overrides
    (reference ``base_components.py:42``)."""

    default_physical_constants: Dict[str, Any] = {}

    def __init__(self, physical_constants: Optional[Mapping[str, Any]] = None) -> None:
        self._rpc = get_physical_constants(
            self.default_physical_constants, physical_constants
        )

    @property
    def rpc(self) -> Dict[str, float]:
        """Resolved physical constants, values in the default units."""
        return self._rpc
