"""Identity (no-op) lateral boundary: numerical grid == physical grid.

JAX analogue of reference
``src/tasmania/domain/subclasses/horizontal_boundaries/identity.py:32``.
"""

from __future__ import annotations

from tasmania_jax.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    repeat_axis,
)
from tasmania_jax.framework.registry import factor_register


@factor_register("identity")
class Identity(HorizontalBoundary):
    def __init__(
        self, grid, nb, backend="jax", backend_options=None, storage_options=None, **kwargs
    ):
        super().__init__(
            grid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )

    @property
    def ni(self):
        return self.nx

    @property
    def nj(self):
        return self.ny

    def get_numerical_xaxis(self, dims=None):
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    def get_numerical_field(self, field, field_name=None):
        return field

    def get_physical_field(self, field, field_name=None):
        return field

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        return field

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        return field

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        return field
