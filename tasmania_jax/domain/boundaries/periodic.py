"""Periodic lateral boundary conditions.

JAX re-design of reference
``src/tasmania/domain/subclasses/horizontal_boundaries/periodic.py:32,125``:
numerical grid extends the physical one by ``nb`` layers per side; wrap-around
copies use the reference's exact index arithmetic (period ``n-1`` for mass
points, shifted by one for staggered fields).  In the distributed build this
class is exactly what ``ppermute`` ring halo exchange reproduces shard-locally.
"""

from __future__ import annotations

import numpy as np

from tasmania_jax.domain.horizontal_boundary import (
    HorizontalBoundary,
    extend_axis,
    field_extent,
    paste,
    repeat_axis,
)
from tasmania_jax.framework.registry import factor_register
from tasmania_jax.utils.array import get_namespace


@factor_register("periodic")
class Periodic(HorizontalBoundary):
    def __init__(
        self, grid, nb, backend="jax", backend_options=None, storage_options=None, **kwargs
    ):
        nx, ny = grid.nx, grid.ny
        self._oneDX = ny == 1
        self._oneDY = nx == 1
        if not self._oneDY:
            assert nb <= nx / 2, "nb cannot exceed nx/2"
        if not self._oneDX:
            assert nb <= ny / 2, "nb cannot exceed ny/2"
        super().__init__(
            grid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )

    @property
    def ni(self):
        return self.nx + 2 * self.nb

    @property
    def nj(self):
        return self.ny + 2 * self.nb

    def get_numerical_xaxis(self, dims=None):
        if self._oneDY:
            return repeat_axis(self.physical_grid.x, self.nb, dims)
        return extend_axis(self.physical_grid.x, self.nb, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        if self._oneDY:
            return repeat_axis(self.physical_grid.x_at_u_locations, self.nb, dims)
        return extend_axis(self.physical_grid.x_at_u_locations, self.nb, dims)

    def get_numerical_yaxis(self, dims=None):
        if self._oneDX:
            return repeat_axis(self.physical_grid.y, self.nb, dims)
        return extend_axis(self.physical_grid.y, self.nb, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        if self._oneDX:
            return repeat_axis(self.physical_grid.y_at_v_locations, self.nb, dims)
        return extend_axis(self.physical_grid.y_at_v_locations, self.nb, dims)

    def get_numerical_field(self, field, field_name=None):
        nb = self.nb
        xp = get_namespace(field)
        pads = [(nb, nb), (nb, nb)] + [(0, 0)] * (field.ndim - 2)
        trg = xp.pad(field, pads, mode="constant")
        return self.enforce_field(trg, field_name)

    def get_physical_field(self, field, field_name=None):
        nb = self.nb
        return field[nb:-nb, nb:-nb]

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        nx, ny, nb = self.nx, self.ny, self.nb
        name = field_name or ""
        x_stag = "at_u_locations" in name or "at_uv_locations" in name
        y_stag = "at_v_locations" in name or "at_uv_locations" in name
        mx = nx + 1 if x_stag else nx
        my = ny + 1 if y_stag else ny
        mi = mx + 2 * nb

        f = field
        if not self._oneDY:
            # west ghosts <- east interior (period nx-1 mass / shifted staggered)
            f = paste(
                f,
                (slice(0, nb), slice(nb, my + nb)),
                f[nx - 1 : nx - 1 + nb, nb : my + nb],
            )
            src = (
                f[nb + 1 : 2 * nb + 1, nb : my + nb]
                if mx == nx
                else f[nb + 2 : 2 * nb + 2, nb : my + nb]
            )
            f = paste(f, (slice(mx + nb, mx + 2 * nb), slice(nb, my + nb)), src)
        else:
            f = paste(f, (slice(0, nb), slice(nb, my + nb)), f[nb : nb + 1, nb : my + nb])
            src = (
                f[nb : nb + 1, nb : my + nb] if mx == nx else f[nb + 1 : nb + 2, nb : my + nb]
            )
            f = paste(f, (slice(mx + nb, mx + 2 * nb), slice(nb, my + nb)), src)

        if not self._oneDX:
            f = paste(f, (slice(0, mi), slice(0, nb)), f[:mi, ny - 1 : ny - 1 + nb])
            src = (
                f[:mi, nb + 1 : 2 * nb + 1] if my == ny else f[:mi, nb + 2 : 2 * nb + 2]
            )
            f = paste(f, (slice(0, mi), slice(my + nb, my + 2 * nb)), src)
        else:
            f = paste(f, (slice(0, mi), slice(0, nb)), f[:mi, nb : nb + 1])
            src = f[:mi, nb : nb + 1] if my == ny else f[:mi, nb + 1 : nb + 2]
            f = paste(f, (slice(0, mi), slice(my + nb, my + 2 * nb)), src)
        return f

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        out = paste(field, (slice(0, 1),), field[-2:-1])
        out = paste(out, (slice(field.shape[0] - 1, field.shape[0]),), out[1:2])
        return out

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        out = paste(field, (slice(None), slice(0, 1)), field[:, -2:-1])
        out = paste(
            out, (slice(None), slice(field.shape[1] - 1, field.shape[1])), out[:, 1:2]
        )
        return out
