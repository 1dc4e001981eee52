"""Dirichlet lateral boundary conditions.

JAX re-design of reference
``src/tasmania/domain/subclasses/horizontal_boundaries/dirichlet.py:37``: edge
bands are pinned to values provided by a user ``core`` callable with signature
``core(time, grid, slice_x, slice_y, field_name, field_units)``.  The core runs
host-side when it returns numpy (outputs become trace-time constants under
jit); a core returning jax arrays computed from a *traced* ``time`` — thread
the step time through the state like ``topography_height`` — gives
time-dependent boundary forcing inside a jitted loop with no retrace.
"""

from __future__ import annotations

import inspect

import numpy as np

from tasmania_jax.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    field_extent,
    paste,
)
from tasmania_jax.framework.registry import factor_register
from tasmania_jax.utils.array import get_namespace


def placeholder(time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
    """Default core: zero boundary values (reference ``dirichlet.py`` placeholder)."""
    sx = slice_x or slice(0, None)
    sy = slice_y or slice(0, None)
    mi = len(np.asarray(grid.x.data)[sx]) if sx.stop is None else sx.stop - (sx.start or 0)
    mj = len(np.asarray(grid.y.data)[sy]) if sy.stop is None else sy.stop - (sy.start or 0)
    return np.zeros((mi, mj, 1))


@factor_register("dirichlet")
class Dirichlet(HorizontalBoundary):
    def __init__(
        self,
        grid,
        nb,
        backend="jax",
        backend_options=None,
        storage_options=None,
        core=placeholder,
        **kwargs,
    ):
        nx, ny = grid.nx, grid.ny
        self._oneDX = ny == 1
        self._oneDY = nx == 1
        if not self._oneDY:
            assert nb <= nx / 2, "nb cannot exceed nx/2"
        if not self._oneDX:
            assert nb <= ny / 2, "nb cannot exceed ny/2"
        sig = inspect.signature(core)
        params = tuple(sig.parameters.keys())
        assert params[0] == "time" and params[1] == "grid", (
            "core signature must be core(time, grid, slice_x=None, slice_y=None, "
            "field_name=None, field_units=None)"
        )
        super().__init__(
            grid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        self._kwargs["core"] = core

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

    def _band(self, field, time, sx, sy, name, units):
        """Evaluate the core over an index window, broadcast to the field's
        k-extent.

        A core returning numpy evaluates host-side (trace-time constant under
        jit).  A core returning a jax array — e.g. computed from a traced
        ``time`` threaded through the state — stays traced, so time-dependent
        boundary forcing works inside a jitted loop without retracing."""
        core = self._kwargs["core"]
        vals = core(time, self.numerical_grid, sx, sy, name, units)
        host = isinstance(vals, (np.ndarray, list, tuple, float, int))
        xp = get_namespace(field) if host else get_namespace(vals)
        vals = np.asarray(vals) if host else vals
        want_k = field.shape[2] if field.ndim == 3 else None
        if field.ndim == 3:
            if vals.ndim == 2:
                vals = vals[:, :, None]
            if vals.shape[2] == 1 and want_k != 1:
                vals = xp.broadcast_to(vals, (*vals.shape[:2], want_k))
        return xp.asarray(vals, dtype=field.dtype)

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        nb = self.nb
        mi, mj, mk = field_extent(field_name, self.ni, self.nj, self.nz)
        f = field
        if not self._oneDY:
            f = paste(
                f,
                (slice(0, nb), slice(0, mj)),
                self._band(f, time, slice(0, nb), slice(0, mj), field_name, field_units),
            )
            f = paste(
                f,
                (slice(mi - nb, mi), slice(0, mj)),
                self._band(
                    f, time, slice(mi - nb, mi), slice(0, mj), field_name, field_units
                ),
            )
        if not self._oneDX:
            f = paste(
                f,
                (slice(nb, mi - nb), slice(0, nb)),
                self._band(
                    f, time, slice(nb, mi - nb), slice(0, nb), field_name, field_units
                ),
            )
            f = paste(
                f,
                (slice(nb, mi - nb), slice(mj - nb, mj)),
                self._band(
                    f, time, slice(nb, mi - nb), slice(mj - nb, mj), field_name, field_units
                ),
            )
        return f

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        f = paste(
            field,
            (slice(0, 1), slice(0, mj)),
            self._band(field, time, slice(0, 1), slice(0, mj), field_name, field_units),
        )
        f = paste(
            f,
            (slice(mi - 1, mi), slice(0, mj)),
            self._band(f, time, slice(mi - 1, mi), slice(0, mj), field_name, field_units),
        )
        return f

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        f = paste(
            field,
            (slice(0, mi), slice(0, 1)),
            self._band(field, time, slice(0, mi), slice(0, 1), field_name, field_units),
        )
        f = paste(
            f,
            (slice(0, mi), slice(mj - 1, mj)),
            self._band(f, time, slice(0, mi), slice(mj - 1, mj), field_name, field_units),
        )
        return f
