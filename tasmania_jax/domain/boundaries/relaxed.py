"""Relaxed (Lehmann/Davies) lateral boundary conditions.

JAX re-design of reference
``src/tasmania/domain/subclasses/horizontal_boundaries/relaxed.py:34,250,463``:
same tanh relaxation-coefficient ramp over ``nr ≤ 8`` layers, same corner
blending, but the coefficient matrix is a host-precomputed constant closed over
by a *functional* enforce (a three-way ``where`` XLA fuses into one elementwise pass).
``ny==1`` / ``nx==1`` physical grids are handled in-class (the reference uses
separate ``Relaxed1DX/1DY`` subclasses picked by a dispatch function,
``relaxed.py:680``).
"""

from __future__ import annotations

import numpy as np

from tasmania_jax.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    field_extent,
    paste,
    repeat_axis,
)
from tasmania_jax.framework.registry import factor_register
from tasmania_jax.utils.array import get_namespace


def _relaxation_ramp(nr: int, nb: int) -> np.ndarray:
    rel = np.array([1.0 - np.tanh(0.5 * i) for i in range(8)])
    rel = rel[:nr].copy()
    rel[:nb] = 1.0
    return rel


@factor_register("relaxed")
class Relaxed(HorizontalBoundary):
    """Relaxation toward the reference state over ``nr`` boundary layers."""

    def __init__(
        self,
        grid,
        nb,
        backend="jax",
        backend_options=None,
        storage_options=None,
        nr: int = 8,
        **kwargs,
    ):
        nx, ny = grid.nx, grid.ny
        self._oneDX = ny == 1
        self._oneDY = nx == 1
        if not (self._oneDX or self._oneDY):
            assert nr <= nx / 2 and nr <= ny / 2, "nr cannot exceed nx/2, ny/2"
        elif self._oneDX:
            assert nr <= nx / 2, "nr cannot exceed nx/2"
        else:
            assert nr <= ny / 2, "nr cannot exceed ny/2"
        assert nr <= 8, "nr cannot exceed 8"
        assert nb <= nr, "nb cannot exceed nr"

        super().__init__(
            grid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        self._kwargs["nr"] = nr
        self._gamma = self._build_gamma()

    # -- geometry ------------------------------------------------------------ #
    @property
    def ni(self):
        return 2 * self.nb + 1 if self._oneDY else self.nx

    @property
    def nj(self):
        return 2 * self.nb + 1 if self._oneDX else self.ny

    def get_numerical_xaxis(self, dims=None):
        if self._oneDY:
            return repeat_axis(self.physical_grid.x, self.nb, dims)
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        if self._oneDY:
            return repeat_axis(self.physical_grid.x_at_u_locations, self.nb, dims)
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        if self._oneDX:
            return repeat_axis(self.physical_grid.y, self.nb, dims)
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        if self._oneDX:
            return repeat_axis(self.physical_grid.y_at_v_locations, self.nb, dims)
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    # -- numerical <-> physical ------------------------------------------------ #
    def get_numerical_field(self, field, field_name=None):
        nb = self.nb
        if self._oneDX:
            xp = get_namespace(field)
            pads = [(0, 0)] * field.ndim
            pads[1] = (nb, nb)
            return xp.pad(field, pads, mode="edge")
        if self._oneDY:
            xp = get_namespace(field)
            pads = [(0, 0)] * field.ndim
            pads[0] = (nb, nb)
            return xp.pad(field, pads, mode="edge")
        return field

    def get_physical_field(self, field, field_name=None):
        nb = self.nb
        if self._oneDX:
            return field[:, nb:-nb]
        if self._oneDY:
            return field[nb:-nb, :]
        return field

    # -- enforcement ----------------------------------------------------------- #
    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        mi, mj, mk = field_extent(field_name, self.ni, self.nj, self.nz)
        xp = get_namespace(field)
        g = xp.asarray(self._gamma[:mi, :mj], dtype=field.dtype)
        while g.ndim < field.ndim:
            g = g[..., None]
        ref = xp.asarray(self._ref_field(field_name, field_units))
        ref = ref[tuple(slice(0, m) for m in field.shape)]
        # three-way select matches the reference's exact-pinning semantics
        out = xp.where(
            g == 0.0,
            field,
            xp.where(g == 1.0, ref, field - g * (field - ref)),
        )
        if self._oneDX:
            nb = self.nb
            out = paste(out, (slice(0, mi), slice(0, nb)), out[:mi, nb : nb + 1])
            out = paste(
                out, (slice(0, mi), slice(mj - nb, mj)), out[:mi, mj - nb - 1 : mj - nb]
            )
        if self._oneDY:
            nb = self.nb
            out = paste(out, (slice(0, nb), slice(0, mj)), out[nb : nb + 1, :mj])
            out = paste(
                out, (slice(mi - nb, mi), slice(0, mj)), out[mi - nb - 1 : mi - nb, :mj]
            )
        return out

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        ref = get_namespace(field).asarray(self._ref_field(field_name, field_units))
        out = paste(field, (slice(0, 1), slice(0, mj)), ref[0:1, :mj])
        out = paste(out, (slice(mi - 1, mi), slice(0, mj)), ref[mi - 1 : mi, :mj])
        return out

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        ref = get_namespace(field).asarray(self._ref_field(field_name, field_units))
        out = paste(field, (slice(0, mi), slice(0, 1)), ref[:mi, 0:1])
        out = paste(out, (slice(0, mi), slice(mj - 1, mj)), ref[:mi, mj - 1 : mj])
        return out

    # -- coefficient matrix ------------------------------------------------------ #
    def _build_gamma(self) -> np.ndarray:
        """(nx'+1, ny'+1) relaxation coefficients over the numerical grid,
        sliced per-field in ``enforce_field`` (reference ``relaxed.py:193-248``)."""
        nb, nr = self.nb, self._kwargs["nr"]
        rel = _relaxation_ramp(nr, nb)
        rrel = rel[::-1]

        if self._oneDX:
            nx, nj = self.nx, self.nj
            g = np.zeros((nx + 1, nj + 1))
            g[:nr, nb : nb + 2] = rel[:, None]
            g[nx - nr : nx, nb : nb + 2] = rrel[:, None]
            g[nx, nb : nb + 2] = 1.0
            return g
        if self._oneDY:
            ny, ni = self.ny, self.ni
            g = np.zeros((ni + 1, ny + 1))
            g[nb : nb + 2, :nr] = rel[None, :]
            g[nb : nb + 2, ny - nr : ny] = rrel[None, :]
            g[nb : nb + 2, ny] = 1.0
            return g

        nx, ny = self.nx, self.ny
        g = np.zeros((nx + 1, ny + 1))
        # corner block: gamma[i, j] = rel[min(i, j)]
        xnegyneg = np.zeros((nr, nr))
        for i in range(nr):
            xnegyneg[i, i:] = rel[i]
            xnegyneg[i:, i] = rel[i]
        xposyneg = xnegyneg[::-1, :]
        xposypos = xposyneg[:, ::-1]
        xnegypos = xnegyneg[:, ::-1]
        # edges
        g[:nr, :nr] = xnegyneg
        g[:nr, nr : ny - nr] = rel[:, None]
        g[:nr, ny - nr : ny] = xnegypos
        g[nx - nr : nx, :nr] = xposyneg
        g[nx - nr : nx, nr : ny - nr] = rrel[:, None]
        g[nx - nr : nx, ny - nr : ny] = xposypos
        g[nr : nx - nr, :nr] = rel[None, :]
        g[nr : nx - nr, ny - nr : ny] = rrel[None, :]
        # staggered outermost row/column pinned to the reference state
        g[nx, : ny + 1] = 1.0
        g[: nx + 1, ny] = 1.0
        return g
