"""Velocity/momenta and water-constituent diagnostics dwarfs.

JAX re-design of reference ``src/tasmania/dwarfs/diagnostics.py:44,290``:
staggered averaging momenta⇄velocities and density⇄mass-fraction conversion
with optional positivity clipping.  Functional: outputs are returned, not
written into buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tasmania_jax.framework.base_components import GridComponent
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


class HorizontalVelocity(GridComponent, StencilFactory):
    """Diagnose momenta from velocities and vice versa on a C-staggered grid
    (reference ``diagnostics.py:44``)."""

    def __init__(
        self,
        grid,
        staggering: bool = True,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        GridComponent.__init__(self, grid)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self._staggering = staggering

    def get_momenta(self, d, u, v) -> Tuple:
        """(du, dv) = (d·ū, d·v̄) with staggered averaging
        (reference ``diagnostics.py:90``, stencil ``:193-196``)."""
        if self._staggering:
            du = 0.5 * d * (u[:-1] + u[1:])
            dv = 0.5 * d * (v[:, :-1] + v[:, 1:])
        else:
            du = d * u
            dv = d * v
        return du, dv

    def get_velocity_components(self, d, du, dv) -> Tuple:
        """(u, v) from momenta; with staggering the outermost layers of the
        staggered output are NOT set (reference note ``diagnostics.py:101-104``) —
        here they are zero-filled and callers apply
        ``set_outermost_layers_x/y``."""
        xp = get_namespace(d)
        if self._staggering:
            u_in = (du[:-1] + du[1:]) / (d[:-1] + d[1:])
            v_in = (dv[:, :-1] + dv[:, 1:]) / (d[:, :-1] + d[:, 1:])
            # build the staggered arrays by concatenation, NOT by scatter into
            # zeros: concatenate partitions robustly under SPMD (XLA's scatter
            # partitioner can silently drop the cross-shard row)
            zu = xp.zeros_like(u_in[:1])
            zv = xp.zeros_like(v_in[:, :1])
            u = xp.concatenate([zu, u_in, zu], axis=0)
            v = xp.concatenate([zv, v_in, zv], axis=1)
            return u, v
        return du / d, dv / d


class WaterConstituent(GridComponent, StencilFactory):
    """sq = s·q and q = sq/s with optional clipping ≥ 0
    (reference ``diagnostics.py:290,337,367``)."""

    def __init__(
        self,
        grid,
        clipping: bool = False,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        GridComponent.__init__(self, grid)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self._clipping = clipping

    def _clip(self, x):
        if not self._clipping:
            return x
        xp = get_namespace(x)
        return xp.where(x > 0.0, x, xp.zeros_like(x))

    def get_density_of_water_constituent(self, d, q):
        return self._clip(d * q)

    def get_mass_fraction_of_water_constituent_in_air(self, d, dq):
        return self._clip(dq / d)
