"""Vertical (Rayleigh) damping dwarf: wave absorber toward a reference state.

JAX re-design of reference ``src/tasmania/dwarfs/vertical_damping.py:46``
and ``dwarfs/subclasses/vertical_dampers/rayleigh.py:31``:
``phi_out = phi_new − dt·rmat·(phi_now − phi_ref)`` with the cosine-profile
damping matrix of Durran & Klemp filled over the top ``damp_depth`` levels
(reference ``vertical_damping.py:100-111``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from tasmania_jax.framework.field import ensure_timedelta_seconds
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


class VerticalDamping(StencilFactory):
    """Factory base (reference ``vertical_damping.py:46``)."""

    registry = {}

    def __init__(
        self,
        grid,
        damp_depth: int = 15,
        damp_coeff_max: float = 0.0002,
        time_units: str = "s",
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(backend, backend_options, storage_options)
        self._grid = grid
        damp_depth = min(damp_depth, grid.nz)  # shallow test grids
        self._damp_depth = damp_depth
        self._tunits = time_units

        # damping matrix (1, 1, nz[+1]) — cosine ramp over the top damp_depth
        # levels (reference ``vertical_damping.py:100-111``)
        nz = grid.nz
        self._rmat = {}
        for on_interfaces in (False, True):
            z = np.asarray(grid.z.data, dtype=float)
            if on_interfaces:
                z = np.concatenate((z, np.array([0.0])), axis=0)
            r = np.zeros_like(z)
            if damp_depth > 0:
                zt = float(np.asarray(grid.z_on_interface_levels.data)[0])
                za = z[damp_depth - 1]
                r = (
                    (z >= za)
                    * damp_coeff_max
                    * (1.0 - np.cos(math.pi * (z - za) / (zt - za)))
                )
            self._rmat[on_interfaces] = r[np.newaxis, np.newaxis, :].astype(
                self.storage_options.dtype
            )

    @property
    def damp_depth(self) -> int:
        return self._damp_depth

    def __call__(self, dt, field_now, field_new, field_ref):
        raise NotImplementedError

    @staticmethod
    def factory(name: str, grid, *args, **kwargs) -> "VerticalDamping":
        return factorize(name, VerticalDamping, (grid, *args), kwargs)


@factor_register("rayleigh")
class Rayleigh(VerticalDamping):
    """phi_out = phi_new − dt·r·(phi_now − phi_ref)
    (reference ``rayleigh.py:88-126``)."""

    def __call__(self, dt, field_now, field_new, field_ref):
        xp = get_namespace(field_new)
        dt_s = ensure_timedelta_seconds(dt)
        from tasmania_jax.utils.units import conversion_factor

        dt_raw = dt_s * conversion_factor("s", self._tunits)
        on_interfaces = field_new.shape[2] == self._grid.nz + 1
        r = xp.asarray(self._rmat[on_interfaces], dtype=field_new.dtype)
        r = r[:, :, : field_new.shape[2]]
        return field_new - dt_raw * r * (field_now - field_ref)
