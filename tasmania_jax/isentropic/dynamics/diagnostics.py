"""Diagnostic steps of the isentropic dynamical core: vertical scans.

JAX re-design of reference ``src/tasmania/isentropic/dynamics/diagnostics.py:49``
(numpy k-loops ``:320-361``, gt4py FORWARD/BACKWARD computation blocks
``:363-406``).  Every scan in this model is a pure *cumulative sum* along
k —

* hydrostatic pressure  p[k] = pt + g·dz·Σ_{l<k} s[l]                (FORWARD)
* Montgomery potential  mtg[k] = mtg_s + ½dz·exn[nz] + dz·Σ_{l>k} exn[l] (BACKWARD)
* height of isentropes  h[k] = hs + Σ_{l≥k} t[l] with elementwise t   (BACKWARD)

so they lower to ``jnp.cumsum`` (log-depth, fully vectorised over (x, y))
instead of sequential ``lax.scan`` — no per-level dependency chain survives on
the device.  On an H100 this form also beats the same scans written as
triangular-matrix contractions at the flagship size (PERF.md).  Exact
recurrences match the reference for allclose validation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tasmania_jax.framework.base_components import GridComponent
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


class IsentropicDiagnostics(GridComponent, StencilFactory):
    """Pressure / Exner / Montgomery / height / density / temperature
    from the isentropic density."""

    default_physical_constants = {
        "air_pressure_at_sea_level": (1e5, "Pa"),
        "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
        "gravitational_acceleration": (9.80665, "m s^-2"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def __init__(
        self,
        grid,
        physical_constants=None,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        GridComponent.__init__(self, grid)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        from tasmania_jax.utils.constants import get_physical_constants

        self.rpc = get_physical_constants(
            self.default_physical_constants, physical_constants
        )
        # θ on interface levels, shaped for broadcasting over (x, y, k)
        theta = np.asarray(grid.z_on_interface_levels.to_units("K").data)
        self._theta = theta[np.newaxis, np.newaxis, :]  # (1, 1, nz+1)
        self._dz = float(np.asarray(grid.dz.to_units("K").data))

    # -- helpers ------------------------------------------------------------- #
    def _hs(self, xp, dtype, hs=None):
        """Current topography height (1 broadcast plane).

        ``hs`` (nx, ny) overrides the grid's host-side profile — the hook that
        lets a jitted step take the growing topography as an *input* instead of
        a trace-time constant (SURVEY.md §7 hard part)."""
        if hs is not None:
            arr = hs if hs.ndim == 3 else hs[:, :, None]
            return xp.asarray(arr, dtype=dtype)
        hs_np = np.asarray(self.grid.topography.profile.to_units("m").data)
        return xp.asarray(hs_np[:, :, np.newaxis], dtype=dtype)

    def _pressure(self, s, pt: float):
        """p on interface levels via forward cumsum (reference ``:339-342``)."""
        xp = get_namespace(s)
        g = self.rpc["gravitational_acceleration"]
        dz = self._dz
        increments = g * dz * s  # contribution of level k to p[k+1]
        csum = xp.cumsum(increments, axis=2)
        p = xp.concatenate([xp.zeros_like(s[:, :, :1]), csum], axis=2) + s.dtype.type(pt)
        return p

    def _exner(self, p):
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        rd = self.rpc["gas_constant_of_dry_air"]
        pref = self.rpc["air_pressure_at_sea_level"]
        return cp * (p / pref) ** (rd / cp)

    def _montgomery(self, exn, hs, theta_s: float):
        """mtg on main levels via backward cumsum (reference ``:346-349``)."""
        xp = get_namespace(exn)
        g = self.rpc["gravitational_acceleration"]
        dz = self._dz
        nz = exn.shape[2] - 1
        mtg_s = theta_s * exn[:, :, nz : nz + 1] + g * hs
        # mtg[nz-1] = mtg_s + 0.5 dz exn[nz]; mtg[k] = mtg[k+1] + dz exn[k+1]
        base = mtg_s + 0.5 * dz * exn[:, :, nz : nz + 1]
        # backward cumsum of dz*exn[k+1] for k = nz-2 .. 0
        inc = dz * exn[:, :, 1:nz]  # exn[k+1] for k in 0..nz-2
        rcsum = xp.cumsum(inc[:, :, ::-1], axis=2)[:, :, ::-1]
        mtg = xp.concatenate([base + rcsum, base], axis=2)
        return mtg

    def _height(self, p, exn, hs):
        """h on interface levels via backward cumsum (reference ``:353-361``)."""
        xp = get_namespace(p)
        g = self.rpc["gravitational_acceleration"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        rd = self.rpc["gas_constant_of_dry_air"]
        theta = xp.asarray(self._theta, dtype=p.dtype)
        # increment from level k+1 to k (k = 0..nz-1)
        dh = (
            rd
            * (theta[:, :, :-1] * exn[:, :, :-1] + theta[:, :, 1:] * exn[:, :, 1:])
            * (p[:, :, :-1] - p[:, :, 1:])
            / (cp * g * (p[:, :, :-1] + p[:, :, 1:]))
        )
        rcsum = xp.cumsum(dh[:, :, ::-1], axis=2)[:, :, ::-1]
        h = xp.concatenate([hs - rcsum, hs], axis=2)
        return h

    # -- public API (functional; reference returns via out-buffers) ----------- #
    def get_diagnostic_variables(self, s, pt: float, hs=None, moist: bool = False):
        """(p, exn, mtg, h[, rho, t]) from s + top pressure (reference ``:140``)."""
        xp = get_namespace(s)
        hs = self._hs(xp, s.dtype, hs)
        p = self._pressure(s, pt)
        exn = self._exner(p)
        theta_s = float(self._theta[0, 0, -1])
        mtg = self._montgomery(exn, hs, theta_s)
        h = self._height(p, exn, hs)
        if moist:
            rho, t = self.get_density_and_temperature(s, exn, h)
            return p, exn, mtg, h, rho, t
        return p, exn, mtg, h

    def get_montgomery_potential(self, s, pt: float, hs=None):
        """(reference ``:196``)"""
        xp = get_namespace(s)
        hs = self._hs(xp, s.dtype, hs)
        p = self._pressure(s, pt)
        exn = self._exner(p)
        theta_s = float(self._theta[0, 0, -1])
        return self._montgomery(exn, hs, theta_s)

    def get_height(self, s, pt: float, hs=None):
        """(reference ``:240``)"""
        xp = get_namespace(s)
        hs = self._hs(xp, s.dtype, hs)
        p = self._pressure(s, pt)
        exn = self._exner(p)
        return self._height(p, exn, hs)

    def get_density_and_temperature(self, s, exn, h) -> Tuple:
        """(rho, t) (reference ``:278``)"""
        xp = get_namespace(s)
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        theta = xp.asarray(self._theta, dtype=s.dtype)
        rho = (
            s
            * (theta[:, :, :-1] - theta[:, :, 1:])
            / (h[:, :, :-1] - h[:, :, 1:])
        )
        t = (
            0.5
            / cp
            * (theta[:, :, :-1] * exn[:, :, :-1] + theta[:, :, 1:] * exn[:, :, 1:])
        )
        return rho, t
