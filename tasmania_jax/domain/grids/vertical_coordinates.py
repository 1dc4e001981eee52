"""Terrain-following vertical-coordinate grids with metric terms.

JAX re-design of reference
``src/tasmania/domain/subclasses/grids/{sigma,sleve,gal_chen}.py:44-48``:

* ``Sigma3d``   — pressure-based σ = p/p_SL hybrid coordinate; geometric
  height / reference pressure from a logarithmic reference profile;
* ``GalChen3d`` — height-based Gal-Chen & Somerville coordinate with linear
  terrain decay below z_F;
* ``SLEVE3d``   — height-based SLEVE (Schär et al. 2002): smooth/residual
  terrain split with separate sinh decay scales.

Metric terms are host numpy (they feed precomputed coefficient arrays);
``update_topography`` recomputes them, mirroring the reference.
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Optional

import numpy as np

from tasmania_jax.domain.grid import Grid, PhysicalGrid
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.utils.constants import get_physical_constants

_D_CONSTANTS = {
    "air_pressure_at_sea_level": (1e5, "Pa"),
    "air_temperature_at_sea_level": (288.15, "K"),
    "beta": (42.0, "K Pa^-1"),
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
}


def _ref_pressure_from_height(z_hl, pcs):
    """Reference pressure at geometric height from the log profile
    (reference ``sleve.py:295-300``)."""
    p_sl = pcs["air_pressure_at_sea_level"]
    T_sl = pcs["air_temperature_at_sea_level"]
    beta = pcs["beta"]
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    if beta == 0.0:
        return p_sl * np.exp(-g * z_hl / (Rd * T_sl))
    return p_sl * np.exp(
        -T_sl / beta * (1.0 - np.sqrt(1.0 - 2.0 * beta * g * z_hl / (Rd * T_sl**2)))
    )


class _MetricGrid(PhysicalGrid):
    """Shared scaffolding: constants + metric-term refresh on topo updates."""

    def __init__(self, *args, physical_constants=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._physical_constants = get_physical_constants(
            _D_CONSTANTS, physical_constants
        )
        self.height = None
        self.height_on_interface_levels = None
        self.reference_pressure = None
        self.reference_pressure_on_interface_levels = None
        self._update_metric_terms()

    @property
    def topography_height(self) -> np.ndarray:
        return np.asarray(self.topography.profile.to_units("m").data)

    def update_topography(self, time: timedelta) -> None:
        super().update_topography(time)
        self._update_metric_terms()

    def _wrap(self, z_hl: np.ndarray) -> None:
        dims3 = ("x", "y", "z")
        dims3_hl = ("x", "y", "z_on_interface_levels")
        pcs = self._physical_constants
        p0_hl = _ref_pressure_from_height(z_hl, pcs)
        self.height_on_interface_levels = FieldArray(z_hl, "m", dims3_hl)
        self.height = FieldArray(0.5 * (z_hl[:, :, :-1] + z_hl[:, :, 1:]), "m", dims3)
        self.reference_pressure_on_interface_levels = FieldArray(
            p0_hl, "Pa", dims3_hl
        )
        self.reference_pressure = FieldArray(
            0.5 * (p0_hl[:, :, :-1] + p0_hl[:, :, 1:]), "Pa", dims3
        )

    def _update_metric_terms(self) -> None:
        raise NotImplementedError


class Sigma3d(_MetricGrid):
    """σ = p/p_SL pressure-based coordinate (reference ``sigma.py:44``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # σ must be positive, 1 at the surface, decreasing with height
        zv = np.asarray(self.z_on_interface_levels.data)
        assert zv[0] < zv[-1] and zv[0] >= 0.0 and abs(zv[-1] - 1.0) < 1e-12, (
            "sigma coordinate must increase from top to 1 at the surface"
        )

    def _update_metric_terms(self) -> None:
        """reference ``sigma.py:229-319``: hybrid σ → reference pressure at
        interfaces, then geometric height from the log profile."""
        pcs = self._physical_constants
        p_sl = pcs["air_pressure_at_sea_level"]
        T_sl = pcs["air_temperature_at_sea_level"]
        beta = pcs["beta"]
        Rd = pcs["gas_constant_of_dry_air"]
        g = pcs["gravitational_acceleration"]

        hs = np.repeat(self.topography_height[:, :, None], self.nz + 1, axis=2)
        zv = np.asarray(self.z_on_interface_levels.data)[None, None, :]
        zf = float(np.asarray(self.z_interface.data))
        zt = zv[0, 0, 0]

        # reference pressure at the terrain surface
        if beta == 0.0:
            p0_s = p_sl * np.exp(-g * hs / (Rd * T_sl))
        else:
            p0_s = p_sl * np.exp(
                -T_sl / beta * (1.0 - np.sqrt(1.0 - 2.0 * beta * g * hs / (Rd * T_sl**2)))
            )

        # hybrid blend: flat above z_F, terrain-following below
        flat = (zt <= zv) & (zv <= zf)
        tf = (zf < zv) & (zv <= 1.0)
        a = p_sl * zv * flat + p_sl * zf * (1.0 - zv) / (1.0 - zf) * tf
        a = np.broadcast_to(a, (self.nx, self.ny, self.nz + 1)).copy()
        b = np.broadcast_to((zv - zf) / (1.0 - zf) * tf, a.shape)
        p0_hl = a + b * p0_s

        dims3 = ("x", "y", "z")
        dims3_hl = ("x", "y", "z_on_interface_levels")
        if beta == 0.0:
            z_hl = Rd * T_sl / g * np.log(p_sl / p0_hl)
        else:
            z_hl = Rd / g * np.log(p_sl / p0_hl) * (T_sl - 0.5 * beta * np.log(p_sl / p0_hl))
        self.reference_pressure_on_interface_levels = FieldArray(p0_hl, "Pa", dims3_hl)
        self.reference_pressure = FieldArray(
            0.5 * (p0_hl[:, :, :-1] + p0_hl[:, :, 1:]), "Pa", dims3
        )
        self.height_on_interface_levels = FieldArray(z_hl, "m", dims3_hl)
        self.height = FieldArray(0.5 * (z_hl[:, :, :-1] + z_hl[:, :, 1:]), "m", dims3)


class GalChen3d(_MetricGrid):
    """Gal-Chen & Somerville height-based coordinate with linear terrain
    decay (reference ``gal_chen.py``)."""

    def _update_metric_terms(self) -> None:
        hs = np.repeat(self.topography_height[:, :, None], self.nz + 1, axis=2)
        zv = np.asarray(self.z_on_interface_levels.data)[None, None, :]
        zf = float(np.asarray(self.z_interface.data))
        a = np.broadcast_to(zv, (self.nx, self.ny, self.nz + 1))
        b = np.broadcast_to((zf - zv) / zf * ((0.0 <= zv) & (zv < zf)), a.shape)
        z_hl = a + b * hs
        self._wrap(np.asarray(z_hl))


class SLEVE3d(_MetricGrid):
    """SLEVE coordinate: smooth + residual terrain with separate sinh decay
    scales (reference ``sleve.py:48``)."""

    def __init__(self, *args, niter: int = 10, s1: float = 8e3, s2: float = 5e3, **kwargs):
        self._niter = niter
        self._s1 = s1
        self._s2 = s2
        super().__init__(*args, **kwargs)

    def _update_metric_terms(self) -> None:
        hs = np.repeat(self.topography_height[:, :, None], self.nz + 1, axis=2)
        zv = np.asarray(self.z_on_interface_levels.data)[None, None, :]
        zf = float(np.asarray(self.z_interface.data))
        s1, s2 = self._s1, self._s2

        # 9-point low-pass filter iterated niter times (reference ``sleve.py:250-268``)
        h1 = hs.copy()
        for _ in range(self._niter):
            if h1.shape[0] > 2 and h1.shape[1] > 2:
                h1[1:-1, 1:-1] = (
                    h1[:-2, :-2] + h1[1:-1, :-2] + h1[2:, :-2]
                    + h1[:-2, 1:-1] + h1[1:-1, 1:-1] + h1[2:, 1:-1]
                    + h1[:-2, 2:] + h1[1:-1, 2:] + h1[2:, 2:]
                ) / 9.0
        h2 = hs - h1

        below = zv < zf
        b1 = np.sinh((zf - zv) / s1) / math.sinh(zf / s1) * below
        b2 = np.sinh((zf - zv) / s2) / math.sinh(zf / s2) * below
        a = np.broadcast_to(zv, (self.nx, self.ny, self.nz + 1))
        z_hl = a + np.broadcast_to(b1, a.shape) * h1 + np.broadcast_to(b2, a.shape) * h2
        self._wrap(np.asarray(z_hl))
