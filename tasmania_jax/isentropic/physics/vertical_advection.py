"""Explicit vertical (flux-form) advection for the isentropic model.

JAX re-design of reference
``src/tasmania/isentropic/physics/vertical_advection.py:71`` (+ the
``PrescribedSurfaceHeating`` component ``:478``): the vertical velocity is
w = dθ/dt (on main or interface levels); tendencies are the vertical flux
divergence, zero outside the ``extent``-deep top/bottom frame.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from tasmania_jax.framework.core_components import TendencyComponent
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic.dynamics.vertical_fluxes import (
    IsentropicMinimalVerticalFlux,
)
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


def interface_w(w_main, xp):
    """Interpolate main-level w to interfaces; outermost interfaces zero
    (reference ``vertical_advection.py:306-317``)."""
    nz = w_main.shape[2]
    w_if = xp.zeros((*w_main.shape[:2], nz + 1), dtype=w_main.dtype)
    interior = 0.5 * (w_main[:, :, 1:] + w_main[:, :, :-1])
    if xp is np:
        w_if[:, :, 1:nz] = interior
        return w_if
    return w_if.at[:, :, 1:nz].set(interior)


class IsentropicVerticalAdvection(TendencyComponent):
    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        flux_scheme: str = "upwind",
        moist: bool = False,
        tendency_of_air_potential_temperature_on_interface_levels: bool = False,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self._moist = moist
        self._stgz = tendency_of_air_potential_temperature_on_interface_levels
        self._vflux = IsentropicMinimalVerticalFlux.factory(
            flux_scheme, backend=self.backend
        )

    @property
    def input_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }
        if self._stgz:
            props["tendency_of_air_potential_temperature_on_interface_levels"] = {
                "dims": DIMS_Z,
                "units": "K s^-1",
            }
        else:
            props["tendency_of_air_potential_temperature"] = {
                "dims": DIMS,
                "units": "K s^-1",
            }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def tendency_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1 s^-1"}
        return props

    def array_call(self, state):
        xp = get_namespace(state["air_isentropic_density"])
        dz = float(np.asarray(self.grid.dz.to_units("K").data))
        nbz = self._vflux.extent
        s = state["air_isentropic_density"]
        nz = s.shape[2]

        if self._stgz:
            w = state["tendency_of_air_potential_temperature_on_interface_levels"]
        else:
            w = interface_w(state["tendency_of_air_potential_temperature"], xp)

        def tendency(phi, scale=None):
            f = self._vflux(0.0, dz, w, phi)  # interfaces [nbz, nz+1-nbz)
            div = (f[:, :, 1:] - f[:, :, :-1]) / dz  # levels [nbz, nz-nbz)
            if scale is not None:
                div = div / scale[:, :, nbz : nz - nbz]
            out = xp.zeros_like(phi)
            if xp is np:
                out[:, :, nbz : nz - nbz] = div
                return out
            return out.at[:, :, nbz : nz - nbz].set(div)

        tends: Dict[str, object] = {
            "air_isentropic_density": tendency(s),
            "x_momentum_isentropic": tendency(state["x_momentum_isentropic"]),
            "y_momentum_isentropic": tendency(state["y_momentum_isentropic"]),
        }
        if self._moist:
            tends[mfwv] = tendency(s * state[mfwv], scale=s)
            tends[mfcw] = tendency(s * state[mfcw], scale=s)
            tends[mfpw] = tendency(s * state[mfpw], scale=s)
        return tends, {}


class PrescribedSurfaceHeating(TendencyComponent):
    """Analytically prescribed heating from the surface
    (reference ``vertical_advection.py:478``): within ``starting_time`` and
    daylight hours, F = θ/(ρ cp) · ∂/∂z [F0 exp(−(z−hs)/attenuation)] with
    amplitudes differing day/night and an optional smooth horizontal cutoff."""

    default_physical_constants = {
        "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def __init__(
        self,
        domain,
        tendency_of_air_potential_temperature_in_diagnostics: bool = False,
        tendency_of_air_potential_temperature_on_interface_levels: bool = False,
        air_pressure_on_interface_levels: bool = True,
        amplitude_at_day_sw=None,
        amplitude_at_day_fw=None,
        amplitude_at_night_sw=None,
        amplitude_at_night_fw=None,
        frequency_sw=None,
        frequency_fw=None,
        attenuation_coefficient_at_day=None,
        attenuation_coefficient_at_night=None,
        characteristic_length=None,
        starting_time=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self._in_diags = tendency_of_air_potential_temperature_in_diagnostics
        self._stgz = tendency_of_air_potential_temperature_on_interface_levels
        self._p_stg = air_pressure_on_interface_levels

        def val(x, units, default):
            if isinstance(x, FieldArray):
                return float(np.asarray(x.to_units(units).data))
            return float(x) if x is not None else default

        self._f0d_sw = val(amplitude_at_day_sw, "W m^-2", 800.0)
        self._f0d_fw = val(amplitude_at_day_fw, "W m^-2", 400.0)
        self._f0n_sw = val(amplitude_at_night_sw, "W m^-2", -75.0)
        self._f0n_fw = val(amplitude_at_night_fw, "W m^-2", -37.5)
        self._w_sw = val(frequency_sw, "hr^-1", np.pi / 12.0)
        self._w_fw = val(frequency_fw, "hr^-1", np.pi / 6.0)
        self._ad = val(attenuation_coefficient_at_day, "m^-1", 1.0 / 600.0)
        self._an = val(attenuation_coefficient_at_night, "m^-1", 1.0 / 75.0)
        self._cl = val(characteristic_length, "m", 25000.0)
        self._t0 = starting_time

    @property
    def input_properties(self):
        props = {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
        }
        if self._p_stg:
            props["air_pressure_on_interface_levels"] = {"dims": DIMS_Z, "units": "Pa"}
        else:
            props["air_pressure"] = {"dims": DIMS, "units": "Pa"}
        return props

    @property
    def tendency_properties(self):
        if self._in_diags:
            return {}
        name = (
            "air_potential_temperature_on_interface_levels"
            if self._stgz
            else "air_potential_temperature"
        )
        dims = DIMS_Z if self._stgz else DIMS
        return {name: {"dims": dims, "units": "K s^-1"}}

    @property
    def diagnostic_properties(self):
        if not self._in_diags:
            return {}
        name = (
            "tendency_of_air_potential_temperature_on_interface_levels"
            if self._stgz
            else "tendency_of_air_potential_temperature"
        )
        dims = DIMS_Z if self._stgz else DIMS
        return {name: {"dims": dims, "units": "K s^-1"}}

    def array_call(self, state):
        # NOTE: time-dependence is resolved host-side; a jitted caller should
        # treat the current hour as a static argument (retrace on change)
        xp = get_namespace(state["air_density"])
        g = self.grid
        rd = self.rpc["gas_constant_of_dry_air"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]

        rho = state["air_density"]
        h_if = state["height_on_interface_levels"]
        if self._p_stg:
            p = 0.5 * (
                state["air_pressure_on_interface_levels"][:, :, :-1]
                + state["air_pressure_on_interface_levels"][:, :, 1:]
            )
        else:
            p = state["air_pressure"]
        theta = p * 0.0 + xp.asarray(
            np.asarray(g.z.to_units("K").data)[np.newaxis, np.newaxis, :],
            dtype=rho.dtype,
        )
        z = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        hs = h_if[:, :, -1:]

        xv = np.asarray(g.x.to_units("m").data)
        yv = np.asarray(g.y.to_units("m").data)
        cx, cy = 0.5 * (xv[0] + xv[-1]), 0.5 * (yv[0] + yv[-1])
        r = xp.asarray(
            np.sqrt((xv[:, None] - cx) ** 2 + (yv[None, :] - cy) ** 2)[:, :, None],
            dtype=rho.dtype,
        )
        cutoff = xp.where(r < self._cl, 1.0, 0.0)

        # day configuration (callers select night via constructor amplitudes)
        f0_sw, f0_fw, a = self._f0d_sw, self._f0d_fw, self._ad
        t_hours = 12.0
        forcing = (
            f0_sw * math.sin(self._w_sw * t_hours)
            + f0_fw * math.sin(self._w_fw * t_hours)
        )
        heating = (
            theta * rd * a / (p * cp) * forcing * xp.exp(-a * (z - hs)) * cutoff
        )
        name = (
            "tendency_of_air_potential_temperature"
            if self._in_diags
            else "air_potential_temperature"
        )
        if self._in_diags:
            return {}, {name: heating}
        return {name: heating}, {}
