"""WRF-style Kessler warm-rain microphysics suite.

JAX re-design of reference
``src/tasmania/physics/microphysics/kessler.py:54,454,774,1090,1221``:

* ``KesslerMicrophysics``                       — autoconversion + accretion
  (+ optional rain evaporation with its θ-tendency);
* ``KesslerSaturationAdjustmentDiagnostic``     — implicit adjustment, new
  qv/qc/T returned as diagnostics + θ-tendency;
* ``KesslerSaturationAdjustmentPrognostic``     — relaxed adjustment with rate
  ``saturation_rate``;
* ``KesslerFallVelocity``                       — raindrop fall speed;
* ``KesslerSedimentation``                      — qr tendency from the
  sedimentation flux.

All formulas verbatim from the reference (Doms et al. 2015; Mielikainen et
al. 2013); everything is elementwise → one fused XLA loop each under jit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from tasmania_jax.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
    TendencyComponent,
)
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.physics.microphysics.utils import SedimentationFlux
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


def _coeff(value, units, default):
    if isinstance(value, FieldArray):
        from tasmania_jax.utils.units import conversion_factor

        return float(np.asarray(value.data)) * conversion_factor(value.units, units)
    return float(value) if value is not None else default


def _tetens(t, xp):
    return 610.78 * xp.exp(17.27 * (t - 273.16) / (t - 35.86))


class _KesslerBase(TendencyComponent):
    default_physical_constants = {
        "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
        "gas_constant_of_water_vapor": (461.52, "J K^-1 kg^-1"),
        "latent_heat_of_vaporization_of_water": (2.5e6, "J kg^-1"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def _p_exn(self, state, xp):
        if self._p_stg:
            p_if = state["air_pressure_on_interface_levels"]
            exn_if = state["exner_function_on_interface_levels"]
            p = 0.5 * (p_if[:, :, :-1] + p_if[:, :, 1:])
            exn = 0.5 * (exn_if[:, :, :-1] + exn_if[:, :, 1:])
        else:
            p = state["air_pressure"]
            exn = state["exner_function"]
        return p, exn

    def _p_props(self, props):
        if self._p_stg:
            props["air_pressure_on_interface_levels"] = {"dims": DIMS_Z, "units": "Pa"}
            props["exner_function_on_interface_levels"] = {
                "dims": DIMS_Z,
                "units": "J K^-1 kg^-1",
            }
        else:
            props["air_pressure"] = {"dims": DIMS, "units": "Pa"}
            props["exner_function"] = {"dims": DIMS, "units": "J K^-1 kg^-1"}
        return props


class KesslerMicrophysics(_KesslerBase):
    """Autoconversion + accretion (+ rain evaporation) tendencies
    (reference ``kessler.py:54``, stencil ``:308-376``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        air_pressure_on_interface_levels: bool = True,
        tendency_of_air_potential_temperature_in_diagnostics: bool = False,
        rain_evaporation: bool = True,
        autoconversion_threshold=None,
        autoconversion_rate=None,
        collection_rate=None,
        physical_constants=None,
        **kwargs,
    ) -> None:
        self._p_stg = air_pressure_on_interface_levels
        self._pttd = tendency_of_air_potential_temperature_in_diagnostics
        self._rain_evaporation = rain_evaporation
        super().__init__(domain, grid_type, physical_constants=physical_constants, **kwargs)
        self._a = _coeff(autoconversion_threshold, "g g^-1", 0.001)
        self._k1 = _coeff(autoconversion_rate, "s^-1", 0.001)
        self._k2 = _coeff(collection_rate, "s^-1", 2.2)

    @property
    def input_properties(self):
        props = {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        }
        return self._p_props(props)

    @property
    def tendency_properties(self):
        props = {
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"},
        }
        if self._rain_evaporation:
            props[mfwv] = {"dims": DIMS, "units": "g g^-1 s^-1"}
            if not self._pttd:
                props["air_potential_temperature"] = {"dims": DIMS, "units": "K s^-1"}
        return props

    @property
    def diagnostic_properties(self):
        if self._rain_evaporation and self._pttd:
            return {
                "tendency_of_air_potential_temperature": {
                    "dims": DIMS,
                    "units": "K s^-1",
                }
            }
        return {}

    def array_call(self, state):
        xp = get_namespace(state["air_density"])
        rd = self.rpc["gas_constant_of_dry_air"]
        rv = self.rpc["gas_constant_of_water_vapor"]
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        beta = rd / rv
        rho = state["air_density"]
        t = state["air_temperature"]
        qv, qc, qr = state[mfwv], state[mfcw], state[mfpw]
        p, exn = self._p_exn(state, xp)

        ps = _tetens(t, xp)
        qvs = beta * ps / p
        ar = self._k1 * xp.where(qc > self._a, qc - self._a, 0.0)
        cr = self._k2 * qc * xp.where(qr > 0.0, qr**0.875, 0.0)

        tends: Dict[str, object] = {mfcw: -(ar + cr)}
        diags: Dict[str, object] = {}
        if self._rain_evaporation:
            er = xp.where(
                qr > 0.0, 0.0484794 * (qvs - qv) * (rho * qr) ** (13.0 / 20.0), 0.0
            )
            tends[mfwv] = er
            tends[mfpw] = ar + cr - er
            theta_tnd = -lhvw / exn * er
            if self._pttd:
                diags["tendency_of_air_potential_temperature"] = theta_tnd
            else:
                tends["air_potential_temperature"] = theta_tnd
        else:
            tends[mfpw] = ar + cr
        return tends, diags


class KesslerSaturationAdjustmentDiagnostic(_KesslerBase):
    """Implicit saturation adjustment: adjusted qv/qc/T as diagnostics +
    θ-tendency (reference ``kessler.py:454``, stencil ``:662-714``).
    Implemented as an ImplicitTendencyComponent (needs dt for the θ-tendency)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        air_pressure_on_interface_levels: bool = True,
        physical_constants=None,
        **kwargs,
    ) -> None:
        self._p_stg = air_pressure_on_interface_levels
        super().__init__(domain, grid_type, physical_constants=physical_constants, **kwargs)

    @property
    def input_properties(self):
        props = {
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
        }
        return self._p_props(props)

    @property
    def tendency_properties(self):
        return {"air_potential_temperature": {"dims": DIMS, "units": "K s^-1"}}

    @property
    def diagnostic_properties(self):
        return {
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            "air_temperature": {"dims": DIMS, "units": "K"},
        }

    def __call__(self, state, timestep=None, **kwargs):
        # ImplicitTendencyComponent-style call accepting dt
        from tasmania_jax.framework.field import ensure_timedelta_seconds

        self._dt = ensure_timedelta_seconds(timestep) if timestep is not None else 1.0
        return super().__call__(state, timestep, **kwargs)

    def array_call(self, state):
        xp = get_namespace(state["air_temperature"])
        rd = self.rpc["gas_constant_of_dry_air"]
        rv = self.rpc["gas_constant_of_water_vapor"]
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        beta = rd / rv
        dt = getattr(self, "_dt", 1.0)

        t = state["air_temperature"]
        qv, qc = state[mfwv], state[mfcw]
        p, exn = self._p_exn(state, xp)
        ps = _tetens(t, xp)
        qvs = beta * ps / p
        sat = (qvs - qv) / (1.0 + qvs * lhvw**2 / (cp * rv * t**2))
        dq = xp.where(sat <= qc, sat, qc)

        tends = {"air_potential_temperature": (lhvw / exn) * (-dq / dt)}
        diags = {
            mfwv: qv + dq,
            mfcw: qc - dq,
            "air_temperature": t - dq * lhvw / cp,
        }
        return tends, diags


class KesslerSaturationAdjustmentPrognostic(_KesslerBase):
    """Relaxed saturation adjustment with rate ``saturation_rate``
    (reference ``kessler.py:774``, stencil ``:1021-1031``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        air_pressure_on_interface_levels: bool = True,
        saturation_rate=None,
        physical_constants=None,
        **kwargs,
    ) -> None:
        self._p_stg = air_pressure_on_interface_levels
        super().__init__(domain, grid_type, physical_constants=physical_constants, **kwargs)
        self._sr = _coeff(saturation_rate, "s^-1", 0.5)

    @property
    def input_properties(self):
        props = {
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
        }
        return self._p_props(props)

    @property
    def tendency_properties(self):
        return {
            mfwv: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            "air_potential_temperature": {"dims": DIMS, "units": "K s^-1"},
        }

    def array_call(self, state):
        xp = get_namespace(state["air_temperature"])
        rd = self.rpc["gas_constant_of_dry_air"]
        rv = self.rpc["gas_constant_of_water_vapor"]
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        beta = rd / rv
        sr = self._sr

        t = state["air_temperature"]
        qv, qc = state[mfwv], state[mfcw]
        p, exn = self._p_exn(state, xp)
        ps = _tetens(t, xp)
        qvs = beta * ps / p
        sat = (qvs - qv) / (1.0 + qvs * lhvw**2 / (cp * rv * t**2))
        dq = xp.where(sat <= qc, sat, qc)

        return (
            {
                mfwv: sr * dq,
                mfcw: -sr * dq,
                "air_potential_temperature": -sr * (lhvw / exn) * dq,
            },
            {},
        )


class KesslerFallVelocity(DiagnosticComponent):
    """Raindrop fall speed (reference ``kessler.py:1090``, stencil ``:1198-1203``):
    vt = 36.34·(1e-3·ρ·qr⁺)^0.1346·(ρ_s/ρ)^0.5 with ρ_s the surface density."""

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {"raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"}}

    def array_call(self, state):
        xp = get_namespace(state["air_density"])
        rho = state["air_density"]
        qr = state[mfpw]
        rho_s = rho[:, :, -1:]  # surface level broadcast over the column
        vt = (
            36.34
            * (1.0e-3 * rho * xp.where(qr > 0.0, qr, 0.0)) ** 0.1346
            * (rho_s / rho) ** 0.5
        )
        return {"raindrop_fall_velocity": vt}


class KesslerSedimentation(ImplicitTendencyComponent):
    """qr tendency from the sedimentation flux (reference ``kessler.py:1221``,
    stencil ``:1340-1370``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        sedimentation_flux_scheme: str = "first_order_upwind",
        maximum_vertical_cfl: float = 0.975,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self._sflux = SedimentationFlux.factory(sedimentation_flux_scheme, self.backend)

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
            "raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def tendency_properties(self):
        return {mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"}}

    @property
    def diagnostic_properties(self):
        return {}

    def array_call(self, state, timestep: float):
        xp = get_namespace(state["air_density"])
        rho = state["air_density"]
        h_if = state["height_on_interface_levels"]
        h = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        qr = state[mfpw]
        vt = state["raindrop_fall_velocity"]
        nb = self._sflux.nb
        dfdz = self._sflux(rho, h, qr, vt)  # levels [nb, nz)
        tnd = xp.zeros_like(qr)
        interior = dfdz / rho[:, :, nb:]
        if xp is np:
            tnd[:, :, nb:] = interior
        else:
            tnd = tnd.at[:, :, nb:].set(interior.astype(tnd.dtype))
        return {mfpw: tnd}, {}

