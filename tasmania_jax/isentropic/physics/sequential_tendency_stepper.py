"""Custom sequential-tendency stepper fusing Crank–Nicolson vertical advection
into the stepping algebra.

JAX re-design of reference
``src/tasmania/isentropic/physics/sequential_tendency_stepper.py:99``
(registered as ``"isentropic_vertical_advection"``): per column,
``d[k] = φ_prv[k] − γ(w[k−1]·φ[k−1] − w[k+1]·φ[k+1])`` with the off-diagonals
from the *current* state's vertical velocity and the rhs anchored to the
*provisional* state (reference gt4py subroutines ``:81-96``); γ = dt/(4·dz).
Solved with the registry ``thomas`` kernel (lax.scan sweeps, shard-local
columns).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from tasmania_jax.framework.registry import factor_register
from tasmania_jax.framework.stencil import compile_stencil
from tasmania_jax.framework.steppers import SequentialTendencyStepper
from tasmania_jax.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
)
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"


def setup_thomas_sts(gamma: float, w, phi, phi_prv, xp):
    """(a, b, c, d): CN system anchored to the provisional state."""
    nz = phi.shape[2]
    zeros_edge = xp.zeros_like(phi[:, :, :1])
    a = xp.concatenate([zeros_edge, gamma * w[:, :, : nz - 2], zeros_edge], axis=2)
    c = xp.concatenate([zeros_edge, -gamma * w[:, :, 2:nz], zeros_edge], axis=2)
    b = xp.ones_like(phi)
    d_mid = phi_prv[:, :, 1 : nz - 1] - gamma * (
        w[:, :, : nz - 2] * phi[:, :, : nz - 2] - w[:, :, 2:nz] * phi[:, :, 2:nz]
    )
    d = xp.concatenate([phi_prv[:, :, :1], d_mid, phi_prv[:, :, nz - 1 :]], axis=2)
    return a, b, c, d


@factor_register("isentropic_vertical_advection")
class IsentropicVerticalAdvectionSTS(SequentialTendencyStepper):
    """STS stepper whose wrapped component must be an
    :class:`IsentropicImplicitVerticalAdvectionDiagnostic`."""

    def __init__(self, *args, **kwargs) -> None:
        core = None
        for arg in args:
            if isinstance(arg, IsentropicImplicitVerticalAdvectionDiagnostic):
                core = arg
        assert core is not None, (
            "isentropic_vertical_advection expects an "
            "IsentropicImplicitVerticalAdvectionDiagnostic component"
        )
        self._core = core
        self._moist = core._moist
        self._stgz = core._stgz
        self._dz = float(np.asarray(core.grid.dz.to_units("K").data))
        self._thomas = compile_stencil("thomas", core.backend, core.backend_options)

        # property dicts mirror the reference overwrite (``:126-137``)
        self.input_properties = dict(core.input_properties)
        self.provisional_input_properties = dict(core.input_properties)
        self.provisional_input_properties.pop(
            "tendency_of_air_potential_temperature", None
        )
        self.provisional_input_properties.pop(
            "tendency_of_air_potential_temperature_on_interface_levels", None
        )
        self.diagnostic_properties: Dict[str, Any] = {}
        self.output_properties = dict(core.diagnostic_properties)
        self._enforce_hb = False
        self._hb = None

    def _call(self, state, prv_state, dt: float, td):
        from tasmania_jax.framework.field import FieldArray, get_array_dict

        raw = get_array_dict(state, self.input_properties)
        raw_prv = get_array_dict(prv_state, self.provisional_input_properties)
        xp = get_namespace(raw["air_isentropic_density"])
        gamma = dt / (4.0 * self._dz)

        if self._stgz:
            w_if = raw["tendency_of_air_potential_temperature_on_interface_levels"]
            w = 0.5 * (w_if[:, :, :-1] + w_if[:, :, 1:])
        else:
            w = raw["tendency_of_air_potential_temperature"]

        def solve(phi, phi_prv):
            a, b, c, d = setup_thomas_sts(gamma, w, phi, phi_prv, xp)
            return self._thomas(a, b, c, d)

        s = raw["air_isentropic_density"]
        s_prv = raw_prv["air_isentropic_density"]
        out_raw: Dict[str, Any] = {
            "air_isentropic_density": solve(s, s_prv),
            "x_momentum_isentropic": solve(
                raw["x_momentum_isentropic"], raw_prv["x_momentum_isentropic"]
            ),
            "y_momentum_isentropic": solve(
                raw["y_momentum_isentropic"], raw_prv["y_momentum_isentropic"]
            ),
        }
        if self._moist:
            s_new = out_raw["air_isentropic_density"]
            for q in (mfwv, mfcw, mfpw):
                sq_new = solve(s * raw[q], s_prv * raw_prv[q])
                out_raw[q] = sq_new / s_new

        from tasmania_jax.framework.field import field_dims

        out = {
            name: FieldArray(
                arr,
                self.output_properties[name]["units"],
                field_dims(name),
            )
            for name, arr in out_raw.items()
        }
        return {}, out
