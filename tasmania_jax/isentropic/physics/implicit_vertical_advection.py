"""Implicit (Crank–Nicolson) vertical advection via per-column Thomas solves.

JAX re-design of reference
``src/tasmania/isentropic/physics/implicit_vertical_advection.py:48,593``:
γ = dt/(4·dz); tridiagonal rows a[k]=γ·w[k-1], b=1, c[k]=−γ·w[k+1],
d[k]=φ[k] − γ·(w[k-1]φ[k-1] − w[k+1]φ[k+1]) with identity first/last rows
(reference ``subroutine_definitions/cla.py:83-107``).  The solve uses the
registry ``thomas`` kernel (lax.scan sweeps, vectorised over (x, y));
columns are shard-local under the 2-D decomposition (SURVEY.md §5.7).

Two flavours, as in the reference:
* ``...Diagnostic``  — returns the *stepped* fields as diagnostics;
* ``...Prognostic``  — returns tendencies (new − old)/dt.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tasmania_jax.framework.core_components import ImplicitTendencyComponent
from tasmania_jax.framework.stencil import compile_stencil
from tasmania_jax.isentropic.physics.vertical_advection import interface_w
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


def setup_thomas(gamma: float, w, phi, xp):
    """(a, b, c, d) of the CN system (reference ``cla.py:96-107``)."""
    nz = phi.shape[2]
    zeros_edge = xp.zeros_like(phi[:, :, :1])
    a = xp.concatenate(
        [zeros_edge, gamma * w[:, :, : nz - 2], zeros_edge], axis=2
    )
    c = xp.concatenate(
        [zeros_edge, -gamma * w[:, :, 2:nz], zeros_edge], axis=2
    )
    b = xp.ones_like(phi)
    d_mid = phi[:, :, 1 : nz - 1] - gamma * (
        w[:, :, : nz - 2] * phi[:, :, : nz - 2] - w[:, :, 2:nz] * phi[:, :, 2:nz]
    )
    d = xp.concatenate([phi[:, :, :1], d_mid, phi[:, :, nz - 1 :]], axis=2)
    return a, b, c, d


class _ImplicitVerticalAdvectionBase(ImplicitTendencyComponent):
    def __init__(
        self,
        domain,
        moist: bool = False,
        tendency_of_air_potential_temperature_on_interface_levels: bool = False,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self._moist = moist
        self._stgz = tendency_of_air_potential_temperature_on_interface_levels
        self._thomas = compile_stencil("thomas", self.backend, self.backend_options)

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

    def _solve_all(self, state, dt: float):
        """Solve the CN systems for every advected field; returns stepped raw
        fields (reference ``implicit_vertical_advection.py:222-328``)."""
        xp = get_namespace(state["air_isentropic_density"])
        dz = float(np.asarray(self.grid.dz.to_units("K").data))
        gamma = dt / (4.0 * dz)

        if self._stgz:
            w_if = state["tendency_of_air_potential_temperature_on_interface_levels"]
            w = 0.5 * (w_if[:, :, :-1] + w_if[:, :, 1:])
        else:
            w = state["tendency_of_air_potential_temperature"]

        def solve(phi):
            a, b, c, d = setup_thomas(gamma, w, phi, xp)
            return self._thomas(a, b, c, d)

        s = state["air_isentropic_density"]
        out = {
            "air_isentropic_density": solve(s),
            "x_momentum_isentropic": solve(state["x_momentum_isentropic"]),
            "y_momentum_isentropic": solve(state["y_momentum_isentropic"]),
        }
        if self._moist:
            out["_sqv"] = solve(s * state[mfwv])
            out["_sqc"] = solve(s * state[mfcw])
            out["_sqr"] = solve(s * state[mfpw])
        return out


class IsentropicImplicitVerticalAdvectionDiagnostic(_ImplicitVerticalAdvectionBase):
    """Stepped fields returned as diagnostics (reference ``:48``)."""

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    def array_call(self, state, timestep: float):
        out = self._solve_all(state, timestep)
        diags = {
            "air_isentropic_density": out["air_isentropic_density"],
            "x_momentum_isentropic": out["x_momentum_isentropic"],
            "y_momentum_isentropic": out["y_momentum_isentropic"],
        }
        if self._moist:
            s_new = out["air_isentropic_density"]
            diags[mfwv] = out["_sqv"] / s_new
            diags[mfcw] = out["_sqc"] / s_new
            diags[mfpw] = out["_sqr"] / s_new
        return {}, diags


class IsentropicImplicitVerticalAdvectionPrognostic(_ImplicitVerticalAdvectionBase):
    """Tendencies (new − old)/dt (reference ``:593``, stencil ``:907-919``)."""

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

    @property
    def diagnostic_properties(self):
        return {}

    def array_call(self, state, timestep: float):
        out = self._solve_all(state, timestep)
        dt = timestep
        tends = {
            "air_isentropic_density": (
                out["air_isentropic_density"] - state["air_isentropic_density"]
            )
            / dt,
            "x_momentum_isentropic": (
                out["x_momentum_isentropic"] - state["x_momentum_isentropic"]
            )
            / dt,
            "y_momentum_isentropic": (
                out["y_momentum_isentropic"] - state["y_momentum_isentropic"]
            )
            / dt,
        }
        if self._moist:
            s_new = out["air_isentropic_density"]
            tends[mfwv] = (out["_sqv"] / s_new - state[mfwv]) / dt
            tends[mfcw] = (out["_sqc"] / s_new - state[mfcw]) / dt
            tends[mfpw] = (out["_sqr"] / s_new - state[mfpw]) / dt
        return tends, {}
