"""Isentropic dynamical core tests: diagnostics vs numpy oracles, balanced
state consistency, steady-state preservation, mountain-wave smoke test
(reference test style: tests/isentropic/*, SURVEY.md §4)."""

from datetime import datetime, timedelta

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.domain import Domain, PhysicalGrid
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic import (
    IsentropicDiagnostics,
    IsentropicDynamicalCore,
    IsentropicMinimalHorizontalFlux,
    get_isentropic_state_from_brunt_vaisala_frequency,
)

CP = 1004.0
RD = 287.05
G = 9.80665
PREF = 1e5


def make_grid(nx=10, ny=8, nz=6, topo="flat", topo_kwargs=None):
    return PhysicalGrid(
        (0.0, 1e5),
        nx,
        (0.0, 1e5),
        ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
        nz,
        topography_type=topo,
        topography_kwargs=topo_kwargs,
    )


def oracle_diagnostics(s, pt, dz, theta, hs):
    """Direct numpy re-derivation of the reference k-loops
    (isentropic/dynamics/diagnostics.py:339-361)."""
    nx, ny, nz = s.shape
    p = np.zeros((nx, ny, nz + 1))
    p[:, :, 0] = pt
    for k in range(1, nz + 1):
        p[:, :, k] = p[:, :, k - 1] + G * dz * s[:, :, k - 1]
    exn = CP * (p / PREF) ** (RD / CP)
    mtg = np.zeros((nx, ny, nz))
    mtg_s = theta[nz] * exn[:, :, nz] + G * hs
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]
    h = np.zeros((nx, ny, nz + 1))
    h[:, :, nz] = hs
    for k in range(nz - 1, -1, -1):
        h[:, :, k] = h[:, :, k + 1] - RD * (
            theta[k] * exn[:, :, k] + theta[k + 1] * exn[:, :, k + 1]
        ) * (p[:, :, k] - p[:, :, k + 1]) / (CP * G * (p[:, :, k] + p[:, :, k + 1]))
    return p, exn, mtg, h


class TestDiagnostics:
    def test_vs_oracle(self):
        grid = make_grid()
        diag = IsentropicDiagnostics(grid)
        rng = np.random.default_rng(0)
        s = 50.0 + 5.0 * rng.random((grid.nx, grid.ny, grid.nz))
        pt = 2000.0
        p, exn, mtg, h = diag.get_diagnostic_variables(jnp.asarray(s), pt)
        theta = np.asarray(grid.z_on_interface_levels.data)
        hs = np.zeros((grid.nx, grid.ny))[:, :, None][:, :, 0]
        po, exno, mtgo, ho = oracle_diagnostics(s, pt, float(np.asarray(grid.dz.data)), theta, hs)
        np.testing.assert_allclose(np.asarray(p), po, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(exn), exno, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(mtg), mtgo, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(h), ho, rtol=1e-10)

    def test_density_and_temperature(self):
        grid = make_grid()
        diag = IsentropicDiagnostics(grid)
        rng = np.random.default_rng(1)
        s = 50.0 + 5.0 * rng.random((grid.nx, grid.ny, grid.nz))
        p, exn, mtg, h = diag.get_diagnostic_variables(jnp.asarray(s), 2000.0)
        rho, t = diag.get_density_and_temperature(jnp.asarray(s), exn, h)
        theta = np.asarray(grid.z_on_interface_levels.data)
        t_np, rho_np = np.asarray(t), np.asarray(rho)
        assert np.isfinite(t_np).all() and (t_np > 0).all()
        assert np.isfinite(rho_np).all() and (rho_np > 0).all()
        # oracle: t = (θ[k]·exn[k] + θ[k+1]·exn[k+1]) / (2cp)
        exn_np = np.asarray(exn)
        expected = 0.5 / CP * (
            theta[None, None, :-1] * exn_np[:, :, :-1]
            + theta[None, None, 1:] * exn_np[:, :, 1:]
        )
        np.testing.assert_allclose(t_np, expected, rtol=1e-12)


class TestStateFactory:
    def test_balance_consistency(self):
        """Feeding the factory's s back into the diagnostics must reproduce the
        factory's own p/exn/mtg/h (hydrostatic balance)."""
        grid = make_grid(nz=10)
        state = get_isentropic_state_from_brunt_vaisala_frequency(
            grid,
            datetime(2000, 1, 1),
            FieldArray(np.asarray(10.0), "m s^-1", ()),
            FieldArray(np.asarray(0.0), "m s^-1", ()),
            FieldArray(np.asarray(0.01), "s^-1", ()),
        )
        s = state["air_isentropic_density"].data
        p = np.asarray(state["air_pressure_on_interface_levels"].data)
        pt = float(p[0, 0, 0])
        diag = IsentropicDiagnostics(grid)
        p2, exn2, mtg2, h2 = diag.get_diagnostic_variables(s, pt)
        np.testing.assert_allclose(np.asarray(p2), p, rtol=1e-10)
        np.testing.assert_allclose(
            np.asarray(exn2),
            np.asarray(state["exner_function_on_interface_levels"].data),
            rtol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(mtg2),
            np.asarray(state["montgomery_potential"].data),
            rtol=1e-8,
        )
        # the factory's h comes from the N^2 recurrence, the diagnostics' h
        # from discrete hydrostatic ln-p integration: consistent to O(dz) only
        np.testing.assert_allclose(
            np.asarray(h2),
            np.asarray(state["height_on_interface_levels"].data),
            rtol=0.05,
        )

    def test_moist_state(self):
        grid = make_grid(nz=10)
        state = get_isentropic_state_from_brunt_vaisala_frequency(
            grid,
            datetime(2000, 1, 1),
            FieldArray(np.asarray(5.0), "m s^-1", ()),
            FieldArray(np.asarray(0.0), "m s^-1", ()),
            FieldArray(np.asarray(0.01), "s^-1", ()),
            moist=True,
            precipitation=True,
        )
        qv = np.asarray(state["mass_fraction_of_water_vapor_in_air"].data)
        assert (qv >= 0).all() and qv.max() < 0.1
        assert "precipitation" in state


class TestFluxes:
    @pytest.mark.parametrize(
        "scheme,extent", [("upwind", 1), ("centered", 1), ("third_order_upwind", 2), ("fifth_order_upwind", 3)]
    )
    def test_constant_advection(self, scheme, extent):
        """For uniform phi and u, flux = u*phi at every face."""
        flux = IsentropicMinimalHorizontalFlux.factory(scheme)
        assert flux.extent == extent
        nx, ny, nz = 12, 10, 4
        phi = 3.0 * jnp.ones((nx, ny, nz))
        u = 2.0 * jnp.ones((nx + 1, ny, nz))
        fx = flux.flux_x(u, phi)
        assert fx.shape == (nx + 1 - 2 * extent, ny, nz)
        np.testing.assert_allclose(np.asarray(fx), 6.0, rtol=1e-13)

    def test_upwind_oracle(self):
        flux = IsentropicMinimalHorizontalFlux.factory("upwind")
        rng = np.random.default_rng(2)
        phi = rng.random((8, 5, 3))
        u = rng.standard_normal((9, 5, 3))
        fx = np.asarray(flux.flux_x(jnp.asarray(u), jnp.asarray(phi)))
        expected = u[1:-1] * np.where(u[1:-1] > 0, phi[:-1], phi[1:])
        np.testing.assert_allclose(fx, expected, rtol=1e-13)


def build_core(grid_kwargs=None, moist=False, scheme="rk3ws_si", flux="third_order_upwind", nb=3):
    gk = {"nx": 24, "ny": 24, "nz": 8, "topo": "flat", "topo_kwargs": None}
    gk.update(grid_kwargs or {})
    domain = Domain(
        (0.0, 1e5),
        gk["nx"],
        (0.0, 1e5),
        gk["ny"],
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
        gk["nz"],
        horizontal_boundary_type="relaxed",
        nb=nb,
        horizontal_boundary_kwargs={"nr": 6},
        topography_type=gk["topo"],
        topography_kwargs=gk["topo_kwargs"],
    )
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid,
        datetime(2000, 1, 1),
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(0.01), "s^-1", ()),
        moist=moist,
    )
    domain.horizontal_boundary.reference_state = state
    pt = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    core = IsentropicDynamicalCore(
        domain,
        moist=moist,
        time_integration_scheme=scheme,
        horizontal_flux_scheme=flux,
        time_integration_properties={"pt": pt, "eps": 0.5},
        damp=True,
        damp_depth=3,
        smooth=False,
    )
    return domain, core, state


class TestDryCore:
    def test_steady_uniform_flow_flat_terrain(self):
        """Horizontally uniform balanced state over flat terrain is a steady
        state: after N steps nothing may drift (machine precision)."""
        domain, core, state = build_core()
        dt = timedelta(seconds=20)
        s0 = np.asarray(state["air_isentropic_density"].data)
        cur = state
        for _ in range(5):
            cur = core(cur, {}, dt)
        s5 = np.asarray(cur["air_isentropic_density"].data)
        np.testing.assert_allclose(s5, s0, rtol=1e-10)
        u5 = np.asarray(cur["x_velocity_at_u_locations"].data)
        np.testing.assert_allclose(u5, 10.0, rtol=1e-10)

    @pytest.mark.parametrize("scheme", ["forward_euler_si", "rk3ws_si"])
    def test_mountain_wave_smoke(self, scheme):
        """Growing mountain perturbs the flow; fields stay finite and the
        y-velocity picks up a signal by symmetry breaking."""
        domain, core, state = build_core(
            grid_kwargs={
                "topo": "gaussian",
                "topo_kwargs": {
                    "max_height": FieldArray(np.asarray(200.0), "m", ()),
                    "width_x": FieldArray(np.asarray(1e4), "m", ()),
                    "width_y": FieldArray(np.asarray(1e4), "m", ()),
                },
            },
            scheme=scheme,
        )
        dt = timedelta(seconds=10)
        cur = state
        for _ in range(10):
            cur = core(cur, {}, dt)
        for name in ("air_isentropic_density", "x_momentum_isentropic", "x_velocity_at_u_locations"):
            arr = np.asarray(cur[name].data)
            assert np.isfinite(arr).all(), name
        # the flow responds to the mountain
        u = np.asarray(cur["x_velocity_at_u_locations"].data)
        assert np.abs(u - 10.0).max() > 1e-6


class TestMoistCore:
    def test_moist_steady_state(self):
        domain, core, state = build_core(moist=True)
        dt = timedelta(seconds=20)
        qv0 = np.asarray(state["mass_fraction_of_water_vapor_in_air"].data)
        cur = state
        for _ in range(3):
            cur = core(cur, {}, dt)
        qv3 = np.asarray(cur["mass_fraction_of_water_vapor_in_air"].data)
        np.testing.assert_allclose(qv3, qv0, atol=1e-12)
