"""Burgers model end-to-end tests against the analytic Zhao solution
(reference test style: tests/burgers/test_burgers_dycore.py, SURVEY.md §4)."""

from datetime import datetime, timedelta

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.burgers import (
    BurgersAdvection,
    BurgersDynamicalCore,
    BurgersHorizontalDiffusion,
    ZhaoSolutionFactory,
    ZhaoStateFactory,
)
from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray


def first_order_advection_oracle(dx, dy, u, v):
    """Independent numpy re-derivation of the first-order upwind advection."""
    uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
    au, av = np.abs(uc), np.abs(vc)
    adv_u_x = uc / (2 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1]) - au / (2 * dx) * (
        u[2:, 1:-1] - 2 * uc + u[:-2, 1:-1]
    )
    adv_u_y = vc / (2 * dy) * (u[1:-1, 2:] - u[1:-1, :-2]) - av / (2 * dy) * (
        u[1:-1, 2:] - 2 * uc + u[1:-1, :-2]
    )
    return adv_u_x, adv_u_y


class TestAdvection:
    def test_first_order_oracle(self):
        rng = np.random.default_rng(0)
        u = rng.normal(size=(8, 8, 1))
        v = rng.normal(size=(8, 8, 1))
        adv = BurgersAdvection.factory("first_order")
        a_ux, a_uy, _, _ = adv(2.0, 3.0, jnp.asarray(u), jnp.asarray(v))
        e_ux, e_uy = first_order_advection_oracle(2.0, 3.0, u, v)
        np.testing.assert_allclose(np.asarray(a_ux), e_ux, atol=1e-12)
        np.testing.assert_allclose(np.asarray(a_uy), e_uy, atol=1e-12)

    @pytest.mark.parametrize(
        "scheme,extent",
        [
            ("first_order", 1), ("second_order", 1), ("third_order", 2),
            ("fourth_order", 2), ("fifth_order", 3), ("sixth_order", 3),
        ],
    )
    def test_shapes_and_uniform_flow(self, scheme, extent):
        """Advection of a constant field is zero for every scheme."""
        adv = BurgersAdvection.factory(scheme)
        assert adv.extent == extent
        n = 10
        u = 2.5 * jnp.ones((n, n, 1))
        v = -1.5 * jnp.ones((n, n, 1))
        terms = adv(1.0, 1.0, u, v)
        for t in terms:
            assert t.shape == (n - 2 * extent, n - 2 * extent, 1)
            np.testing.assert_allclose(np.asarray(t), 0.0, atol=1e-12)


def make_zhao_setup(nx=33, ny=33, nb=3, eps_v=0.1):
    itime = datetime(2000, 1, 1)
    eps = FieldArray(np.asarray(eps_v), "m^2 s^-1", ())
    zsf = ZhaoSolutionFactory(itime, eps)
    domain = Domain(
        (0.0, 1.0),
        nx,
        (0.0, 1.0),
        ny,
        FieldArray(np.array([1.0, 0.0]), "1", ("z",)),
        1,
        horizontal_boundary_type="dirichlet",
        nb=nb,
        horizontal_boundary_kwargs={"core": zsf},
    )
    state_factory = ZhaoStateFactory(itime, eps)
    return itime, zsf, domain, state_factory


class TestZhao:
    def test_initial_state(self):
        itime, zsf, domain, sf = make_zhao_setup()
        state = sf(itime, domain.numerical_grid)
        u = np.asarray(state["x_velocity"].data)
        assert u.shape == (33, 33, 1)
        assert np.isfinite(u).all()

    @pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
    def test_dycore_tracks_exact_solution(self, scheme):
        itime, zsf, domain, sf = make_zhao_setup(nx=21, ny=21)
        diffusion = BurgersHorizontalDiffusion(
            domain,
            "numerical",
            "second_order",
            FieldArray(np.asarray(0.1), "m^2 s^-1", ()),
        )
        dycore = BurgersDynamicalCore(
            domain,
            fast_tendency_component=diffusion,
            time_integration_scheme=scheme,
            flux_scheme="first_order",
        )
        state = sf(itime, domain.numerical_grid)
        domain.horizontal_boundary.reference_state = state

        dt = timedelta(seconds=1e-3)
        nt = 10
        for _ in range(nt):
            state = dycore(state, {}, dt)

        t_end = itime + nt * dt
        assert state["time"] == t_end
        u_num = np.asarray(state["x_velocity"].data)
        u_exact = zsf(t_end, domain.numerical_grid, field_name="x_velocity")
        err = np.abs(u_num - u_exact).max()
        scale = np.abs(u_exact).max()
        assert err < 0.05 * scale, f"{scheme}: err={err}, scale={scale}"

    def test_rk_schemes_agree(self):
        """At this resolution the error is spatially dominated: rk2 and rk3ws
        must essentially coincide, and both stay well under 1% of the signal."""
        errs = {}
        for scheme in ("rk2", "rk3ws"):
            itime, zsf, domain, sf = make_zhao_setup(nx=21, ny=21)
            diffusion = BurgersHorizontalDiffusion(
                domain,
                "numerical",
                "second_order",
                FieldArray(np.asarray(0.1), "m^2 s^-1", ()),
            )
            dycore = BurgersDynamicalCore(
                domain,
                fast_tendency_component=diffusion,
                time_integration_scheme=scheme,
                flux_scheme="third_order",
            )
            state = sf(itime, domain.numerical_grid)
            domain.horizontal_boundary.reference_state = state
            # eps*dt/dx^2 = 0.16 — inside the explicit diffusion stability limit
            dt = timedelta(seconds=0.004)
            nt = 25
            for _ in range(nt):
                state = dycore(state, {}, dt)
            u_num = np.asarray(state["x_velocity"].data)
            u_exact = zsf(itime + nt * dt, domain.numerical_grid, field_name="x_velocity")
            errs[scheme] = np.abs(u_num - u_exact).max()
            scale = np.abs(u_exact).max()
            assert errs[scheme] < 0.01 * scale, f"{scheme}: {errs[scheme]} vs {scale}"
        assert errs["rk3ws"] == pytest.approx(errs["rk2"], rel=0.1)
