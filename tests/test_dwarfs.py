"""Dwarf tests vs straightforward numpy recomputation (reference test style:
tests/dwarfs/*, SURVEY.md §4)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.domain import PhysicalGrid
from tasmania_jax.dwarfs import (
    HorizontalDiffusion,
    HorizontalHyperDiffusion,
    HorizontalSmoothing,
    HorizontalVelocity,
    VerticalDamping,
    WaterConstituent,
)
from tasmania_jax.framework.field import FieldArray


def rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


class TestHorizontalDiffusion:
    def test_second_order_vs_oracle(self):
        shape, dx, dy, nb = (12, 14, 5), 100.0, 120.0, 2
        hd = HorizontalDiffusion.factory(
            "second_order", shape, dx, dy, 1.0, 1.0, 0, nb
        )
        phi = rand(shape)
        out = np.asarray(hd(jnp.asarray(phi)))
        # numpy oracle
        expected = np.zeros(shape)
        expected[nb:-nb, nb:-nb] = (
            phi[nb - 1 : -nb - 1, nb:-nb] - 2 * phi[nb:-nb, nb:-nb] + phi[nb + 1 : -nb + 1, nb:-nb]
        ) / dx**2 + (
            phi[nb:-nb, nb - 1 : -nb - 1] - 2 * phi[nb:-nb, nb:-nb] + phi[nb:-nb, nb + 1 : -nb + 1]
        ) / dy**2
        np.testing.assert_allclose(out, expected, atol=1e-12)

    def test_damped_coefficient(self):
        shape = (12, 14, 10)
        hd = HorizontalDiffusion.factory(
            "second_order", shape, 1.0, 1.0, 0.5, 1.5, 5, 1
        )
        g = hd._gamma[0, 0]
        assert g[0] == pytest.approx(1.5)  # top: max coeff (sin²(π/2)=1)
        assert g[-1] == pytest.approx(0.5)  # bottom: base coeff
        assert np.all(np.diff(g[:5]) < 0)  # monotone decay over damp region

    def test_fourth_order_constant_field(self):
        """Constant field has zero diffusion tendency at any order."""
        shape = (11, 11, 3)
        hd = HorizontalDiffusion.factory("fourth_order", shape, 1.0, 1.0, 1.0, 1.0, 0, 2)
        out = np.asarray(hd(jnp.ones(shape)))
        np.testing.assert_allclose(out, 0.0, atol=1e-12)

    def test_quadratic_exact(self):
        """∇²(x² + y²) = 4 for both orders (polynomial exactness)."""
        nx, ny, nz, d = 16, 16, 2, 1.0
        x = np.arange(nx) * d
        y = np.arange(ny) * d
        phi = (x[:, None] ** 2 + y[None, :] ** 2)[:, :, None] * np.ones((1, 1, nz))
        for scheme, nb in (("second_order", 1), ("fourth_order", 2)):
            hd = HorizontalDiffusion.factory(scheme, phi.shape, d, d, 1.0, 1.0, 0, nb)
            out = np.asarray(hd(jnp.asarray(phi)))
            np.testing.assert_allclose(
                out[nb:-nb, nb:-nb], 4.0, rtol=1e-10, err_msg=scheme
            )


class TestHyperDiffusion:
    def test_first_order_is_laplacian(self):
        shape, dx, dy, nb = (12, 12, 3), 2.0, 3.0, 1
        hh = HorizontalHyperDiffusion.factory(
            "first_order", shape, dx, dy, 1.0, 1.0, 0, nb
        )
        hd = HorizontalDiffusion.factory("second_order", shape, dx, dy, 1.0, 1.0, 0, nb)
        phi = jnp.asarray(rand(shape))
        np.testing.assert_allclose(
            np.asarray(hh(phi)), np.asarray(hd(phi)), atol=1e-12
        )

    def test_second_order_is_biharmonic(self):
        """Order-2 = Laplacian applied twice."""
        shape, dx, dy, nb = (14, 14, 2), 1.0, 1.0, 2
        hh = HorizontalHyperDiffusion.factory(
            "second_order", shape, dx, dy, 1.0, 1.0, 0, nb
        )
        phi = rand(shape, 3)
        out = np.asarray(hh(jnp.asarray(phi)))

        def lap(p):
            return (
                p[:-2, 1:-1] - 2 * p[1:-1, 1:-1] + p[2:, 1:-1]
                + p[1:-1, :-2] - 2 * p[1:-1, 1:-1] + p[1:-1, 2:]
            )

        expected = np.zeros(shape)
        expected[nb:-nb, nb:-nb] = lap(lap(phi))
        np.testing.assert_allclose(out, expected, atol=1e-10)


class TestSmoothing:
    @pytest.mark.parametrize("order,nb", [("first_order", 1), ("second_order", 2), ("third_order", 3)])
    def test_constant_preserved(self, order, nb):
        """Shapiro filters preserve constants (weights sum to 1)."""
        shape = (14, 14, 3)
        hs = HorizontalSmoothing.factory(order, shape, 0.8, 0.8, 0, nb)
        out = np.asarray(hs(5.0 * jnp.ones(shape)))
        np.testing.assert_allclose(out, 5.0, rtol=1e-12)

    def test_first_order_oracle(self):
        shape, nb, g = (10, 10, 2), 1, 0.5
        hs = HorizontalSmoothing.factory("first_order", shape, g, g, 0, nb)
        phi = rand(shape, 5)
        out = np.asarray(hs(jnp.asarray(phi)))
        expected = phi.copy()
        expected[1:-1, 1:-1] = (1 - g) * phi[1:-1, 1:-1] + 0.25 * g * (
            phi[:-2, 1:-1] + phi[2:, 1:-1] + phi[1:-1, :-2] + phi[1:-1, 2:]
        )
        np.testing.assert_allclose(out, expected, atol=1e-12)

    def test_kills_two_delta_x_wave(self):
        """A 2Δx wave in x (constant in y) is exactly annihilated at γ=1 by the
        first-order filter: (1-γ)φ + γ/4·(-2φ + 2φ) = 0."""
        shape = (16, 16, 1)
        wave = ((-1.0) ** np.arange(16))[:, None, None] * np.ones((1, 16, 1))
        hs = HorizontalSmoothing.factory("first_order", shape, 1.0, 1.0, 0, 1)
        out = np.asarray(hs(jnp.asarray(wave)))
        np.testing.assert_allclose(out[1:-1, 1:-1], 0.0, atol=1e-12)


class TestVerticalDamping:
    def make_grid(self, nz=10):
        return PhysicalGrid(
            (0.0, 1e3), 6, (0.0, 1e3), 6,
            FieldArray(np.array([10000.0, 0.0]), "m", ("z",)), nz,
        )

    def test_rayleigh(self):
        g = self.make_grid()
        vd = VerticalDamping.factory("rayleigh", g, damp_depth=5, damp_coeff_max=0.01)
        shape = (6, 6, 10)
        now = jnp.asarray(rand(shape, 1))
        new = jnp.asarray(rand(shape, 2))
        ref = jnp.asarray(rand(shape, 3))
        out = np.asarray(vd(10.0, now, new, ref))
        r = vd._rmat[False][0, 0]
        expected = np.asarray(new) - 10.0 * r[None, None, :] * (
            np.asarray(now) - np.asarray(ref)
        )
        np.testing.assert_allclose(out, expected, atol=1e-12)
        # no damping below the damp region
        np.testing.assert_allclose(out[:, :, 5:], np.asarray(new)[:, :, 5:])

    def test_rmat_profile(self):
        g = self.make_grid()
        vd = VerticalDamping.factory("rayleigh", g, damp_depth=5, damp_coeff_max=0.01)
        r = vd._rmat[False][0, 0]
        assert r[0] > r[3] > 0.0
        assert np.all(r[5:] == 0.0)


class TestVelocityAndWater:
    def test_momenta_roundtrip(self):
        g = PhysicalGrid(
            (0.0, 1e3), 8, (0.0, 1e3), 6,
            FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 4,
        )
        hv = HorizontalVelocity(g, staggering=True)
        d = jnp.asarray(1.0 + 0.1 * np.abs(rand((8, 6, 4), 1)))
        u = jnp.asarray(rand((9, 6, 4), 2))
        v = jnp.asarray(rand((8, 7, 4), 3))
        du, dv = hv.get_momenta(d, u, v)
        assert du.shape == (8, 6, 4) and dv.shape == (8, 6, 4)
        np.testing.assert_allclose(
            np.asarray(du), 0.5 * np.asarray(d) * (np.asarray(u)[:-1] + np.asarray(u)[1:])
        )
        u2, v2 = hv.get_velocity_components(d, du, dv)
        assert u2.shape == (9, 6, 4) and v2.shape == (8, 7, 4)
        # interior of recovered velocity solves the staggered-average equations
        expected_u = (np.asarray(du)[:-1] + np.asarray(du)[1:]) / (
            np.asarray(d)[:-1] + np.asarray(d)[1:]
        )
        np.testing.assert_allclose(np.asarray(u2)[1:-1], expected_u)

    def test_water_constituent(self):
        g = PhysicalGrid(
            (0.0, 1e3), 4, (0.0, 1e3), 4,
            FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 2,
        )
        wc = WaterConstituent(g, clipping=True)
        d = jnp.asarray(np.abs(rand((4, 4, 2), 1)) + 1.0)
        q = jnp.asarray(rand((4, 4, 2), 2))  # has negatives
        dq = wc.get_density_of_water_constituent(d, q)
        assert float(jnp.min(dq)) >= 0.0
        q2 = wc.get_mass_fraction_of_water_constituent_in_air(d, dq)
        np.testing.assert_allclose(
            np.asarray(q2), np.maximum(np.asarray(q), 0.0), atol=1e-12
        )


# --------------------------------------------------------------------------- #
# suite-harness coverage (tests/suites.py; VERDICT r2 item 7): the isentropic  #
# TendencyComponent wrapper over the diffusion dwarf                           #
# --------------------------------------------------------------------------- #

from suites import BACKENDS, ComponentTestSuite, DomainSuite  # noqa: E402
from tasmania_jax.isentropic.physics import (  # noqa: E402
    IsentropicHorizontalDiffusion,
)


class _DiffusionSuite(ComponentTestSuite):
    def __init__(self, ds, component, nb):
        super().__init__(ds, component)
        self.nb = nb

    def reference_call(self, raw):
        g = self.ds.grid
        dx = float(np.asarray(g.dx.to_units("m").data))
        dy = float(np.asarray(g.dy.to_units("m").data))
        nb = self.nb

        def lap(p):
            out = np.zeros_like(p)
            out[nb:-nb, nb:-nb] = (
                p[nb - 1 : -nb - 1, nb:-nb]
                - 2 * p[nb:-nb, nb:-nb]
                + p[nb + 1 : -nb + 1, nb:-nb]
            ) / dx**2 + (
                p[nb:-nb, nb - 1 : -nb - 1]
                - 2 * p[nb:-nb, nb:-nb]
                + p[nb:-nb, nb + 1 : -nb + 1]
            ) / dy**2
            return out

        return (
            {
                "air_isentropic_density": lap(raw["air_isentropic_density"]),
                "x_momentum_isentropic": lap(raw["x_momentum_isentropic"]),
                "y_momentum_isentropic": lap(raw["y_momentum_isentropic"]),
            },
            {},
        )


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("with_out", [False, True])
def test_isentropic_diffusion_suite(backend, with_out):
    ds = DomainSuite(np.random.default_rng(13), nb=2, backend=backend)
    comp = IsentropicHorizontalDiffusion(
        ds.domain,
        "second_order",
        diffusion_coeff=FieldArray(np.asarray(1.0), "s^-1", ()),
    )
    suite = _DiffusionSuite(ds, comp, nb=2)
    suite.run_tendency(atol=1e-9, with_out=with_out)
