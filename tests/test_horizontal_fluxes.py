"""Flux-bundle parity tests (reference
``tests/isentropic/test_isentropic_horizontal_fluxes.py``): the FULL
``IsentropicHorizontalFlux`` factory's ``flux_dry`` / ``flux_moist`` bundles
for every scheme, validated against standalone numpy oracles.

Interface parity note: the reference's non-minimal subroutines accept
``dt``/``mtg``/``*_tnd`` arguments but no scheme in the tree reads them (they
exist for scheme families like MacCormack that the reference does not ship —
``subclasses/horizontal_fluxes/{upwind,centered,third_order_upwind,
fifth_order_upwind}.py`` index neither ``mtg`` nor the tendencies).  The
bundles here carry the same signature and the tests pin that passing them
does not change the fluxes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.isentropic.dynamics.horizontal_fluxes import (
    IsentropicHorizontalFlux,
    IsentropicMinimalHorizontalFlux,
)

SCHEMES = ["upwind", "centered", "third_order_upwind", "fifth_order_upwind"]


def oracle_flux_x(scheme, u, phi):
    if scheme == "upwind":
        uf = u[1:-1]
        return uf * np.where(uf > 0.0, phi[:-1], phi[1:])
    if scheme == "centered":
        return u[1:-1] * 0.5 * (phi[:-1] + phi[1:])
    if scheme == "third_order_upwind":
        uf = u[2:-2]
        pm2, pm1, p0, pp1 = phi[:-3], phi[1:-2], phi[2:-1], phi[3:]
        f4 = uf / 12.0 * (7.0 * (p0 + pm1) - (pp1 + pm2))
        return f4 - np.abs(uf) / 12.0 * (3.0 * (p0 - pm1) - (pp1 - pm2))
    if scheme == "fifth_order_upwind":
        uf = u[3:-3]
        pm3, pm2, pm1 = phi[:-5], phi[1:-4], phi[2:-3]
        p0, pp1, pp2 = phi[3:-2], phi[4:-1], phi[5:]
        f6 = uf / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3))
        return f6 - np.abs(uf) / 60.0 * (
            10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3)
        )
    raise ValueError(scheme)


def oracle_flux_y(scheme, v, phi):
    sw = lambda a: np.swapaxes(a, 0, 1)
    return sw(oracle_flux_x(scheme, sw(v), sw(phi)))


def _fields(rng, nx=14, ny=12, nz=3):
    u = rng.uniform(-2.0, 2.0, (nx + 1, ny, nz))
    v = rng.uniform(-2.0, 2.0, (nx, ny + 1, nz))
    mk = lambda lo, hi: rng.uniform(lo, hi, (nx, ny, nz))
    return u, v, mk(5.0, 10.0), mk(-1.0, 1.0), mk(-1.0, 1.0), mk(0.0, 1e-3), mk(0.0, 1e-3), mk(0.0, 1e-3)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize(
    "factory", [IsentropicHorizontalFlux, IsentropicMinimalHorizontalFlux]
)
def test_flux_dry_bundle(scheme, factory):
    rng = np.random.default_rng(0)
    u, v, s, su, sv, *_ = _fields(rng)
    flux = factory.factory(scheme)
    mtg = rng.uniform(1e5, 3e5, s.shape)  # accepted, never read (parity)
    out = flux.flux_dry(
        1.0, 100.0, 100.0, jnp.asarray(s), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(su), jnp.asarray(sv), mtg=jnp.asarray(mtg),
    )
    names = ["s_x", "s_y", "su_x", "su_y", "sv_x", "sv_y"]
    exp = [
        oracle_flux_x(scheme, u, s), oracle_flux_y(scheme, v, s),
        oracle_flux_x(scheme, u, su), oracle_flux_y(scheme, v, su),
        oracle_flux_x(scheme, u, sv), oracle_flux_y(scheme, v, sv),
    ]
    for name, got, want in zip(names, out, exp):
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=1e-12, err_msg=f"{scheme}/{name}"
        )
    # mtg-independence: same bundle with mtg=None is identical
    out2 = flux.flux_dry(
        1.0, 100.0, 100.0, jnp.asarray(s), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(su), jnp.asarray(sv),
    )
    for a, b in zip(out, out2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_flux_moist_bundle(scheme):
    rng = np.random.default_rng(1)
    u, v, s, _, _, sqv, sqc, sqr = _fields(rng)
    flux = IsentropicHorizontalFlux.factory(scheme)
    out = flux.flux_moist(
        1.0, 100.0, 100.0, jnp.asarray(s), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(sqv), jnp.asarray(sqc), jnp.asarray(sqr),
    )
    exp = [
        oracle_flux_x(scheme, u, sqv), oracle_flux_y(scheme, v, sqv),
        oracle_flux_x(scheme, u, sqc), oracle_flux_y(scheme, v, sqc),
        oracle_flux_x(scheme, u, sqr), oracle_flux_y(scheme, v, sqr),
    ]
    for i, (got, want) in enumerate(zip(out, exp)):
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=1e-12, err_msg=f"{scheme}/{i}"
        )


@pytest.mark.parametrize("scheme", SCHEMES)
def test_extent_matches_reference(scheme):
    ext = {"upwind": 1, "centered": 1, "third_order_upwind": 2,
           "fifth_order_upwind": 3}
    flux = IsentropicHorizontalFlux.factory(scheme)
    assert flux.extent == ext[scheme]
