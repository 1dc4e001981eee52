"""Additional numpy oracles: Burgers advection orders 2-6, vertical fluxes,
implicit-vertical-advection driver path, HDF5 store filters."""

from datetime import datetime

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.burgers import BurgersAdvection
from tasmania_jax.isentropic.dynamics.vertical_fluxes import (
    IsentropicMinimalVerticalFlux,
)


def _adv_oracle(order, dx, dy, u, v):
    """Independent numpy transcription of the reference advection formulas
    (burgers/dynamics/subclasses/advection/*)."""
    if order == 2:
        uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
        return uc / (2 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1]), vc / (2 * dy) * (
            u[1:-1, 2:] - u[1:-1, :-2]
        )
    if order == 4:
        uc, vc = u[2:-2, 2:-2], v[2:-2, 2:-2]
        ax = uc / (12 * dx) * (
            8 * (u[3:-1, 2:-2] - u[1:-3, 2:-2]) - (u[4:, 2:-2] - u[:-4, 2:-2])
        )
        ay = vc / (12 * dy) * (
            8 * (u[2:-2, 3:-1] - u[2:-2, 1:-3]) - (u[2:-2, 4:] - u[2:-2, :-4])
        )
        return ax, ay
    if order == 6:
        uc, vc = u[3:-3, 3:-3], v[3:-3, 3:-3]
        ax = uc / (60 * dx) * (
            45 * (u[4:-2, 3:-3] - u[2:-4, 3:-3])
            - 9 * (u[5:-1, 3:-3] - u[1:-5, 3:-3])
            + (u[6:, 3:-3] - u[:-6, 3:-3])
        )
        ay = vc / (60 * dy) * (
            45 * (u[3:-3, 4:-2] - u[3:-3, 2:-4])
            - 9 * (u[3:-3, 5:-1] - u[3:-3, 1:-5])
            + (u[3:-3, 6:] - u[3:-3, :-6])
        )
        return ax, ay
    raise ValueError(order)


@pytest.mark.parametrize(
    "scheme,order", [("second_order", 2), ("fourth_order", 4), ("sixth_order", 6)]
)
def test_burgers_centered_orders_oracle(scheme, order):
    rng = np.random.default_rng(0)
    u = rng.normal(size=(12, 12, 1))
    v = rng.normal(size=(12, 12, 1))
    adv = BurgersAdvection.factory(scheme)
    a_ux, a_uy, _, _ = adv(2.0, 3.0, jnp.asarray(u), jnp.asarray(v))
    e_ux, e_uy = _adv_oracle(order, 2.0, 3.0, u, v)
    np.testing.assert_allclose(np.asarray(a_ux), e_ux, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a_uy), e_uy, atol=1e-12)


def test_burgers_odd_orders_reduce_to_even_for_positive_u():
    """Upwind dissipation vanishes when the field is linear: third-order flux
    equals fourth-order on a linear profile."""
    n = 12
    x = np.arange(n, dtype=float)
    lin = (2.0 * x[:, None] + 3.0)[:, :, None] * np.ones((1, n, 1))
    u = np.abs(np.random.default_rng(1).normal(size=(n, n, 1))) + 0.5
    a3 = BurgersAdvection.factory("third_order")
    a4 = BurgersAdvection.factory("fourth_order")
    t3 = a3(1.0, 1.0, jnp.asarray(lin), jnp.asarray(u))
    t4 = a4(1.0, 1.0, jnp.asarray(lin), jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(t3[0]), np.asarray(t4[0]), atol=1e-10)


class TestVerticalFluxOracles:
    def test_upwind(self):
        rng = np.random.default_rng(2)
        w = rng.normal(size=(4, 5, 9))
        phi = rng.normal(size=(4, 5, 8))
        fl = IsentropicMinimalVerticalFlux.factory("upwind")
        out = np.asarray(fl(0.0, 1.0, jnp.asarray(w), jnp.asarray(phi)))
        wf = w[:, :, 1:-1]
        expected = wf * np.where(wf > 0.0, phi[:, :, 1:], phi[:, :, :-1])
        np.testing.assert_allclose(out, expected, atol=1e-13)

    @pytest.mark.parametrize(
        "scheme,extent",
        [("centered", 1), ("third_order_upwind", 2), ("fifth_order_upwind", 3)],
    )
    def test_shapes_and_uniform(self, scheme, extent):
        nz = 12
        w = 2.0 * jnp.ones((3, 3, nz + 1))
        phi = 5.0 * jnp.ones((3, 3, nz))
        fl = IsentropicMinimalVerticalFlux.factory(scheme)
        out = np.asarray(fl(0.0, 1.0, w, phi))
        assert out.shape == (3, 3, nz + 1 - 2 * extent)
        np.testing.assert_allclose(out, 10.0, rtol=1e-13)


def test_implicit_vertical_advection_driver_path(monkeypatch):
    """SUS driver with implicit (Crank-Nicolson) vertical advection."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import drivers.namelist_sus as nl

    importlib.reload(nl)
    monkeypatch.setattr(nl, "nx", 17)
    monkeypatch.setattr(nl, "ny", 17)
    monkeypatch.setattr(nl, "nz", 8)
    monkeypatch.setattr(nl, "implicit_vertical_advection", True)

    from drivers.driver_namelist_sus import build
    from tasmania_jax.framework.field import FieldArray

    domain, dycore, physics, state = build(nl)
    st = {k: v for k, v in state.items() if k != "time"}
    hs = jnp.zeros((17, 17), dtype=np.float32)
    st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
    st = dycore(st, {}, 5.0)
    st = physics(st, 5.0)
    u = np.asarray(st["x_velocity_at_u_locations"].data)
    assert np.isfinite(u).all()


def test_hdf5_store_names_filter(tmp_path):
    from tasmania_jax.domain import Domain
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.utils.iox import HDF5Monitor, load_hdf5_dataset

    d = Domain(
        (0.0, 1e4), 6, (0.0, 1e4), 6,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 3,
        horizontal_boundary_type="identity", nb=1,
    )
    state = {
        "time": datetime(2000, 1, 1),
        "a": FieldArray(jnp.ones((6, 6, 3)), "m", ("x", "y", "z")),
        "b": FieldArray(jnp.zeros((6, 6, 3)), "m", ("x", "y", "z")),
    }
    path = str(tmp_path / "f.h5")
    mon = HDF5Monitor(path, d, store_names=("a",))
    mon.store(state)
    mon.write()
    _, _, states = load_hdf5_dataset(path)
    assert "a" in states[0] and "b" not in states[0]
