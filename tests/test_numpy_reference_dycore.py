"""The dynamical core and the coupled model on the jax backend against the
numpy backend, the plain reference that does not go through XLA.

Both run in float64 here, so they agree to rounding; every grid the removed
hand-written stage kernels were once checked over (moist/dry, damped or not,
both upwind orders, ragged sizes, dycore tendencies, drawn shapes) is now a
jax-vs-numpy case, and each of the six coupling variants is one more.
"""

import importlib
import sys
from datetime import datetime, timedelta
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic import (
    IsentropicDynamicalCore,
    get_isentropic_state_from_brunt_vaisala_frequency,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MOIST = (
    "mass_fraction_of_water_vapor_in_air",
    "mass_fraction_of_cloud_liquid_water_in_air",
    "mass_fraction_of_precipitation_water_in_air",
)
DRY = (
    "air_isentropic_density",
    "x_momentum_isentropic",
    "y_momentum_isentropic",
    "x_velocity_at_u_locations",
    "y_velocity_at_v_locations",
)


def build(backend, *, nx=20, ny=None, nz=8, moist=False, damp=True,
          scheme="third_order_upwind", eps=0.5):
    domain = Domain(
        (0.0, 1e5), nx, (0.0, 1e5), ny or nx,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=3,
        horizontal_boundary_kwargs={"nr": 6},
        topography_type="gaussian",
        topography_kwargs={
            "max_height": FieldArray(np.asarray(120.0), "m", ()),
            "width_x": FieldArray(np.asarray(2e4), "m", ()),
            "width_y": FieldArray(np.asarray(2e4), "m", ()),
        },
        backend=backend,
    )
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid, datetime(2000, 1, 1),
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(1.0), "m s^-1", ()),
        FieldArray(np.asarray(0.01), "s^-1", ()),
        moist=moist, backend=backend,
    )
    domain.horizontal_boundary.reference_state = state
    pt = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    core = IsentropicDynamicalCore(
        domain, moist=moist,
        time_integration_scheme="rk3ws_si",
        horizontal_flux_scheme=scheme,
        time_integration_properties={"pt": pt, "eps": eps},
        damp=damp, damp_depth=3, smooth=False,
        backend=backend,
    )
    return core, state


def tendencies(backend, state, moist, seed=0):
    """Small random dycore tendencies on the momenta (and water vapour)."""
    xp = np if backend == "numpy" else jnp
    rng = np.random.default_rng(seed)
    shape = np.asarray(state["air_isentropic_density"].data).shape
    dims = ("x", "y", "z")
    out = {
        "x_momentum_isentropic": FieldArray(
            xp.asarray(rng.normal(scale=1e-3, size=shape)),
            "kg m^-1 K^-1 s^-2", dims,
        ),
        "y_momentum_isentropic": FieldArray(
            xp.asarray(rng.normal(scale=1e-3, size=shape)),
            "kg m^-1 K^-1 s^-2", dims,
        ),
    }
    if moist:
        out[MOIST[0]] = FieldArray(
            xp.asarray(rng.normal(scale=1e-8, size=shape)), "g g^-1 s^-1", dims
        )
    return out


def assert_close(ref, out, names, rel=1e-10):
    for name in names:
        a = np.asarray(ref[name].data if hasattr(ref[name], "data") else ref[name])
        b = np.asarray(out[name].data if hasattr(out[name], "data") else out[name])
        assert a.shape == b.shape, name
        scale = np.abs(a).max() or 1.0
        assert np.abs(a - b).max() <= rel * scale, (
            f"{name}: {np.abs(a - b).max() / scale:.3e} of the field max"
        )


def run_both(nsteps=2, with_tendencies=False, **kw):
    res = {}
    for backend in ("numpy", "jax"):
        core, state = build(backend, **kw)
        tnd = tendencies(backend, state, kw.get("moist", False)) if with_tendencies else {}
        cur = dict(state)
        for _ in range(nsteps):
            cur = core(cur, tnd, timedelta(seconds=10))
        res[backend] = cur
    assert isinstance(res["numpy"]["air_isentropic_density"].data, np.ndarray)
    names = DRY + (MOIST if kw.get("moist") else ())
    assert_close(res["numpy"], res["jax"], names)


@pytest.mark.parametrize("scheme", ["third_order_upwind", "fifth_order_upwind"])
@pytest.mark.parametrize("moist,damp", [
    (False, False), (False, True), (True, False), (True, True),
])
def test_rk3ws_si_stage_matches_numpy(moist, damp, scheme):
    run_both(moist=moist, damp=damp, scheme=scheme)


@pytest.mark.parametrize("nx", [25, 33])
def test_rk3ws_si_stage_ragged_sizes(nx):
    run_both(nx=nx, ny=19, moist=True, damp=True, scheme="fifth_order_upwind")


@pytest.mark.parametrize("moist", [False, True])
def test_rk3ws_si_stage_with_tendencies(moist):
    run_both(moist=moist, damp=True, with_tendencies=True)


@settings(max_examples=4, deadline=None)
@given(
    nx=st.integers(13, 24), ny=st.integers(13, 24), nz=st.integers(2, 8),
    eps=st.floats(0.0, 1.0), moist=st.booleans(),
)
def test_rk3ws_si_stage_drawn_shapes(nx, ny, nz, eps, moist):
    run_both(nsteps=1, nx=nx, ny=ny, nz=nz, eps=eps, moist=moist)


# --------------------------------------------------------------------------- #
# the six upstream coupling variants, whole step                               #
# --------------------------------------------------------------------------- #


def _variant_fields(coupling, backend, nsteps=2):
    import drivers.namelist_sus as nl
    from drivers.driver_isentropic_moist import build_variant
    from tasmania_jax.framework.options import StorageOptions

    importlib.reload(nl)
    nl.nx = nl.ny = 17
    nl.nz = 8
    nl.backend = backend
    nl.so = StorageOptions(dtype=np.float64)
    if coupling in ("fc", "lfc"):
        nl.physics_time_integration_scheme = None
    domain, state, step_impl = build_variant(nl, coupling)
    xp = np if backend == "numpy" else jnp
    hs = xp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.data)
    )
    st_ = {k: v for k, v in state.items() if k != "time"}
    for i in range(nsteps):
        st_["topography_height"] = FieldArray(0.01 * (i + 1) * hs, "m", ("x", "y"))
        st_ = step_impl(st_, 5.0)
    return st_


@pytest.mark.parametrize("coupling", ["fc", "lfc", "ps", "sts", "sus", "ssus"])
def test_coupling_variant_matches_numpy(coupling):
    ref = _variant_fields(coupling, "numpy")
    out = _variant_fields(coupling, "jax")
    assert isinstance(ref["air_isentropic_density"].data, np.ndarray)
    assert_close(ref, out, DRY + MOIST)
