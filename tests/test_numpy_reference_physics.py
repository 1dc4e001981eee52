"""Physics processes and column diagnostics on the jax backend against the
numpy backend, the plain reference that does not go through XLA.

Each case builds the same components and the same float64 state on both
backends and runs the stepper the SUS chain runs them under; the grids are
the ones the removed hand-written kernels were checked over (flux schemes,
smoothing orders, diagnostics modes, sedimentation schemes, the Smagorinsky
and Kessler RK2 chains, drawn shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.steppers import TendencyStepper
from tasmania_jax.isentropic import get_isentropic_state_from_brunt_vaisala_frequency
from tasmania_jax.isentropic.dynamics.diagnostics import IsentropicDiagnostics

DIMS = ("x", "y", "z")
DIMS_I = ("x", "y", "z_on_interface_levels")
MFWV = "mass_fraction_of_water_vapor_in_air"
MFCW = "mass_fraction_of_cloud_liquid_water_in_air"
MFPW = "mass_fraction_of_precipitation_water_in_air"
PT = 2000.0


def setup(backend, nx=13, ny=11, nz=9, seed=3):
    """Domain + moist state (density and momenta perturbed by 0.1 % noise)
    with the column diagnostics, a θ-tendency and some cloud and rain,
    identical values on either backend."""
    xp = np if backend == "numpy" else jnp
    domain = Domain(
        (0.0, 1e5), nx, (0.0, 1e5), ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="identity", nb=3,
        topography_type="gaussian",
        topography_kwargs={
            "max_height": FieldArray(np.array(500.0), "m", ()),
            "width_x": FieldArray(np.array(2.5e4), "m", ()),
            "width_y": FieldArray(np.array(2.5e4), "m", ()),
        },
        backend=backend,
    )
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid, None, FieldArray(np.array(10.0), "m s^-1", ()),
        FieldArray(np.array(2.0), "m s^-1", ()),
        FieldArray(np.array(0.01), "s^-1", ()), moist=True, backend=backend,
    )
    state.pop("time", None)
    rng = np.random.default_rng(seed)
    for name in ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic"):
        f = state[name]
        noisy = np.asarray(f.data) * (1.0 + 1e-3 * rng.standard_normal(f.data.shape))
        state[name] = FieldArray(xp.asarray(noisy), f.units, f.dims)
    dd = IsentropicDiagnostics(domain.numerical_grid, backend="numpy")
    s = np.asarray(state["air_isentropic_density"].data)
    p, exn, _, h, rho, t = dd.get_diagnostic_variables(s, PT, moist=True)
    extra = {
        "air_density": (rho, "kg m^-3", DIMS),
        "air_temperature": (t, "K", DIMS),
        "air_pressure_on_interface_levels": (p, "Pa", DIMS_I),
        "exner_function_on_interface_levels": (exn, "J K^-1 kg^-1", DIMS_I),
        "height_on_interface_levels": (h, "m", DIMS_I),
        MFCW: (2e-3 * rng.random(s.shape), "g g^-1", DIMS),
        MFPW: (1e-3 * rng.random(s.shape), "g g^-1", DIMS),
        "tendency_of_air_potential_temperature": (
            1e-2 * rng.standard_normal(s.shape), "K s^-1", DIMS,
        ),
    }
    for name, (arr, units, dims) in extra.items():
        state[name] = FieldArray(xp.asarray(arr), units, dims)
    return domain, state


def assert_close(ref, out, rel=1e-10):
    assert set(ref) == set(out)
    for name in ref:
        if name == "time":
            continue
        a = np.asarray(ref[name].data if hasattr(ref[name], "data") else ref[name])
        b = np.asarray(out[name].data if hasattr(out[name], "data") else out[name])
        scale = np.abs(a).max() or 1.0
        assert np.abs(a - b).max() <= rel * scale, (
            f"{name}: {np.abs(a - b).max() / scale:.3e} of the field max"
        )


def step_both(make_stepper, dt=7.0, **setup_kw):
    """(diagnostics, outputs) of one step on numpy and on jax."""
    res = []
    for backend in ("numpy", "jax"):
        domain, state = setup(backend, **setup_kw)
        res.append(make_stepper(domain, backend)(state, dt))
    (d_np, o_np), (d_jx, o_jx) = res
    assert isinstance(next(iter(o_np.values())).data, np.ndarray)
    assert_close(o_np, o_jx)
    assert_close(d_np, d_jx)


def vertical_advection(scheme, moist):
    from tasmania_jax.isentropic.physics import IsentropicVerticalAdvection

    def make(domain, backend):
        va = IsentropicVerticalAdvection(
            domain, flux_scheme=scheme, moist=moist, backend=backend
        )
        return TendencyStepper.factory("rk3ws", va, backend=backend)

    return make


@pytest.mark.parametrize("moist", [False, True])
@pytest.mark.parametrize(
    "scheme", ["upwind", "centered", "third_order_upwind", "fifth_order_upwind"]
)
def test_vertical_advection_rk3ws_matches_numpy(scheme, moist):
    step_both(vertical_advection(scheme, moist))


@settings(max_examples=4, deadline=None)
@given(
    nx=st.integers(7, 20), ny=st.integers(7, 20), nz=st.integers(7, 14),
    moist=st.booleans(), seed=st.integers(0, 2**16),
)
def test_vertical_advection_drawn_shapes(nx, ny, nz, moist, seed):
    step_both(
        vertical_advection("third_order_upwind", moist),
        nx=nx, ny=ny, nz=nz, seed=seed,
    )


def smoothing(order, moist):
    from tasmania_jax.isentropic.physics import IsentropicHorizontalSmoothing

    def make(domain, backend):
        comp = IsentropicHorizontalSmoothing(
            domain, order, 0.7, 1.0, 2, moist=moist, smooth_moist_coeff=0.3,
            backend=backend,
        )
        return lambda state, dt: ({}, comp(state))

    return make


@pytest.mark.parametrize("moist", [False, True])
@pytest.mark.parametrize("order", ["first_order", "second_order", "third_order"])
def test_horizontal_smoothing_matches_numpy(order, moist):
    step_both(smoothing(order, moist))


@settings(max_examples=4, deadline=None)
@given(
    nx=st.integers(7, 24), ny=st.integers(7, 24), nz=st.integers(2, 8),
    order=st.sampled_from(["first_order", "second_order", "third_order"]),
)
def test_horizontal_smoothing_drawn_shapes(nx, ny, nz, order):
    step_both(smoothing(order, True), nx=nx, ny=ny, nz=nz)


@pytest.mark.parametrize("mode", ["mtg", "dry", "moist"])
def test_column_diagnostics_match_numpy(mode):
    outs = []
    for backend, xp in (("numpy", np), ("jax", jnp)):
        domain, state = setup(backend)
        dd = IsentropicDiagnostics(domain.numerical_grid, backend=backend)
        s = xp.asarray(state["air_isentropic_density"].data)
        if mode == "mtg":
            outs.append((dd.get_montgomery_potential(s, PT),))
        else:
            outs.append(dd.get_diagnostic_variables(s, PT, moist=mode == "moist"))
    assert len(outs[0]) == len(outs[1]) == {"mtg": 1, "dry": 4, "moist": 6}[mode]
    assert_close(dict(enumerate(outs[0])), dict(enumerate(outs[1])))


@pytest.mark.parametrize("scheme", ["first_order_upwind", "second_order_upwind"])
def test_sedimentation_rk3ws_matches_numpy(scheme):
    from tasmania_jax.physics import KesslerFallVelocity, KesslerSedimentation

    def make(domain, backend):
        fv = KesslerFallVelocity(domain, "numerical", backend=backend)
        sd = KesslerSedimentation(
            domain, "numerical", sedimentation_flux_scheme=scheme, backend=backend
        )
        return TendencyStepper.factory(
            "rk3ws", fv, sd, execution_policy="serial", backend=backend
        )

    step_both(make)


def test_smagorinsky_rk2_matches_numpy():
    from tasmania_jax.isentropic.physics import IsentropicSmagorinsky

    def make(domain, backend):
        return TendencyStepper.factory(
            "rk2", IsentropicSmagorinsky(domain, 0.18, backend=backend),
            backend=backend,
        )

    step_both(make)


def test_kessler_rk2_chain_matches_numpy():
    from tasmania_jax.isentropic.utils import AirPotentialTemperatureToDiagnostic
    from tasmania_jax.physics import KesslerMicrophysics

    def make(domain, backend):
        ke = KesslerMicrophysics(
            domain, "numerical", air_pressure_on_interface_levels=True,
            tendency_of_air_potential_temperature_in_diagnostics=False,
            rain_evaporation=True, backend=backend,
        )
        t2d = AirPotentialTemperatureToDiagnostic(domain, "numerical", backend=backend)
        return TendencyStepper.factory(
            "rk2", ke, t2d, execution_policy="serial", backend=backend
        )

    step_both(make)


def test_saturation_adjustment_rk2_chain_matches_numpy():
    from tasmania_jax.isentropic.utils import (
        AirPotentialTemperatureToDiagnostic,
        AirPotentialTemperatureToTendency,
    )
    from tasmania_jax.physics import KesslerSaturationAdjustmentPrognostic

    def make(domain, backend):
        d2t = AirPotentialTemperatureToTendency(domain, "numerical", backend=backend)
        sa = KesslerSaturationAdjustmentPrognostic(
            domain, "numerical", air_pressure_on_interface_levels=True,
            saturation_rate=0.3, backend=backend,
        )
        t2d = AirPotentialTemperatureToDiagnostic(domain, "numerical", backend=backend)
        return TendencyStepper.factory(
            "rk2", d2t, sa, t2d, execution_policy="serial", backend=backend
        )

    step_both(make)
