"""Coverage for the remaining isentropic pieces: temperature-based state
factory, prescribed surface heating, horizontal diffusion wrapper."""

from datetime import datetime

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic import get_isentropic_state_from_temperature
from tasmania_jax.isentropic.physics import IsentropicHorizontalDiffusion
from tasmania_jax.isentropic.physics.vertical_advection import PrescribedSurfaceHeating


@pytest.fixture(scope="module")
def domain():
    return Domain(
        (0.0, 1e5), 14, (0.0, 1e5), 12,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 8,
        horizontal_boundary_type="relaxed", nb=3,
        horizontal_boundary_kwargs={"nr": 5},
    )


def test_state_from_temperature_balance(domain):
    state = get_isentropic_state_from_temperature(
        domain.numerical_grid,
        datetime(2000, 1, 1),
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(250.0), "K", ()),
        moist=True,
    )
    p = np.asarray(state["air_pressure_on_interface_levels"].data)
    assert (np.diff(p, axis=2) > 0).all()  # pressure grows downward
    s = np.asarray(state["air_isentropic_density"].data)
    assert (s > 0).all()
    # exn = cp T / theta: temperature uniform -> T diag equals background
    t = np.asarray(state["air_temperature"].data)
    np.testing.assert_allclose(t, 250.0, rtol=1e-10)
    h = np.asarray(state["height_on_interface_levels"].data)
    assert (np.diff(h, axis=2) < 0).all()  # height decreases with k


def test_state_from_temperature_bubble(domain):
    state = get_isentropic_state_from_temperature(
        domain.numerical_grid,
        datetime(2000, 1, 1),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(250.0), "K", ()),
        bubble_center_x=FieldArray(np.asarray(5e4), "m", ()),
        bubble_center_y=FieldArray(np.asarray(5e4), "m", ()),
        bubble_center_height=FieldArray(np.asarray(5e3), "m", ()),
        bubble_radius=FieldArray(np.asarray(3e4), "m", ()),
        bubble_maximum_perturbation=FieldArray(np.asarray(5.0), "K", ()),
        moist=True,
    )
    t = np.asarray(state["air_temperature"].data)
    assert t.max() > 250.5  # warm bubble present
    assert t.min() >= 250.0 - 1e-8


def test_prescribed_surface_heating(domain):
    from tasmania_jax.isentropic import get_isentropic_state_from_brunt_vaisala_frequency

    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid,
        datetime(2000, 1, 1),
        FieldArray(np.asarray(5.0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(0.01), "s^-1", ()),
        moist=True,
    )
    heat = PrescribedSurfaceHeating(
        domain,
        tendency_of_air_potential_temperature_in_diagnostics=True,
        characteristic_length=FieldArray(np.asarray(4e4), "m", ()),
    )
    _, diags = heat(state)
    w = np.asarray(diags["tendency_of_air_potential_temperature"].data)
    assert np.isfinite(w).all()
    # heating decays upward: surface level exceeds top level in magnitude
    assert np.abs(w[7, 6, -1]) >= np.abs(w[7, 6, 0])


def test_horizontal_diffusion_wrapper(domain):
    hd = IsentropicHorizontalDiffusion(
        domain,
        diffusion_type="second_order",
        diffusion_coeff=FieldArray(np.asarray(0.5), "s^-1", ()),
        moist=True,
    )
    g = domain.numerical_grid
    shape = (g.nx, g.ny, g.nz)
    rng = np.random.default_rng(0)
    state = {
        "air_isentropic_density": FieldArray(
            jnp.asarray(50 + rng.normal(size=shape)), "kg m^-2 K^-1", ("x", "y", "z")
        ),
        "x_momentum_isentropic": FieldArray(
            jnp.asarray(rng.normal(size=shape)), "kg m^-1 K^-1 s^-1", ("x", "y", "z")
        ),
        "y_momentum_isentropic": FieldArray(
            jnp.asarray(rng.normal(size=shape)), "kg m^-1 K^-1 s^-1", ("x", "y", "z")
        ),
        "mass_fraction_of_water_vapor_in_air": FieldArray(
            jnp.asarray(rng.random(shape) * 1e-3), "g g^-1", ("x", "y", "z")
        ),
        "mass_fraction_of_cloud_liquid_water_in_air": FieldArray(
            jnp.zeros(shape), "g g^-1", ("x", "y", "z")
        ),
        "mass_fraction_of_precipitation_water_in_air": FieldArray(
            jnp.zeros(shape), "g g^-1", ("x", "y", "z")
        ),
    }
    tends, _ = hd(state)
    # zero fields produce zero tendencies, constant fields likewise
    np.testing.assert_allclose(
        np.asarray(tends["mass_fraction_of_cloud_liquid_water_in_air"].data), 0.0
    )
    # diffusion of a noisy field is non-trivial in the interior
    assert np.abs(np.asarray(tends["air_isentropic_density"].data))[3:-3, 3:-3].max() > 0


# --------------------------------------------------------------------------- #
# suite-harness coverage (tests/suites.py; VERDICT r2 item 7)                  #
# --------------------------------------------------------------------------- #

from suites import BACKENDS, ComponentTestSuite, DomainSuite  # noqa: E402
from tasmania_jax.isentropic.physics import IsentropicConservativeCoriolis  # noqa: E402


class _CoriolisSuite(ComponentTestSuite):
    def __init__(self, ds, component, f, nb):
        super().__init__(ds, component)
        self.f = f
        self.nb = nb

    def reference_call(self, raw):
        su = raw["x_momentum_isentropic"]
        sv = raw["y_momentum_isentropic"]
        nb = self.nb

        def frame_zero(a):
            out = np.zeros_like(a)
            out[nb:-nb, nb:-nb] = a[nb:-nb, nb:-nb]
            return out

        return (
            {
                "x_momentum_isentropic": frame_zero(self.f * sv),
                "y_momentum_isentropic": frame_zero(-self.f * su),
            },
            {},
        )


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("with_out", [False, True])
def test_coriolis_suite(backend, with_out):
    ds = DomainSuite(np.random.default_rng(6), nb=2, backend=backend)
    f = 7.3e-5
    comp = IsentropicConservativeCoriolis(
        ds.domain, "numerical", coriolis_parameter=f
    )
    suite = _CoriolisSuite(ds, comp, f, nb=2)
    suite.run_tendency(with_out=with_out)
