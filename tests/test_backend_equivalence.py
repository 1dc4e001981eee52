"""Backend equivalence: the whole dry dycore on numpy arrays vs jax arrays.

The reference's central test axis is numpy-vs-gt4py backend agreement
(SURVEY.md §4); here the namespace-dispatched kernels make the full model
runnable on host numpy, which must match the jax path bitwise-tolerantly.
"""

from datetime import datetime, timedelta

import numpy as np
import pytest

import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic import (
    IsentropicDynamicalCore,
    get_isentropic_state_from_brunt_vaisala_frequency,
)


def build(backend):
    domain = Domain(
        (0.0, 1e5), 20, (0.0, 1e5), 20,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 8,
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
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(0.01), "s^-1", ()),
        backend=backend,
    )
    domain.horizontal_boundary.reference_state = state
    pt = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    core = IsentropicDynamicalCore(
        domain, moist=False,
        time_integration_scheme="rk3ws_si",
        horizontal_flux_scheme="third_order_upwind",
        time_integration_properties={"pt": pt, "eps": 0.5},
        damp=True, damp_depth=3, smooth=False,
        backend=backend,
    )
    return core, state


def test_numpy_backend_matches_jax():
    core_np, state_np = build("numpy")
    core_jx, state_jx = build("jax")
    assert isinstance(state_np["air_isentropic_density"].data, np.ndarray)

    cur_np, cur_jx = dict(state_np), dict(state_jx)
    for _ in range(3):
        cur_np = core_np(cur_np, {}, timedelta(seconds=10))
        cur_jx = core_jx(cur_jx, {}, timedelta(seconds=10))

    for name in ("air_isentropic_density", "x_momentum_isentropic",
                 "x_velocity_at_u_locations"):
        a = np.asarray(cur_np[name].data)
        b = np.asarray(cur_jx[name].data)
        np.testing.assert_allclose(a, b, rtol=1e-10, err_msg=name)
    # the numpy path really stayed on numpy
    assert isinstance(cur_np["air_isentropic_density"].data, np.ndarray)


@pytest.mark.parametrize("backend", ["pallas", "pallas:interpret", "gt4py"])
def test_unknown_backend_is_refused(backend):
    """Only the jax path and its numpy reference exist."""
    with pytest.raises(ValueError, match="unknown backend"):
        build(backend)
