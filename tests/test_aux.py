"""Auxiliary-subsystem tests: state transpose, timer CSV, checkify validation."""

import os
import tempfile
from datetime import datetime

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.validation import assert_all_finite, checked
from tasmania_jax.utils.storage import (
    deepcopy_state,
    get_numerical_state,
    get_physical_state,
)
from tasmania_jax.utils.timer import Timer


def make_domain():
    return Domain(
        (0.0, 1e4), 10, (0.0, 1e4), 8,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 4,
        horizontal_boundary_type="periodic", nb=2,
    )


def test_state_transpose_roundtrip():
    d = make_domain()
    rng = np.random.default_rng(0)
    state = {
        "time": datetime(2000, 1, 1),
        "phi": FieldArray(jnp.asarray(rng.normal(size=(10, 8, 4))), "m", ("x", "y", "z")),
    }
    num = get_numerical_state(d, state)
    assert num["phi"].data.shape == (14, 12, 4)
    back = get_physical_state(d, num)
    np.testing.assert_allclose(np.asarray(back["phi"].data), np.asarray(state["phi"].data))
    assert back["time"] == state["time"]


def test_deepcopy_state():
    state = {"phi": FieldArray(jnp.ones((3, 3)), "m", ("x", "y"))}
    cp = deepcopy_state(state)
    assert isinstance(cp["phi"].data, np.ndarray)
    np.testing.assert_allclose(cp["phi"].data, 1.0)


def test_timer_csv():
    Timer.reset()
    Timer.enabled = True
    with Timer.timing("outer"):
        with Timer.timing("inner"):
            pass
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.csv")
        Timer.to_csv(path, run_label="test")
        lines = open(path).read().strip().splitlines()
        assert lines[0].startswith("run,")
        assert any("outer/inner" in ln for ln in lines)
    Timer.enabled = False


def test_checked_catches_nan():
    def f(x):
        return jnp.log(x)  # NaN for negative input

    g = checked(jax.jit(f))
    np.testing.assert_allclose(np.asarray(g(jnp.asarray(2.0))), np.log(2.0))
    with pytest.raises(Exception):
        g(jnp.asarray(-1.0))


def test_assert_all_finite():
    assert_all_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        assert_all_finite({"a": jnp.asarray([1.0, np.nan])}, names=["a"])
