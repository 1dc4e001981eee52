"""Tests for tasmania_jax.utils.jitx (jaxpr read-set analysis)."""

import jax.numpy as jnp
import numpy as np

from tasmania_jax.utils.jitx import carry_read_set


def test_carry_read_set_basic():
    state = {
        "a": jnp.ones((4, 4)),
        "b": jnp.ones((4, 4)),
        "c": jnp.ones((4, 4)),
    }

    def step(st):
        return {"a": st["a"] + 1.0, "b": st["a"] * 2.0, "c": jnp.zeros((4, 4))}

    read = carry_read_set(step, state)
    assert read == {"a"}


def test_carry_read_set_passthrough_counts_as_read():
    state = {"a": jnp.ones(3), "b": jnp.ones(3)}

    def step(st):
        return {"a": st["a"], "b": jnp.zeros(3)}

    # identity passthrough must be carried (its value survives the loop)
    assert "a" in carry_read_set(step, state)


def test_carry_read_set_use_inside_control_flow():
    import jax

    state = {"a": jnp.ones(3), "b": jnp.ones(3), "c": jnp.ones(3)}

    def step(st):
        out = jax.lax.fori_loop(0, 3, lambda i, x: x + st["b"], st["a"] * 0.0)
        return {"a": out, "b": st["b"] + 1.0, "c": jnp.zeros(3)}

    read = carry_read_set(step, state)
    assert "b" in read and "a" in read and "c" not in read


def test_carry_read_set_extra_args():
    state = {"a": jnp.ones(3), "b": jnp.ones(3)}

    def step(st, scale):
        return {"a": st["a"] * scale, "b": jnp.zeros(3)}

    read = carry_read_set(step, state, np.float32(2.0))
    assert read == {"a"}
