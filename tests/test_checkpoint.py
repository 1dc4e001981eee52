"""Sharded checkpoint / resume (utils/checkpoint.py).

The reference has no checkpoint/resume beyond host-side NetCDF snapshots
(reference ``utils/iox.py:47,299``); this is the sharded path of
SURVEY.md §5.4.  Tested on the 8-virtual-device CPU mesh: per-shard save,
same-topology restore, and elastic restore onto a different sharding.
"""

from datetime import datetime

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.utils.checkpoint import CheckpointManager

DIMS3 = ("x", "y", "z")


def _state(mesh):
    rng = np.random.default_rng(7)
    sharding = NamedSharding(mesh, P("x", "y", None))
    s = jax.device_put(jnp.asarray(rng.random((16, 8, 4))), sharding)
    su = jax.device_put(jnp.asarray(rng.random((16, 8, 4))), sharding)
    return {
        "time": datetime(2000, 1, 1, 6, 30),
        "air_isentropic_density": FieldArray(s, "kg m^-2 K^-1", DIMS3),
        "x_momentum_isentropic": FieldArray(su, "kg m^-1 K^-1 s^-1", DIMS3),
    }


def test_save_restore_same_topology(tmp_path):
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("x", "y"))
    state = _state(mesh)

    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        assert mgr.save(3, state)
        mgr.wait_until_finished()
        out = mgr.restore(sharding=NamedSharding(mesh, P("x", "y", None)))

    assert out["time"] == state["time"]
    for name in ("air_isentropic_density", "x_momentum_isentropic"):
        assert out[name].units == state[name].units
        assert out[name].dims == state[name].dims
        np.testing.assert_array_equal(
            np.asarray(out[name].data), np.asarray(state[name].data)
        )
        assert out[name].data.sharding.spec == P("x", "y", None)


def test_elastic_restore_different_sharding(tmp_path):
    """A checkpoint written on a 4x2 mesh resumes on a 2x4 mesh and fully
    replicated — the elastic-recovery path."""
    mesh42 = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    state = _state(mesh42)

    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        mgr.save(0, state)
        mgr.wait_until_finished()

        mesh24 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("x", "y"))
        out = mgr.restore(sharding=NamedSharding(mesh24, P("x", "y", None)))
        np.testing.assert_array_equal(
            np.asarray(out["air_isentropic_density"].data),
            np.asarray(state["air_isentropic_density"].data),
        )
        assert out["air_isentropic_density"].data.sharding.mesh.shape == {
            "x": 2, "y": 4,
        }

        single = mgr.restore(
            sharding=NamedSharding(mesh24, P(None, None, None))
        )
        np.testing.assert_array_equal(
            np.asarray(single["x_momentum_isentropic"].data),
            np.asarray(state["x_momentum_isentropic"].data),
        )


def test_restore_without_sharding_when_devices_absent(tmp_path):
    """A checkpoint written sharded over 8 devices restores WITHOUT a
    ``sharding`` argument in a 1-device process, falling back to host-local
    numpy (the documented single-host fallback).  Runs in a subprocess so the
    save-time devices really are absent."""
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    ckdir = str(tmp_path / "ckpt")

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    state = _state(mesh)
    with CheckpointManager(ckdir) as mgr:
        mgr.save(5, state)
        mgr.wait_until_finished()

    script = f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = ""  # one device: the 8 save-time devices are absent
import sys; sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert len(jax.devices()) == 1
import numpy as np
from tasmania_jax.utils.checkpoint import CheckpointManager
with CheckpointManager({ckdir!r}) as mgr:
    out = mgr.restore()
arr = out["air_isentropic_density"].data
assert arr.shape == (16, 8, 4), arr.shape
print("OK", float(np.asarray(arr).sum()))
"""
    env = {k: v for k, v in __import__("os").environ.items()}
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env
    )
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
    total = float(res.stdout.strip().split()[-1])
    expected = float(np.asarray(state["air_isentropic_density"].data).sum())
    np.testing.assert_allclose(total, expected, rtol=1e-12)


def test_rotation_and_latest(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    state = _state(mesh)
    with CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2) as mgr:
        for step in (1, 2, 3):
            mgr.save(step, state, force=True)
        mgr.wait_until_finished()
        assert mgr.latest_step == 3
        assert set(mgr.all_steps()) == {2, 3}
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path / "empty")).restore()
