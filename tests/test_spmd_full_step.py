"""GSPMD distribution of the WHOLE dycore+physics timestep.

The "pick a mesh, annotate shardings, let XLA insert collectives" path
(``drivers/driver_namelist_sus.py --spmd``): input fields block-sharded
``P('x', 'y', None)`` over the 8-device virtual mesh, the partitioner
inserts all halo communication.  Must be *bitwise* identical to the
unsharded run — a partitioned program is the same math.

Regression context: XLA's scatter partitioner silently dropped the
cross-shard row when the staggered velocities were built via
``zeros.at[1:-1].set(u_in)`` (the stale value — zero — survived at the
shard-boundary face).  ``HorizontalVelocity.get_velocity_components``
now builds staggered arrays by concatenation, which partitions exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tasmania_jax.parallel import make_mesh


@pytest.fixture(scope="module")
def sus_setup():
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import drivers.namelist_sus as nl

    importlib.reload(nl)
    nl.nx = nl.ny = 32
    nl.nz = 8

    from drivers.driver_namelist_sus import make_step

    _, state, step = make_step(nl)
    names = sorted(k for k in state if k != "time")

    fields = {k: state[k].data for k in names}
    hs = jnp.zeros((32, 32), dtype=np.float32)
    return step, fields, hs, names


def test_spmd_full_sus_step_bitwise(sus_setup):
    from drivers.driver_namelist_sus import spmd_sharding

    step, fields, hs, names = sus_setup
    mesh = make_mesh(jax.devices()[:8])

    plain = jax.jit(step)(dict(fields), hs)
    plain = jax.jit(step)(plain, hs)

    fsh = {k: jax.device_put(v, spmd_sharding(v, mesh)) for k, v in fields.items()}
    hssh = jax.device_put(hs, NamedSharding(mesh, P("x", "y")))
    spmd = jax.jit(step)(fsh, hssh)
    spmd = jax.jit(step)(spmd, hssh)

    for k in names:
        a, b = np.asarray(plain[k]), np.asarray(spmd[k])
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the outputs really are distributed
    s = spmd["air_isentropic_density"]
    assert len(s.sharding.device_set) == 8


def test_staggered_diagnosis_partitions_exactly():
    """The minimal shape of the old bug: diagnose staggered u from sharded
    density+momentum, consume through a product stencil."""
    from tasmania_jax.dwarfs.diagnostics import HorizontalVelocity

    mesh = make_mesh(jax.devices()[:8])
    sh3 = NamedSharding(mesh, P("x", "y", None))
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.normal(size=(32, 32, 8)) + 10.0)
    du = jnp.asarray(rng.normal(size=(32, 32, 8)))
    dv = jnp.asarray(rng.normal(size=(32, 32, 8)))

    class G:
        nx, ny, nz = 32, 32, 8

    hv = HorizontalVelocity.__new__(HorizontalVelocity)
    hv._staggering = True

    def f(d, du, dv):
        u, v = hv.get_velocity_components(d, du, dv)
        return u[:-1] * u[1:] + v[:, :-1] * v[:, 1:]

    a = np.asarray(jax.jit(f)(d, du, dv))
    b = np.asarray(
        jax.jit(f)(
            jax.device_put(d, sh3), jax.device_put(du, sh3), jax.device_put(dv, sh3)
        )
    )
    np.testing.assert_array_equal(a, b)
