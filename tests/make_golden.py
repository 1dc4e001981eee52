"""Generate the committed golden trajectory (tests/baseline_datasets/).

Freezes a float64 run of the flagship configuration — moist isentropic core,
rk3ws_si + fifth_order_upwind, relaxed BCs, full SUS physics chain — at a
reduced grid (33x33x16, dt=5 s, 50 steps, growing Gaussian mountain), the
role the reference's ``tests/baseline_datasets/isentropic.nc`` plays
(reference ``tests/conftest.py:36``): a frozen oracle that locks the numerics
forward across refactors.

Run manually to (re)generate — any change to the committed file must be
justified as an intentional numerics change:

    JAX_PLATFORMS=cpu python tests/make_golden.py

With ``--drift`` it additionally measures float32-vs-float64 trajectory
divergence over 100 steps at this configuration.
"""

import argparse
import importlib
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

GOLDEN = REPO / "tests" / "baseline_datasets" / "isentropic_golden.h5"
NX, NY, NZ, NSTEPS, SNAP_EVERY = 33, 33, 16, 50, 25


def run(dtype, nsteps):
    import jax

    jax.config.update("jax_platforms", "cpu")
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import drivers.namelist_sus as nl
    from drivers.driver_namelist_sus import make_step, mountain_fraction
    from tasmania_jax.framework.options import StorageOptions

    importlib.reload(nl)
    nl.nx, nl.ny, nl.nz = NX, NY, NZ
    nl.so = StorageOptions(dtype=dtype)

    domain, state, step = make_step(nl)
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    step_c = jax.jit(step)
    hs = jnp.asarray(
        np.asarray(
            domain.numerical_grid.topography.steady_profile.to_units("m").data
        ),
        dtype=dtype,
    )
    fields = {k: jnp.asarray(state[k].data) for k in names}
    snaps = {}
    for i in range(nsteps):
        fields = step_c(dict(fields), mountain_fraction(nl, i + 1) * hs)
        if (i + 1) % SNAP_EVERY == 0:
            snaps[i + 1] = {k: np.asarray(v) for k, v in fields.items()}
    return domain, state, snaps, units, dims


def write_golden():
    from datetime import timedelta

    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.utils.iox import HDF5Monitor

    domain, state, snaps, units, dims = run(np.float64, NSTEPS)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    mon = HDF5Monitor(str(GOLDEN), domain=domain)
    for istep in sorted(snaps):
        snap = {
            k: FieldArray(v, units[k], dims[k]) for k, v in snaps[istep].items()
        }
        snap["time"] = state["time"] + timedelta(seconds=5.0 * istep)
        mon.store(snap)
    mon.write()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size / 1e6:.1f} MB)")


def _run_one_subprocess(dtype_name: str, nsteps: int, out_npz: str):
    """Run in a fresh process so the x64 flag doesn't leak between runs."""
    import subprocess

    code = f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import sys; sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(REPO / 'tests')!r})
import numpy as np
import make_golden
_, _, snaps, *_ = make_golden.run(np.{dtype_name}, {nsteps})
np.savez({out_npz!r}, **{{
    f"{{k}}@{{i}}": v for i, snap in snaps.items() for k, v in snap.items()
}})
"""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env
    )
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-2000:])
    data = np.load(out_npz)
    snaps = {}
    for key in data.files:
        k, i = key.rsplit("@", 1)
        snaps.setdefault(int(i), {})[k] = data[key]
    return snaps


def measure_drift():
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        snaps64 = _run_one_subprocess("float64", 100, os.path.join(td, "f64.npz"))
        snaps32 = _run_one_subprocess("float32", 100, os.path.join(td, "f32.npz"))
    table = {}
    for istep in sorted(snaps64):
        row = {}
        for k in (
            "air_isentropic_density",
            "x_momentum_isentropic",
            "y_momentum_isentropic",
            "mass_fraction_of_water_vapor_in_air",
            "x_velocity_at_u_locations",
        ):
            a = snaps64[istep][k]
            b = snaps32[istep][k].astype(np.float64)
            scale = np.max(np.abs(a)) or 1.0
            row[k] = float(np.max(np.abs(a - b)) / scale)
        table[f"step_{istep}"] = row
    print(json.dumps(table, indent=1))
    return table


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--drift", action="store_true")
    args = p.parse_args()
    if args.drift:
        measure_drift()
    else:
        write_golden()
