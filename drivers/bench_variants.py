"""Bench ALL SIX coupling variants on the GPU.

The reference's benchmark suite is six drivers
(reference ``drivers/benchmarking/isentropic_moist/driver_namelist_*.py``);
this driver produces the matching table: gridpoints/s for
fc/lfc/ps/sts/sus/ssus at the flagship grid.

Timing = ONE in-jit ``fori_loop`` over steps (the per-step topography-growth
factor is computed in-trace from the loop index, so no per-step dispatch and
no retrace), slope-based (t(2n) - t(n)) so fixed per-call costs cancel.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

VARIANTS = ("fc", "lfc", "ps", "sts", "sus", "ssus")


def bench_variant(coupling: str, nt: int, backend: str = "jax"):
    import jax
    import jax.numpy as jnp

    from drivers.driver_isentropic_moist import build_variant
    from tasmania_jax.framework.field import FieldArray

    nl = importlib.import_module(f"drivers.namelist_{coupling}")
    importlib.reload(nl)
    nl.backend = backend

    domain, state, step_impl = build_variant(nl, coupling)
    cgrid = domain.numerical_grid
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    hs_steady = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )

    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = step_impl(st, dt_s)
        return {k: st[k].data for k in names}

    def loop(fields, n):
        def body(i, f):
            fact = jnp.minimum((i + 1.0) * dt_s / topo_time, 1.0)
            return step(f, fact * hs_steady)

        return jax.lax.fori_loop(0, n, body, fields)

    loop_c = jax.jit(loop, static_argnums=(1,))
    fields0 = {k: jnp.asarray(state[k].data) for k in names}

    def run(n):
        t0 = time.perf_counter()
        jax.block_until_ready(loop_c(dict(fields0), n))
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    run(nt)
    run(2 * nt)
    compile_s = time.perf_counter() - t0
    t1 = min(run(nt), run(nt))
    t2 = min(run(2 * nt), run(2 * nt))
    ms_per_step = max(t2 - t1, 1e-9) / nt * 1e3

    # validation quantities at nt steps (reference drivers print umax/vmax)
    final = loop_c(dict(fields0), nt)
    u = np.asarray(final["x_velocity_at_u_locations"])
    v = np.asarray(final["y_velocity_at_v_locations"])
    gps = cgrid.nx * cgrid.ny * cgrid.nz / (ms_per_step * 1e-3)
    return {
        "ms_per_step": round(ms_per_step, 3),
        "gridpoints_per_s": float(f"{gps:.4g}"),
        "umax": round(float(u[:, :-1].max()), 5),
        "vmax": round(float(v[:-1, :].max()), 5),
        "compile_warm_s": round(compile_s, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--backend", type=str, default="jax")
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    cli = ap.parse_args()

    from tasmania_jax.utils.device import configure_compile_cache, require_gpu

    configure_compile_cache()
    dev = require_gpu()
    print(f"coupling-variant bench on {dev['platform']} ({dev['kind']})")
    for var in cli.variants.split(","):
        print(json.dumps({var: bench_variant(var, cli.nt, cli.backend)}), flush=True)


if __name__ == "__main__":
    main()
