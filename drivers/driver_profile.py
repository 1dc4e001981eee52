"""Leave-one-out profiler for the flagship SUS benchmark.

Times the fused-loop benchmark with individual physics processes (or the
whole dycore / whole physics chain) removed, to attribute the per-step cost.

Usage: ``python drivers/driver_profile.py [--variants full,dycore_only,...]``
Prints one line per variant: ``variant  ms/step  (delta vs full)``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

VARIANTS = {
    # name -> (skip set, kwargs)
    "full": (set(), {}),
    "dycore_only": (
        {
            "diagnostics", "coriolis", "smoothing", "smagorinsky",
            "velocities", "kessler", "satadj", "vertical_advection",
            "sedimentation", "precipitation",
        },
        {},
    ),
    "physics_only": (set(), {"no_dycore": True}),
    "no_vertical_advection": ({"vertical_advection"}, {}),
    "no_smoothing": ({"smoothing"}, {}),
    "no_diagnostics": ({"diagnostics"}, {}),
    "no_sedimentation": ({"sedimentation"}, {}),
    "no_smagorinsky": ({"smagorinsky"}, {}),
    "no_velocities": ({"velocities"}, {}),
    "no_pointwise": ({"kessler", "satadj", "precipitation", "coriolis"}, {}),
    "no_damp": (set(), {"damp": False}),
}


def run_variant(name, skip, kwargs, nt, backend):
    import importlib

    import jax
    import jax.numpy as jnp

    import drivers.namelist_sus as nl
    importlib.reload(nl)

    from drivers.driver_namelist_sus import build_domain_and_state, build_model
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.utils.jitx import carry_read_set

    nl.backend = backend
    if "damp" in kwargs:
        nl.damp = kwargs["damp"]

    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip=skip)
    cgrid = domain.numerical_grid
    dt_s = nl.timestep.total_seconds()

    hs_steady = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()

    field_names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in field_names}
    dims = {k: state[k].dims for k in field_names}
    no_dycore = kwargs.get("no_dycore", False)

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        if not no_dycore:
            st = dycore(st, {}, dt_s)
        st = physics(st, dt_s)
        return {k: st[k].data for k in field_names}

    fields = {k: jnp.array(state[k].data) for k in field_names}
    read = carry_read_set(step, fields, hs_steady)
    dead = {k: jnp.zeros_like(v) for k, v in fields.items() if k not in read}

    def run_all(carry, hs, n):
        def body(i, carry):
            fact = jnp.minimum((i + 1.0) * dt_s / topo_time, 1.0)
            out = step({**dead, **carry}, fact * hs)
            return {k: out[k] for k in carry}
        return jax.lax.fori_loop(0, n, body, carry)

    run_all_c = jax.jit(run_all, donate_argnums=(0,))
    carry0 = {k: v for k, v in fields.items() if k in read}

    out = jax.block_until_ready(run_all_c(dict(carry0), hs_steady * 0.0, 1))
    carry0 = {k: out[k] for k in carry0}

    t0 = time.perf_counter()
    jax.block_until_ready(run_all_c(dict(carry0), hs_steady, nt))
    elapsed = time.perf_counter() - t0
    return elapsed / nt * 1e3  # ms/step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--backend", type=str, default="jax")
    cli = ap.parse_args()

    from tasmania_jax.utils.device import configure_compile_cache, require_gpu

    configure_compile_cache()
    require_gpu()

    results = {}
    for name in cli.variants.split(","):
        skip, kwargs = VARIANTS[name]
        ms = run_variant(name, skip, kwargs, cli.niter, cli.backend)
        results[name] = ms
        base = results.get("full")
        delta = f"  (full - this = {base - ms:+.3f} ms)" if base and name != "full" else ""
        print(f"{name:24s} {ms:8.3f} ms/step{delta}", flush=True)


if __name__ == "__main__":
    main()
