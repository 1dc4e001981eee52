"""DistributedModel parity bench.

Times the flagship SUS benchmark THROUGH the DistributedModel wrapper on a
real-device mesh — the same fused-loop methodology as the official bench
(``driver_namelist_sus.py --fused-loop``: one jitted fori_loop, dead-field
carry elision, ``block_until_ready`` completion).  On a ``1,1`` mesh the
wrapper binds the components to the original domain (the exact single-device
program inside a trivial shard_map), so the result must match ``bench.py`` to
~measurement noise.

Usage: ``python drivers/driver_dist_bench.py [--mesh 1,1] [--niter 100]
[--nx N --nz N]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", type=str, default="1,1")
    p.add_argument("--backend", type=str, default="jax")
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--platform", type=str, default=None)
    p.add_argument("--virtual", type=int, default=None,
                   help="force N virtual CPU devices (testing)")
    cli = p.parse_args(argv)

    if cli.virtual:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cli.virtual}"
        ).strip()
        cli.platform = "cpu"

    import jax

    from tasmania_jax.utils.device import configure_compile_cache

    configure_compile_cache()
    if cli.platform:
        jax.config.update("jax_platforms", cli.platform)
    import jax.numpy as jnp

    import drivers.namelist_sus as nl
    from drivers.driver_namelist_sus import build_domain_and_state, build_model
    from tasmania_jax.parallel import make_mesh
    from tasmania_jax.parallel.runner import DistributedModel
    from tasmania_jax.utils.jitx import carry_read_set

    nl.backend = cli.backend
    if cli.nx:
        nl.nx = cli.nx
        nl.ny = cli.ny or cli.nx
    if cli.nz:
        nl.nz = cli.nz

    px, py = (int(x) for x in cli.mesh.split(","))
    mesh = make_mesh(jax.devices()[: px * py], shape=(px, py))
    domain, state, pt = build_domain_and_state(nl)
    dt_s = nl.timestep.total_seconds()
    dm = DistributedModel(
        domain, state, mesh, lambda dom: build_model(nl, dom, pt), dt_s
    )
    print(f"mesh {px}x{py}  degenerate={dm.degenerate}  pads={dm._pads}")

    fields = dm.scatter_state(state)
    cgrid = domain.numerical_grid
    hs_steady = dm.put_topography(
        jnp.asarray(
            np.asarray(cgrid.topography.steady_profile.to_units("m").data),
            dtype=nl.so.dtype,
        )
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()
    nt = cli.niter

    def stepfn(flds, hs):
        out, _ = dm._step(dict(flds), dm._consts, hs)
        return out

    # the read-set must be computed on the COMPONENT step: the shard_map/pjit
    # wrapper shows up as one jaxpr equation consuming every operand, so
    # carry_read_set would conservatively report 17/17.  A single-device model
    # with the same config reads exactly the same field names.
    from tasmania_jax.framework.field import FieldArray

    sd_dycore, sd_physics = build_model(nl, domain, pt)
    units = {k: state[k].units for k in dm._names}
    dims = {k: state[k].dims for k in dm._names}
    hs_full = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )

    def analysis_step(flds, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in flds.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = sd_dycore(st, {}, dt_s)
        st = sd_physics(st, dt_s)
        return {k: st[k].data for k in dm._names}

    read = carry_read_set(
        analysis_step,
        {k: jnp.asarray(state[k].data) for k in dm._names},
        hs_full,
    )
    dead = {k: jnp.zeros_like(v) for k, v in fields.items() if k not in read}
    print(f"fused loop carries {len(read)}/{len(fields)} fields")

    def run_all(carry, hs, n):
        def body(i, carry):
            fact = jnp.minimum((i + 1.0) * dt_s / topo_time, 1.0)
            out = stepfn({**dead, **carry}, fact * hs)
            return {k: out[k] for k in carry}

        return jax.lax.fori_loop(0, n, body, carry)

    run_all_c = jax.jit(run_all, donate_argnums=(0,))
    carry0 = {k: v for k, v in fields.items() if k in read}

    t0 = time.perf_counter()
    out = jax.block_until_ready(run_all_c(dict(carry0), hs_steady * 0.0, 1))
    print(f"compile+warmup: {time.perf_counter() - t0:.1f} s", flush=True)
    carry0 = {k: out[k] for k in carry0}

    t0 = time.perf_counter()
    out = jax.block_until_ready(run_all_c(dict(carry0), hs_steady, nt))
    elapsed = time.perf_counter() - t0

    # u lives cell-anchored unless degenerate; either way max over faces < last
    u = np.asarray(out["x_velocity_at_u_locations"])
    umax = float(u[:, :-1].max() if u.shape[1] > 1 else u.max())
    gps = nl.nx * nl.ny * nl.nz * nt / elapsed
    res = dict(
        mesh=[px, py], backend=cli.backend, degenerate=dm.degenerate,
        elapsed=elapsed, ms_per_step=elapsed / nt * 1e3, gps=gps, umax=umax,
    )
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
