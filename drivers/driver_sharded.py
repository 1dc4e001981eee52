"""Sharded (domain-decomposed) isentropic benchmark driver (dry or moist).

BASELINE config 5: the REAL framework model — ``IsentropicDynamicalCore``
(rk3ws_si + fifth-order upwind), optionally the full moist SUS physics chain —
``shard_map``-distributed over a 2-D device mesh with explicit ppermute halo
exchange (``tasmania_jax.parallel.runner.DistributedModel``; replaces the
round-1 bespoke step).  It runs over every visible device (one host's GPUs
form one mesh); pass ``--virtual N`` to exercise the multi-device path on N
virtual CPU devices (functional validation).  Across several processes the
same script scales unchanged; pass ``--multihost`` to initialize
``jax.distributed`` (see tasmania_jax/parallel/multihost.py).

Usage: ``python drivers/driver_sharded.py [--nx N] [--nz N] [--niter N]
[--virtual N] [--physics] [--f64]``
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import datetime
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=64)
    parser.add_argument("--niter", type=int, default=50)
    parser.add_argument("--virtual", type=int, default=0, help="N virtual CPU devices")
    parser.add_argument(
        "--physics", action="store_true",
        help="run the FULL moist SUS physics chain (Kessler etc.) distributed",
    )
    parser.add_argument("--f64", action="store_true")
    parser.add_argument(
        "--multihost", action="store_true",
        help="call jax.distributed.initialize() before device discovery "
        "(coordinator/process env per JAX_COORDINATOR_ADDRESS etc.)",
    )
    parser.add_argument("--backend", type=str, default="jax")
    cli = parser.parse_args(argv)

    if cli.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cli.virtual}"
        ).strip()

    import jax

    from tasmania_jax.utils.device import configure_compile_cache

    configure_compile_cache()
    if cli.virtual:
        jax.config.update("jax_platforms", "cpu")
    if cli.multihost:
        from tasmania_jax.parallel.multihost import initialize_distributed

        initialize_distributed()
    if cli.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tasmania_jax.parallel import make_mesh
    from tasmania_jax.parallel.runner import DistributedModel

    mesh = make_mesh(jax.devices())
    px, py = mesh.devices.shape
    nx = cli.nx - cli.nx % px or px * 8
    ny = (cli.ny or cli.nx) - (cli.ny or cli.nx) % py or py * 8
    nz = cli.nz
    print(f"mesh {px}x{py}, grid {nx}x{ny}x{nz}")

    import drivers.namelist_sus as nl
    from drivers.driver_namelist_sus import build_domain_and_state, build_model

    nl.nx, nl.ny, nl.nz = nx, ny, nz
    if cli.f64:
        from tasmania_jax.framework.options import StorageOptions

        nl.so = StorageOptions(dtype=np.float64)
    nl.backend = cli.backend

    domain, state, pt = build_domain_and_state(nl)
    dt = nl.timestep.total_seconds()

    if cli.physics:
        factory = lambda dom: build_model(nl, dom, pt)
    else:
        from tasmania_jax.isentropic import IsentropicDynamicalCore

        def factory(dom):
            core = IsentropicDynamicalCore(
                dom,
                moist=True,
                time_integration_scheme=nl.time_integration_scheme,
                horizontal_flux_scheme=nl.horizontal_flux_scheme,
                time_integration_properties={"pt": pt, "eps": nl.eps},
                damp=nl.damp,
                damp_type=nl.damp_type,
                damp_depth=nl.damp_depth,
                damp_max=nl.damp_max,
                damp_at_every_stage=nl.damp_at_every_stage,
                smooth=False,
                backend=nl.backend,
                backend_options=nl.bo,
                storage_options=nl.so,
            )
            return core, None

    dm = DistributedModel(domain, state, mesh, factory, dt)
    fields = dm.scatter_state(state)
    hs_steady = dm.put_topography(
        jnp.asarray(
            np.asarray(
                domain.numerical_grid.topography.steady_profile.to_units("m").data
            ),
            dtype=nl.so.dtype,
        )
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()

    t0 = time.perf_counter()
    jax.block_until_ready(dm.step(fields, dm.put_topography(0.0 * hs_steady)))
    print(f"compile+warmup: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for i in range(cli.niter):
        fact = min((i + 1) * dt / topo_time, 1.0)
        fields = dm.step(fields, fact * hs_steady)
    jax.block_until_ready(fields)
    elapsed = time.perf_counter() - t0

    u = np.asarray(fields["x_velocity_at_u_locations"])
    print(f"Validation: umax = {u.max():.5f}")
    gps = nx * ny * nz * cli.niter / elapsed
    print(f"Compute time: {elapsed:.3f} s; throughput: {gps:.3e} gridpoints/s")
    return {"gps": gps, "elapsed": elapsed, "umax": float(u.max())}


if __name__ == "__main__":
    main()
