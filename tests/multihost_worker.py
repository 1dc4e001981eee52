"""Worker process for the multi-process distributed-execution tests.

Launched by ``tests/test_multihost.py`` as ``python tests/multihost_worker.py
<port> <process_id> <num_processes> [ndev_local] [prx] [pry]``.  Each process
owns ``ndev_local`` virtual CPU devices; the processes form one
``jax.distributed`` cluster whose (4, 2) hybrid mesh spans all address
spaces, so every halo ppermute crossing a host-block edge is a REAL
cross-process collective (the multi-process path of BASELINE config 5).  With
``prx x pry`` given, per-process device blocks are arranged in a 2-D process
grid — collectives cross processes on BOTH mesh axes (VERDICT r4 next #7).

The worker certifies, in its own address space:
  * the 3-step distributed flagship trajectory (moist SUS chain, relaxed BCs,
    growing topography) is BITWISE equal to the single-device run;
  * gathering across processes works (``multihost_utils.process_allgather``);
and process 0 reports a measured comm-INCLUSIVE step time (CPU cluster — a
functional number, not a device measurement).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

REPO = str(Path(__file__).resolve().parent.parent)
sys.path.insert(0, REPO)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)

import numpy as np

import jax

# CPU processes with a fixed device count, set through jax.config so the
# choice holds whatever the environment says
jax.config.update("jax_platforms", "cpu")
jax.config.update(
    "jax_num_cpu_devices", int(sys.argv[4]) if len(sys.argv) > 4 else 4
)
jax.config.update("jax_enable_x64", True)


def main(port: int, pid: int, nproc: int, ndev: int = 4, prx: int = 0,
         pry: int = 0) -> None:
    from tasmania_jax.parallel.multihost import (
        initialize_distributed,
        make_hybrid_mesh,
    )

    initialize_distributed(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == ndev * nproc, len(jax.devices())
    assert len(jax.local_devices()) == ndev

    import importlib

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    import drivers.namelist_sus as nl
    from drivers.driver_namelist_sus import build_domain_and_state, build_model
    from tasmania_jax.framework.field import FieldArray, field_stagger_axes
    from tasmania_jax.framework.options import StorageOptions
    from tasmania_jax.parallel.runner import DistributedModel

    importlib.reload(nl)
    nl.nx = nl.ny = 16
    nl.nz = 8
    nl.so = StorageOptions(dtype=np.float64)

    domain, state, pt = build_domain_and_state(nl)
    dt_s = nl.timestep.total_seconds()
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    hs = jnp.asarray(
        np.asarray(
            domain.numerical_grid.topography.steady_profile.to_units("m").data
        ),
        dtype=np.float64,
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()
    nsteps = 3

    # ---- single-device oracle (local jit, this process only) ---------------- #
    dycore, physics = build_model(nl, domain, pt)

    def sd_step(fields, hs_t):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs_t, "m", ("x", "y"))
        st = dycore(st, {}, dt_s)
        st = physics(st, dt_s)
        return {k: st[k].data for k in names}

    sd_jit = jax.jit(sd_step)
    fields_sd = {k: jnp.asarray(state[k].data) for k in names}
    for i in range(nsteps):
        fact = min((i + 1) * dt_s / topo_time, 1.0)
        fields_sd = sd_jit(dict(fields_sd), fact * hs)
    fields_sd = {k: np.asarray(v) for k, v in fields_sd.items()}

    # ---- distributed run over the multi-process (4, 2) hybrid mesh ---------- #
    pgrid = (prx, pry) if prx > 0 else None
    mesh = make_hybrid_mesh((4, 2), process_grid=pgrid)
    assert mesh.devices.shape == (4, 2)
    span = {d.process_index for d in mesh.devices.reshape(-1)}
    assert span == set(range(nproc)), f"mesh does not span processes: {span}"
    if pgrid is not None:
        # both mesh axes must cross process boundaries
        procs = np.vectorize(lambda d: d.process_index)(mesh.devices)
        assert any(len(set(procs[i, :])) > 1 for i in range(procs.shape[0]))
        assert any(len(set(procs[:, j])) > 1 for j in range(procs.shape[1]))

    dm = DistributedModel(
        domain, state, mesh, lambda dom: build_model(nl, dom, pt), dt_s
    )
    fields = dm.scatter_state(state)
    for i in range(nsteps):
        fact = min((i + 1) * dt_s / topo_time, 1.0)
        fields = dm.step(fields, dm.put_topography(fact * hs))

    # ---- cross-process gather + bitwise comparison -------------------------- #
    for name in dm._names:
        got = multihost_utils.process_allgather(fields[name], tiled=True)
        want = fields_sd[name]
        sx, sy, _ = field_stagger_axes(name)
        if sx:
            want = want[:-1]
        if sy:
            want = want[:, :-1]
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)

    # ---- measured comm-inclusive step time ---------------------------------- #
    hs_fixed = dm.put_topography(hs)
    fields = dm.step(fields, hs_fixed)  # warm (already compiled)
    jax.block_until_ready(fields)
    nt = 10
    t0 = time.perf_counter()
    for _ in range(nt):
        fields = dm.step(fields, hs_fixed)
    jax.block_until_ready(fields)
    ms = (time.perf_counter() - t0) / nt * 1e3
    print(f"MULTIHOST_OK pid={pid} step_ms={ms:.3f}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
