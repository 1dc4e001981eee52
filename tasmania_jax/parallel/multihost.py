"""Multi-process wiring: ``jax.distributed`` initialization + host-aware meshes.

The reference is single-process (SURVEY.md §2.8: no MPI/NCCL anywhere); this
module is the multi-process layer BASELINE config 5 requires.  Every process
runs the SAME driver; ``initialize_distributed`` wires the JAX distributed
runtime (coordinator + process ids from arguments or the standard environment
variables), after which ``jax.devices()`` spans every process and the
runner's ``shard_map`` collectives cross process boundaries.

Mesh layout rule: for a 2-D halo-exchange decomposition the traffic is
nearest-neighbour on both axes, so the mesh tiles processes coarsely: each
process owns a contiguous (x, y) super-block and only the super-block *edges*
cross the slower inter-process link — ``make_hybrid_mesh`` arranges exactly
that by keeping each process's devices contiguous in the mesh.  One host with
four GPUs is one process, where this reduces to ``make_mesh``.

The multi-process path is validated functionally with CPU processes
(tests/test_multihost.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Arguments default to the standard environment (``JAX_COORDINATOR_ADDRESS``
    / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).  Without a cluster manager
    JAX cannot detect them, so give all three (e.g. ``localhost:<port>``).
    """
    import jax

    if getattr(jax.distributed, "is_initialized", None) and jax.distributed.is_initialized():
        return
    kwargs = {}
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def make_hybrid_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("x", "y"),
    process_grid: Optional[Tuple[int, int]] = None,
):
    """A 2-D mesh whose per-process device blocks are contiguous, so halo
    ppermutes between devices of the same process stay inside it and only
    process-block edges cross processes.

    With one process this reduces to :func:`tasmania_jax.parallel.make_mesh`.
    With several, processes are stacked along x, unless
    ``process_grid=(prx, pry)`` asks for a 2-D arrangement of per-process
    device blocks (both mesh axes then cross process boundaries;
    tests/multihost_worker.py exercises the (2, 2) case with real
    cross-address-space collectives on x AND y)."""
    import jax
    from jax.sharding import Mesh

    from tasmania_jax.parallel.mesh import _factor_2d, make_mesh

    nproc = jax.process_count()
    devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = _factor_2d(n)
    px, py = mesh_shape
    assert px * py == n, f"mesh shape {px}x{py} != {n} devices"

    if nproc == 1:
        return make_mesh(devices, shape=mesh_shape, axis_names=axis_names)

    if process_grid is not None:
        prx, pry = process_grid
        assert prx * pry == nproc, f"process grid {prx}x{pry} != {nproc}"
        assert px % prx == 0 and py % pry == 0, (
            f"mesh {px}x{py} not divisible by process grid {prx}x{pry}"
        )
        bx, by = px // prx, py // pry
        grid = np.empty((px, py), dtype=object)
        for p in range(nproc):
            dv = sorted(
                (d for d in devices if d.process_index == p), key=lambda d: d.id
            )
            assert len(dv) == bx * by, (
                f"process {p} has {len(dv)} devices, need {bx * by}"
            )
            r, c = divmod(p, pry)
            grid[r * bx : (r + 1) * bx, c * by : (c + 1) * by] = np.array(
                dv, dtype=object
            ).reshape(bx, by)
        return Mesh(grid, axis_names)

    assert px % nproc == 0, (
        f"mesh x-extent {px} must be divisible by process count {nproc} "
        "(hosts are stacked along the x axis)"
    )
    per_host = (px // nproc, py)
    # stack each process's contiguous device block along x by process_index,
    # so only host-block edges cross the process boundary
    blocks = []
    for p in range(nproc):
        dv = sorted(
            (d for d in devices if d.process_index == p), key=lambda d: d.id
        )
        assert len(dv) == per_host[0] * per_host[1], (
            f"process {p} has {len(dv)} devices, need {per_host[0] * per_host[1]}"
        )
        blocks.append(np.array(dv, dtype=object).reshape(per_host))
    return Mesh(np.concatenate(blocks, axis=0), axis_names)
