"""Benchmark driver: prints ONE JSON line with the flagship's throughput.

The flagship is the reference's own headline benchmark: the moist isentropic
core, 161x161x120, rk3ws_si + fifth_order_upwind, the full Kessler physics
chain via sequential-update splitting, 100 steps of 5 s (reference
``drivers/benchmarking/isentropic_moist/namelist_sus.py``).  It runs in this
process on the jax (XLA) backend; without a GPU the benchmark fails instead of
timing the CPU.  The device and the card's name and power limit are printed
before the result.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def bench_burgers(nx=2048, ny=2048, nb=3, nt=50, dtype="float32"):
    import jax

    from tasmania_jax.burgers.dynamics.advection import BurgersAdvection

    adv = BurgersAdvection.factory("third_order")
    ext = adv.extent
    dx = dy = 1.0 / nx
    dt = 1e-4

    def stage(u, v, u0, v0, frac):
        iw = slice(nb - ext, u.shape[0] - nb + ext)
        jw = slice(nb - ext, u.shape[1] - nb + ext)
        a_ux, a_uy, a_vx, a_vy = adv(dx, dy, u[iw, jw], v[iw, jw])
        i = slice(nb, u.shape[0] - nb)
        j = slice(nb, u.shape[1] - nb)
        un = u0.at[i, j].add(-frac * dt * (a_ux + a_uy))
        vn = v0.at[i, j].add(-frac * dt * (a_vx + a_vy))
        return un, vn

    @jax.jit
    def step(u, v):
        u1, v1 = stage(u, v, u, v, 1.0 / 3.0)
        u2, v2 = stage(u1, v1, u, v, 0.5)
        return stage(u2, v2, u, v, 1.0)

    shape = (nx + 2 * nb, ny + 2 * nb)
    u = 0.1 * jax.random.normal(jax.random.PRNGKey(0), shape, dtype=dtype)
    v = 0.1 * jax.random.normal(jax.random.PRNGKey(1), shape, dtype=dtype)

    u, v = jax.block_until_ready(step(u, v))  # compile

    t0 = time.perf_counter()
    for _ in range(nt):
        u, v = step(u, v)
    jax.block_until_ready((u, v))
    elapsed = time.perf_counter() - t0

    return nx * ny * nt / elapsed


def main() -> int:
    from tasmania_jax.utils.device import (
        card_name_and_power_limit,
        configure_compile_cache,
        require_gpu,
    )

    configure_compile_cache()
    device = require_gpu()
    print(f"device: {device}")
    print(f"nvidia-smi: {card_name_and_power_limit()}", flush=True)

    from drivers.driver_namelist_sus import main as sus_main

    res = sus_main(["--fused-loop"])
    print(
        json.dumps(
            {
                "metric": "isentropic_moist_sus_gridpoints_per_s_per_chip",
                "value": res["gps"],
                "unit": "gridpoints/s",
                "backend": "jax",
                "umax": res["umax"],
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
