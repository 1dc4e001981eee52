"""Smoke run of the flagship on the GPU: the quickest proof that the system
starts on the card and computes the right thing.

Usage::

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the decomposed run on four GPUs

On one card the phases are, in one process:

1. device: JAX must report a GPU; the card's name and power limit;
2. flagship: the moist isentropic SUS benchmark (161x161x120, f32, 100
   steps) through ``drivers/driver_namelist_sus.main(["--fused-loop"])``;
3. reference: 3 steps of the same chain at full width on the numpy backend
   in float64 (the plain reference, independent of XLA), against the GPU in
   float32 and, after every float32 phase, in float64;
4. couplings: the six upstream coupling variants, 5 steps each.

With ``--four-cards`` only the decomposed path runs: one 161x161x120 block per
card on a (2, 2) mesh, through ``DistributedModel`` (explicit halo exchange)
and through GSPMD, each against the same global grid on one card.

Every phase prints its numbers; any failure exits non-zero.  The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

from tasmania_jax.utils.device import (  # noqa: E402
    card_name_and_power_limit,
    configure_compile_cache,
    require_gpu,
)

#: the eight prognostics the golden trajectory freezes
PROGNOSTICS = (
    "air_isentropic_density",
    "x_momentum_isentropic",
    "y_momentum_isentropic",
    "mass_fraction_of_water_vapor_in_air",
    "mass_fraction_of_cloud_liquid_water_in_air",
    "mass_fraction_of_precipitation_water_in_air",
    "x_velocity_at_u_locations",
    "y_velocity_at_v_locations",
)
COUPLINGS = ("fc", "lfc", "ps", "sts", "sus", "ssus")

#: GPU float64 vs numpy float64, as a share of each field's max: the
#: compiler-jitter bound of tests/test_golden_trajectory.py
TOL_F64 = 1e-9
#: GPU float32 vs numpy float64 after 3 steps, as a share of each field's
#: scale.  The float32 run differs by 1.3e-5 of the max (density and zonal
#: momentum, in the lowest levels under the mountain) on an H100; its
#: float32 initial state alone already differs by 1.1e-5 from the float64
#: one (CPU, 81x81x120), so the gap is the state's float32 rounding, not the
#: device or the stepping.  The limit leaves 4x headroom for another fusion
#: order, while a wrong stencil or a TF32 contraction errs by 1e-3 or more
TOL_F32 = 5e-5
#: decomposed vs one card, both float32: two roundings of the same numerics,
#: each within TOL_F32 of the exact answer
TOL_FOUR_CARDS = 2 * TOL_F32
#: float32 scales: after 3 steps the meridional wind is a ~1e-4 perturbation
#: of the 22.5 m/s zonal flow, and its roundings come from terms of the zonal
#: wind's size, so its error is measured against the zonal field's max
F32_SCALES = {
    "y_momentum_isentropic": "x_momentum_isentropic",
    "y_velocity_at_v_locations": "x_velocity_at_u_locations",
}


class SmokeFailure(RuntimeError):
    """A phase computed something wrong."""


def relative_errors(ref, out, names=PROGNOSTICS, scales=None):
    """``max|out - ref| / max|ref[scales.get(name, name)]|`` per field
    (absolute where that reference is all zero)."""
    scales = scales or {}
    errs = {}
    for name in names:
        a = np.asarray(ref[name], dtype=np.float64)
        b = np.asarray(out[name], dtype=np.float64)
        if a.shape != b.shape:
            raise SmokeFailure(f"{name}: shape {b.shape} != reference {a.shape}")
        scale = np.max(np.abs(np.asarray(ref[scales.get(name, name)]))) or 1.0
        errs[name] = float(np.max(np.abs(b - a)) / scale)
    return errs


def check_errors(label: str, errs, tol: float) -> None:
    """Print each field's error beside its limit; raise if any is over it
    (a NaN error counts as over)."""
    bad = []
    for name, err in errs.items():
        ok = err <= tol
        print(f"  {label} {name}: {err:.3e} (limit {tol:.0e}){'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
    if bad:
        raise SmokeFailure(f"{label}: {bad} exceed {tol:.0e}")


def _namelist(backend="jax", dtype=np.float32, nx=None, ny=None, nz=None):
    """The flagship namelist, fresh, with the given backend, dtype and grid
    (``ny`` defaults to ``nx``)."""
    import drivers.namelist_sus as nl
    from tasmania_jax.framework.options import StorageOptions

    importlib.reload(nl)
    nl.backend = backend
    nl.so = StorageOptions(dtype=dtype)
    nl.nx = nx or nl.nx
    nl.ny = ny or nx or nl.ny
    nl.nz = nz or nl.nz
    return nl


def _host(fields):
    return {k: np.asarray(v) for k, v in fields.items()}


def phase_device():
    info = require_gpu()
    print(f"device: {info['kind']} x{info['count']} ({info['platform']})")
    print(f"nvidia-smi: {card_name_and_power_limit()}")
    return info


def phase_flagship():
    from drivers.driver_namelist_sus import main as sus_main

    nl = _namelist()
    res = sus_main(["--fused-loop"])
    gp = nl.nx * nl.ny * nl.nz
    print(
        f"flagship {nl.nx}x{nl.ny}x{nl.nz} f32, {nl.niter} steps: compile+warmup "
        f"{res['compile_s']:.1f} s, steady {res['elapsed']:.3f} s, "
        f"{res['gps']:.4e} gridpoints/s (one smoke run, not a benchmark; "
        f"{gp} gridpoints)"
    )
    print(f"flagship umax {res['umax']!r} vmax {res['vmax']!r}")
    print(f"flagship memory_analysis: {res['memory_analysis']}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"flagship peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    if not (np.isfinite(res["umax"]) and np.isfinite(res["vmax"])):
        raise SmokeFailure(f"flagship umax/vmax not finite: {res}")
    return res


def sus_fields(backend, dtype, nsteps, nx=None, nz=None):
    """Final fields of ``nsteps`` SUS steps on host memory."""
    from drivers.driver_namelist_sus import run_steps

    return _host(run_steps(_namelist(backend, dtype, nx=nx, nz=nz), nsteps))


def phase_reference_f32(nsteps=3, nx=None, nz=None):
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        ref = sus_fields("numpy", np.float64, nsteps, nx, nz)
        print(f"reference: numpy float64, {nsteps} steps, {time.perf_counter() - t0:.1f} s")
    out = sus_fields("jax", np.float32, nsteps, nx, nz)
    check_errors(
        "gpu-f32 vs numpy-f64", relative_errors(ref, out, scales=F32_SCALES), TOL_F32
    )
    return ref


def phase_reference_f64(ref, nsteps=3, nx=None, nz=None):
    with jax.enable_x64(True):
        out = sus_fields("jax", np.float64, nsteps, nx, nz)
    check_errors("gpu-f64 vs numpy-f64", relative_errors(ref, out), TOL_F64)


def phase_couplings(niter=5, nx=None, nz=None):
    from drivers.driver_isentropic_moist import main as variant_main

    argv = ["--niter", str(niter)]
    if nx:
        argv += ["--nx", str(nx)]
    if nz:
        argv += ["--nz", str(nz)]
    for c in COUPLINGS:
        res = variant_main(["--coupling", c] + argv)
        print(
            f"coupling {c}: compile+warmup {res['compile_s']:.1f} s, "
            f"umax {res['umax']!r} vmax {res['vmax']!r}"
        )
        if not np.isfinite(res["umax"]):
            raise SmokeFailure(f"coupling {c}: umax not finite")


def phase_four_cards(devices, bx=161, by=161, nz=None, nsteps=3):
    """One (bx, by) block per card on a (2, 2) mesh: DistributedModel and
    GSPMD against the same global grid on ``devices[0]`` alone."""
    from drivers.driver_namelist_sus import (
        build_domain_and_state,
        build_model,
        mountain_fraction,
        run_steps,
    )
    from tasmania_jax.parallel import make_mesh
    from tasmania_jax.parallel.runner import DistributedModel

    mesh = make_mesh(devices[:4], shape=(2, 2))
    grid = dict(nx=2 * bx, ny=2 * by, nz=nz)
    print(f"four cards: mesh {mesh.devices.shape}, global {2 * bx}x{2 * by}, "
          f"block {bx}x{by}, {nsteps} steps")

    with jax.default_device(devices[0]):
        one = _host(run_steps(_namelist(**grid), nsteps))

    nl = _namelist(**grid)
    domain, state, pt = build_domain_and_state(nl)
    dm = DistributedModel(
        domain, state, mesh, lambda dom: build_model(nl, dom, pt),
        nl.timestep.total_seconds(),
    )
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    fields = dm.scatter_state(state)
    for i in range(nsteps):
        fields = dm.step(fields, dm.put_topography(mountain_fraction(nl, i + 1) * hs))
    _check_spread("DistributedModel", jax.block_until_ready(fields))
    dist = {k: v.data for k, v in dm.gather_state(fields).items()}
    check_errors("DistributedModel vs one card", relative_errors(one, dist, scales=F32_SCALES),
                 TOL_FOUR_CARDS)

    spmd = jax.block_until_ready(run_steps(_namelist(**grid), nsteps, mesh=mesh))
    _check_spread("spmd", {"air_isentropic_density": spmd["air_isentropic_density"]})
    check_errors("spmd vs one card", relative_errors(one, _host(spmd), scales=F32_SCALES),
                 TOL_FOUR_CARDS)


def _check_spread(label, fields, n=4):
    """Every field's shards sit on ``n`` distinct devices."""
    for k, v in fields.items():
        devs = sorted(str(d) for d in v.sharding.device_set)
        if len(devs) != n:
            raise SmokeFailure(f"{label}: {k} spans {len(devs)} devices, not {n}")
    print(f"  {label}: {len(fields)} field(s), each on devices {devs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the decomposed path on four GPUs",
    )
    cli = ap.parse_args(argv)

    print(f"compile cache: {configure_compile_cache()}")
    t0 = time.perf_counter()

    def phase(name, fn, *args):
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
        return fn(*args)

    info = phase("device", phase_device)
    if cli.four_cards:
        if info["count"] < 4:
            raise SmokeFailure(f"--four-cards needs 4 GPUs, found {info['count']}")
        phase("four cards", phase_four_cards, jax.devices())
    else:
        phase("flagship", phase_flagship)
        ref = phase("reference, float32", phase_reference_f32)
        phase("couplings", phase_couplings)
        phase("reference, float64", phase_reference_f64, ref)
    print(f"[{time.perf_counter() - t0:7.1f} s] all phases passed")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
