"""Moist isentropic benchmark driver — sequential-update splitting variant.

JAX re-design of reference
``drivers/benchmarking/isentropic_moist/driver_namelist_sus.py``: the same
physics chain (diagnostics → Coriolis → smoothing → Smagorinsky → velocities →
Kessler+promoter → saturation adjustment → vertical advection → fall velocity +
sedimentation → precipitation) in a ``SequentialUpdateSplitting``, with the
whole dycore+physics timestep compiled into ONE jitted function whose inputs
include the (growing) topography height — no retrace during mountain growth.

Usage: ``python drivers/driver_namelist_sus.py [--nx N] [--nz N] [--niter N]
[--platform cpu|gpu] [--spmd] [--virtual N]``

``--spmd`` shards the ENTIRE dycore+physics timestep over all visible devices
by annotating input shardings ``P('x', 'y', None)`` on a 2-D mesh and letting
XLA's SPMD partitioner insert the halo collectives — the "pick a mesh,
annotate shardings, let XLA insert collectives" recipe.  The hand-written
``shard_map`` path (drivers/driver_sharded.py) is the explicit alternative for
the dynamical core alone.
"""

from __future__ import annotations

import argparse
import sys
import time
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build_domain_and_state(nl):
    """Global domain + initial state + pt (the reusable host-side setup)."""
    import jax.numpy as jnp

    from tasmania_jax.domain import Domain
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.isentropic import (
        get_isentropic_state_from_brunt_vaisala_frequency,
    )

    common = dict(backend=nl.backend, backend_options=nl.bo, storage_options=nl.so)

    domain = Domain(
        nl.domain_x,
        nl.nx,
        nl.domain_y,
        nl.ny,
        nl.domain_z,
        nl.nz,
        horizontal_boundary_type=nl.hb_type,
        nb=nl.nb,
        horizontal_boundary_kwargs=nl.hb_kwargs,
        topography_type=nl.topo_type,
        topography_kwargs=nl.topo_kwargs,
        **common,
    )
    cgrid = domain.numerical_grid

    state = get_isentropic_state_from_brunt_vaisala_frequency(
        cgrid,
        nl.init_time,
        nl.x_velocity,
        nl.y_velocity,
        nl.brunt_vaisala,
        moist=True,
        precipitation=nl.sedimentation,
        relative_humidity=nl.relative_humidity,
        backend=nl.backend,
        storage_options=nl.so,
    )
    domain.horizontal_boundary.reference_state = state

    shp = (cgrid.nx, cgrid.ny, cgrid.nz)
    xp = np if nl.backend == "numpy" else jnp
    state["tendency_of_air_potential_temperature"] = FieldArray(
        xp.zeros(shp, dtype=nl.so.dtype), "K s^-1", ("x", "y", "z")
    )

    pt_v = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    pt = FieldArray(np.asarray(pt_v), "Pa", ())
    return domain, state, pt


def build_model(nl, domain, pt, skip=()):
    """Dycore + SUS physics chain against ``domain`` (global OR a per-shard
    ``LocalDomain`` — the distributed runner reuses exactly this construction,
    VERDICT round-1 item 1).

    ``skip``: names of physics processes to leave out (profiling harness,
    drivers/driver_profile.py): any of {"diagnostics", "coriolis", "smoothing",
    "smagorinsky", "velocities", "kessler", "satadj", "vertical_advection",
    "sedimentation", "precipitation"}."""
    from tasmania_jax.framework import ConcurrentCoupling, TimeIntegrationOptions
    from tasmania_jax.framework.splitting import SequentialUpdateSplitting
    from tasmania_jax.isentropic import IsentropicDynamicalCore
    from tasmania_jax.isentropic.physics import (
        IsentropicConservativeCoriolis,
        IsentropicDiagnostics,
        IsentropicHorizontalSmoothing,
        IsentropicImplicitVerticalAdvectionDiagnostic,
        IsentropicSmagorinsky,
        IsentropicVelocityComponents,
        IsentropicVerticalAdvection,
    )
    from tasmania_jax.isentropic.utils import (
        AirPotentialTemperatureToDiagnostic,
        AirPotentialTemperatureToTendency,
    )
    from tasmania_jax.physics import (
        KesslerFallVelocity,
        KesslerMicrophysics,
        KesslerSaturationAdjustmentPrognostic,
        KesslerSedimentation,
        Precipitation,
    )

    common = dict(backend=nl.backend, backend_options=nl.bo, storage_options=nl.so)

    dycore = IsentropicDynamicalCore(
        domain,
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
        smooth_moist=False,
        enable_checks=nl.enable_checks,
        **common,
    )

    # physics chain (reference driver_namelist_sus.py:183-471)
    ptis = nl.physics_time_integration_scheme
    args = []
    if "diagnostics" not in skip:
        dv = IsentropicDiagnostics(domain, "numerical", moist=True, pt=pt, **common)
        args.append(TimeIntegrationOptions(component=dv))

    if nl.coriolis_parameter is not None and "coriolis" not in skip:
        cf = IsentropicConservativeCoriolis(
            domain, "numerical", nl.coriolis_parameter, **common
        )
        args.append(TimeIntegrationOptions(component=cf, scheme=ptis))

    if nl.smooth and "smoothing" not in skip:
        hs_comp = IsentropicHorizontalSmoothing(
            domain,
            nl.smooth_type,
            nl.smooth_coeff,
            nl.smooth_coeff_max,
            nl.smooth_damp_depth,
            moist=nl.smooth_moist,
            smooth_moist_coeff=nl.smooth_moist_coeff,
            smooth_moist_coeff_max=nl.smooth_moist_coeff_max,
            smooth_moist_damp_depth=nl.smooth_moist_damp_depth,
            **common,
        )
        args.append(TimeIntegrationOptions(component=hs_comp))

    if "smagorinsky" not in skip:
        turb = IsentropicSmagorinsky(domain, nl.smagorinsky_constant, **common)
        args.append(TimeIntegrationOptions(component=turb, scheme=ptis))

    if "velocities" not in skip:
        ivc = IsentropicVelocityComponents(domain, **common)
        args.append(TimeIntegrationOptions(component=ivc))

    t2d = AirPotentialTemperatureToDiagnostic(domain, "numerical", **common)
    if "kessler" not in skip:
        ke = KesslerMicrophysics(
            domain,
            "numerical",
            air_pressure_on_interface_levels=True,
            tendency_of_air_potential_temperature_in_diagnostics=False,
            rain_evaporation=nl.rain_evaporation,
            autoconversion_threshold=nl.autoconversion_threshold,
            autoconversion_rate=nl.autoconversion_rate,
            collection_rate=nl.collection_rate,
            **common,
        )
        args.append(
            TimeIntegrationOptions(
                component=ConcurrentCoupling(ke, t2d, execution_policy="serial"),
                scheme=ptis,
            )
        )

    if "satadj" not in skip:
        d2t = AirPotentialTemperatureToTendency(domain, "numerical", **common)
        sa = KesslerSaturationAdjustmentPrognostic(
            domain,
            "numerical",
            air_pressure_on_interface_levels=True,
            saturation_rate=nl.saturation_rate,
            **common,
        )
        args.append(
            TimeIntegrationOptions(
                component=ConcurrentCoupling(d2t, sa, t2d, execution_policy="serial"),
                scheme=ptis,
            )
        )

    if nl.vertical_advection and "vertical_advection" not in skip:
        if nl.implicit_vertical_advection:
            vf = IsentropicImplicitVerticalAdvectionDiagnostic(
                domain, moist=True, **common
            )
            args.append(TimeIntegrationOptions(component=vf))
        else:
            vf = IsentropicVerticalAdvection(
                domain,
                flux_scheme=nl.vertical_flux_scheme,
                moist=True,
                tendency_of_air_potential_temperature_on_interface_levels=False,
                **common,
            )
            args.append(TimeIntegrationOptions(component=vf, scheme="rk3ws"))

    rfv = KesslerFallVelocity(domain, "numerical", **common)
    sd = KesslerSedimentation(
        domain,
        "numerical",
        sedimentation_flux_scheme=nl.sedimentation_flux_scheme,
        **common,
    )
    if "sedimentation" not in skip:
        args.append(
            TimeIntegrationOptions(
                component=ConcurrentCoupling(rfv, sd, execution_policy="serial"),
                scheme="rk3ws",
            )
        )
    if "precipitation" not in skip:
        ap = Precipitation(domain, "numerical", **common)
        args.append(
            TimeIntegrationOptions(
                component=ConcurrentCoupling(rfv, ap, execution_policy="serial")
            )
        )

    physics = SequentialUpdateSplitting(*args)
    return dycore, physics


def build(nl):
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    return domain, dycore, physics, state


def make_step(nl):
    """Build the model and wrap one whole timestep into a pure function
    ``step(fields, hs) -> fields`` of the raw fields (every state entry but
    the time) and the current topography height."""
    from tasmania_jax.framework.field import FieldArray

    domain, dycore, physics, state = build(nl)
    dt_s = nl.timestep.total_seconds()
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = dycore(st, {}, dt_s)
        st = physics(st, dt_s)
        return {k: st[k].data for k in names}

    return domain, state, step


def mountain_fraction(nl, i: int) -> float:
    """Fraction of the steady mountain height reached after step ``i``
    (1-based): the mountain grows linearly over ``topo_kwargs["time"]``."""
    dt_s = nl.timestep.total_seconds()
    return min(i * dt_s / nl.topo_kwargs["time"].total_seconds(), 1.0)


def spmd_sharding(v, mesh):
    """``P('x', 'y', None)``-style sharding of one field over a 2-D mesh.

    Each horizontal axis is sharded only where its extent divides the mesh
    axis: the staggered n+1 fields replicate along that axis and XLA gathers
    at their use sites, so nx, ny divisible by the mesh scale fully."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    nd = getattr(v, "ndim", 0)
    spec = [
        name if v.shape[ax] % mesh.devices.shape[ax] == 0 else None
        for ax, name in zip(range(min(nd, 2)), ("x", "y"))
    ]
    spec += [None] * (nd - len(spec))
    return NamedSharding(mesh, P(*spec))


def run_steps(nl, nsteps: int, mesh=None):
    """``nsteps`` timesteps from the initial state: one jitted step each, or
    plain Python on the numpy backend.  With ``mesh`` the fields are sharded
    by :func:`spmd_sharding` and XLA partitions the step (GSPMD).  Returns
    the final raw fields."""
    import jax
    import jax.numpy as jnp

    domain, state, step = make_step(nl)
    xp = np if nl.backend == "numpy" else jnp
    hs = xp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )
    fields = {k: xp.asarray(state[k].data) for k in state if k != "time"}
    if nl.backend != "numpy":
        step = jax.jit(step)
    if mesh is not None:
        fields = {k: jax.device_put(v, spmd_sharding(v, mesh)) for k, v in fields.items()}
        hs = jax.device_put(hs, spmd_sharding(hs, mesh))
    for i in range(nsteps):
        fields = step(dict(fields), mountain_fraction(nl, i + 1) * hs)
    return fields


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--platform", type=str, default=None)
    parser.add_argument("--backend", type=str, default=None)
    parser.add_argument("--no-jit", action="store_true")
    parser.add_argument(
        "--profile", type=str, default=None, metavar="LOGDIR",
        help="capture a jax.profiler trace of the timed loop into LOGDIR",
    )
    parser.add_argument(
        "--spmd", action="store_true",
        help="shard the whole step over all visible devices (GSPMD)",
    )
    parser.add_argument(
        "--fused-loop", action="store_true",
        help="run all niter steps inside one jitted lax.fori_loop "
        "(no per-step dispatch from the host)",
    )
    parser.add_argument(
        "--bf16-carry", action="store_true",
        help="with --fused-loop: store the loop-carried prognostics in "
        "bfloat16 between steps (compute stays float32) — halves the "
        "carry's memory footprint at the cost of ~bf16 rounding per step",
    )
    parser.add_argument(
        "--checkpoint-dir", type=str, default=None,
        help="write sharded orbax checkpoints into this directory",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=25,
        help="steps between checkpoints (with --checkpoint-dir)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the latest checkpoint in --checkpoint-dir",
    )
    parser.add_argument(
        "--nan-guard", action="store_true",
        help="probe the state for non-finite values at every checkpoint "
        "boundary; abort (without checkpointing the poisoned state) so a "
        "supervisor can restart from the last good checkpoint with --resume",
    )
    parser.add_argument("--virtual", type=int, default=0, help="N virtual CPU devices")
    parser.add_argument(
        "--multihost", action="store_true",
        help="initialize jax.distributed before device discovery "
        "(coordinator/process ids from JAX_COORDINATOR_ADDRESS etc.)",
    )
    cli = parser.parse_args(argv)

    if cli.fused_loop and (cli.checkpoint_dir or cli.resume or cli.nan_guard):
        parser.error(
            "--fused-loop runs all steps inside one jitted loop; the "
            "checkpoint/resume/nan-guard machinery never sees intermediate "
            "states there.  Drop --fused-loop or the checkpointing flags."
        )

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
    if cli.multihost:
        from tasmania_jax.parallel.multihost import initialize_distributed

        initialize_distributed()
    import jax.numpy as jnp

    import drivers.namelist_sus as nl
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.utils.timer import Timer

    if cli.nx:
        nl.nx = cli.nx
    if cli.ny:
        nl.ny = cli.ny
    elif cli.nx:
        nl.ny = cli.nx
    if cli.nz:
        nl.nz = cli.nz
    if cli.niter:
        nl.niter = cli.niter
    if cli.backend:
        nl.backend = cli.backend

    domain, state, step = make_step(nl)
    cgrid = domain.numerical_grid
    nt = nl.niter

    hs_steady = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()
    dt_s = nl.timestep.total_seconds()

    field_names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in field_names}
    dims = {k: state[k].dims for k in field_names}

    step_c = jax.jit(step, donate_argnums=(0,)) if not cli.no_jit else step
    guard_probe = jax.jit(
        lambda f: sum(jnp.sum(jnp.abs(v)) for v in f.values())
    )

    # copy: step_c donates its inputs, and the initial arrays are shared with
    # hb.reference_state (closure constants of the trace) — donating the
    # originals leaves deleted buffers behind any later retrace
    fields = {k: jnp.array(state[k].data) for k in field_names}

    if cli.spmd:
        from tasmania_jax.parallel import make_mesh

        mesh = make_mesh(jax.devices())
        print(f"SPMD mesh: {mesh.devices.shape}")
        fields = {k: jax.device_put(v, spmd_sharding(v, mesh)) for k, v in fields.items()}
        hs_steady = jax.device_put(hs_steady, spmd_sharding(hs_steady, mesh))
        field_sharding = {k: v.sharding for k, v in fields.items()}
    else:
        field_sharding = None

    if cli.fused_loop:
        # all steps inside ONE jitted while-loop: no per-step dispatch from
        # the host.  The loop carries ONLY the fields the step actually reads
        # (the prognostics + a few recurrences); every pure diagnostic is
        # recomputed inside the step anyway, and carrying it would round-trip
        # ~75 MB of never-read data through device memory per iteration.  The
        # last step runs the full function so the final state is complete.
        from tasmania_jax.utils.jitx import carry_read_set

        read = carry_read_set(step, fields, hs_steady)
        dead = {k: jnp.zeros_like(v) for k, v in fields.items() if k not in read}
        print(f"fused loop carries {len(read)}/{len(fields)} fields")

        carry_dtype = jnp.bfloat16 if cli.bf16_carry else None

        def step_reduced(carry, hs):
            if carry_dtype is not None:
                carry = {k: v.astype(nl.so.dtype) for k, v in carry.items()}
            out = step({**dead, **carry}, hs)
            if carry_dtype is not None:
                return {k: out[k].astype(carry_dtype) for k in carry}
            return {k: out[k] for k in carry}

        def run_all(carry, hs, n):
            def body(i, carry):
                fact = jnp.minimum((i + 1.0) * dt_s / topo_time, 1.0)
                return step_reduced(carry, fact * hs)
            carry = jax.lax.fori_loop(0, n - 1, body, carry)
            # final step in full so diagnostics are materialized
            if carry_dtype is not None:
                carry = {k: v.astype(nl.so.dtype) for k, v in carry.items()}
            fact = jnp.minimum(n * dt_s / topo_time, 1.0)
            return step({**dead, **carry}, fact * hs)

        carry0 = {k: v for k, v in fields.items() if k in read}
        if carry_dtype is not None:
            carry0 = {k: v.astype(carry_dtype) for k, v in carry0.items()}

        # one program serves every step count (n is a traced loop bound)
        t0 = time.perf_counter()
        run_all_c = (
            jax.jit(run_all, donate_argnums=(0,))
            .lower(carry0, hs_steady, jnp.int32(1))
            .compile()
        )
        out = jax.block_until_ready(
            run_all_c(dict(carry0), hs_steady * 0.0, jnp.int32(1))
        )
        compile_s = time.perf_counter() - t0
        carry0 = {k: out[k] for k in read}
        if carry_dtype is not None:
            carry0 = {k: v.astype(carry_dtype) for k, v in carry0.items()}
        print(f"compile+warmup: {compile_s:.1f} s", flush=True)

        Timer.reset()
        Timer.enabled = True
        t0 = time.perf_counter()
        with Timer.timing("compute_time"):
            fields = jax.block_until_ready(
                run_all_c(dict(carry0), hs_steady, jnp.int32(nt))
            )
        elapsed = time.perf_counter() - t0
        print("Simulation successfully completed. HOORAY!")
        u = np.asarray(fields["x_velocity_at_u_locations"])
        v = np.asarray(fields["y_velocity_at_v_locations"])
        umax = u[:, :-1].max() if u.shape[1] > 1 else u.max()
        vmax = v[:-1, :].max() if v.shape[0] > 1 else v.max()
        print(f"Validation: umax = {umax:.5f}, vmax = {vmax:.5f}")
        gps = cgrid.nx * cgrid.ny * cgrid.nz * nt / elapsed
        print(f"Compute time: {elapsed:.3f} s.")
        print(f"Throughput: {gps:.3e} gridpoints/s")
        return {
            "umax": float(umax), "vmax": float(vmax), "elapsed": elapsed,
            "gps": gps, "compile_s": compile_s,
            "memory_analysis": run_all_c.memory_analysis(),
        }

    # warm up (compile)
    t0 = time.perf_counter()
    fields = jax.block_until_ready(step_c(dict(fields), hs_steady * 0.0))
    print(f"compile+warmup: {time.perf_counter() - t0:.1f} s", flush=True)

    import contextlib

    from tasmania_jax.utils.timer import profile_trace

    # periodic sharded checkpoints + resume (SURVEY.md §5.3/5.4: failure
    # recovery = re-initialization from the latest orbax checkpoint)
    ckpt = None
    start = 0
    if cli.checkpoint_dir:
        import os as _os

        from tasmania_jax.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(_os.path.abspath(cli.checkpoint_dir))
        if cli.resume and ckpt.latest_step is not None:
            # under --spmd, restore directly onto the current mesh layout so
            # the resumed run keeps computing distributed (orbax re-shards
            # elastically even if the checkpoint was written on another
            # topology); without it the save-time / host-local layout is fine
            restored = ckpt.restore(sharding=field_sharding)
            missing = [k for k in field_names if k not in restored]
            if missing:
                print(
                    f"warning: checkpoint lacks {missing}; "
                    "keeping initial values for those fields"
                )
            fields = {
                k: (
                    jnp.asarray(restored[k].data)
                    if field_sharding is None
                    else restored[k].data
                )
                if k in restored
                else fields[k]
                for k in field_names
            }
            start = ckpt.latest_step
            print(f"resumed from checkpoint step {start}")

    def save_ckpt(step, fields):
        # wait=True: step_c donates its inputs, so the next step would free
        # these buffers under an async serializer
        ckpt.save(
            step,
            {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()},
            force=True,
            wait=True,
        )

    prof = profile_trace(cli.profile) if cli.profile else contextlib.nullcontext()
    Timer.reset()
    Timer.enabled = True
    t0 = time.perf_counter()
    with prof, Timer.timing("compute_time"):
        for i in range(start, nt):
            fields = step_c(dict(fields), mountain_fraction(nl, i + 1) * hs_steady)
            at_boundary = (i + 1) % cli.checkpoint_every == 0
            if cli.nan_guard and at_boundary:
                # NaN/inf poisons the sum; one scalar fetch checks every field
                if not np.isfinite(float(guard_probe(fields))):
                    last = ckpt.latest_step if ckpt is not None else None
                    raise RuntimeError(
                        f"non-finite state detected at step {i + 1}; "
                        f"last good checkpoint: step {last} "
                        "(restart with --resume)"
                    )
            if ckpt is not None and at_boundary:
                save_ckpt(i + 1, fields)
        jax.block_until_ready(fields)
    elapsed = time.perf_counter() - t0
    if ckpt is not None:
        if nt % cli.checkpoint_every != 0:
            save_ckpt(nt, fields)
        ckpt.wait_until_finished()
        ckpt.close()

    print("Simulation successfully completed. HOORAY!")
    u = np.asarray(fields["x_velocity_at_u_locations"])
    v = np.asarray(fields["y_velocity_at_v_locations"])
    umax = u[:, :-1].max() if u.shape[1] > 1 else u.max()
    vmax = v[:-1, :].max() if v.shape[0] > 1 else v.max()
    print(f"Validation: umax = {umax:.5f}, vmax = {vmax:.5f}")
    gps = cgrid.nx * cgrid.ny * cgrid.nz * max(nt - start, 1) / elapsed
    print(f"Compute time: {elapsed:.3f} s.")
    print(f"Throughput: {gps:.3e} gridpoints/s")
    return {"umax": float(umax), "vmax": float(vmax), "elapsed": elapsed, "gps": gps}


if __name__ == "__main__":
    main()
