"""Unified moist isentropic benchmark driver — all six coupling variants.

JAX re-design of reference
``drivers/benchmarking/isentropic_moist/driver_namelist_{fc,lfc,ps,sts,sus,ssus}.py``:

* ``fc``   — full concurrent coupling: physics as the dycore's fast tendency
  component, diagnostics as its fast diagnostic component, slow diagnostics
  (fall velocity, precipitation, smoothing, velocities) after the step;
* ``lfc``  — "lazy" fc: slow tendencies evaluated once per step outside the
  dycore and passed as the ``tendencies`` argument;
* ``ps``   — parallel splitting of the physics against the dycore output;
* ``sts``  — sequential-tendency splitting (physics tendencies evaluated on
  the current state, applied to the dycore's provisional state);
* ``sus``  — sequential-update splitting (see driver_namelist_sus.py);
* ``ssus`` — symmetrized SUS: half the physics before the dynamics, half
  after.

Every variant compiles its full timestep into one jitted function with the
growing topography as a traced input.

Usage: ``python drivers/driver_isentropic_moist.py --coupling fc [--nx N] ...``
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build_components(nl, domain, pt, common):
    """All physics components used across the variants."""
    from tasmania_jax.isentropic.physics import (
        IsentropicConservativeCoriolis,
        IsentropicDiagnostics,
        IsentropicHorizontalSmoothing,
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

    c = {}
    c["dv"] = IsentropicDiagnostics(domain, "numerical", moist=True, pt=pt, **common)
    c["turb"] = IsentropicSmagorinsky(domain, nl.smagorinsky_constant, **common)
    c["vc"] = IsentropicVelocityComponents(domain, **common)
    c["t2d"] = AirPotentialTemperatureToDiagnostic(domain, "numerical", **common)
    c["d2t"] = AirPotentialTemperatureToTendency(domain, "numerical", **common)
    c["ke"] = KesslerMicrophysics(
        domain,
        "numerical",
        air_pressure_on_interface_levels=True,
        rain_evaporation=nl.rain_evaporation,
        autoconversion_threshold=nl.autoconversion_threshold,
        autoconversion_rate=nl.autoconversion_rate,
        collection_rate=nl.collection_rate,
        **common,
    )
    c["sa"] = KesslerSaturationAdjustmentPrognostic(
        domain, "numerical", saturation_rate=nl.saturation_rate, **common
    )
    c["vf"] = IsentropicVerticalAdvection(
        domain, flux_scheme=nl.vertical_flux_scheme, moist=True, **common
    )
    c["rfv"] = KesslerFallVelocity(domain, "numerical", **common)
    c["sd"] = KesslerSedimentation(
        domain,
        "numerical",
        sedimentation_flux_scheme=nl.sedimentation_flux_scheme,
        **common,
    )
    c["ap"] = Precipitation(domain, "numerical", **common)
    c["hs"] = IsentropicHorizontalSmoothing(
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
    if nl.coriolis_parameter is not None:
        c["cf"] = IsentropicConservativeCoriolis(
            domain, "numerical", nl.coriolis_parameter, **common
        )
    return c


def build_variant(nl, coupling: str):
    import jax.numpy as jnp

    from drivers.driver_namelist_sus import build as build_sus
    from tasmania_jax.domain import Domain
    from tasmania_jax.framework import ConcurrentCoupling, TimeIntegrationOptions
    from tasmania_jax.framework.dict_operator import DictOperator
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.framework.splitting import (
        ParallelSplitting,
        SequentialTendencySplitting,
        SequentialUpdateSplitting,
    )
    from tasmania_jax.isentropic import (
        IsentropicDynamicalCore,
        get_isentropic_state_from_brunt_vaisala_frequency,
    )

    if coupling == "sus":
        domain, dycore, physics, state = build_sus(nl)

        def step_impl(st, dt_s):
            st = dycore(st, {}, dt_s)
            return physics(st, dt_s)

        return domain, state, step_impl

    common = dict(backend=nl.backend, backend_options=nl.bo, storage_options=nl.so)
    domain = Domain(
        nl.domain_x, nl.nx, nl.domain_y, nl.ny, nl.domain_z, nl.nz,
        horizontal_boundary_type=nl.hb_type, nb=nl.nb,
        horizontal_boundary_kwargs=nl.hb_kwargs,
        topography_type=nl.topo_type, topography_kwargs=nl.topo_kwargs,
        **common,
    )
    cgrid = domain.numerical_grid
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        cgrid, nl.init_time, nl.x_velocity, nl.y_velocity, nl.brunt_vaisala,
        moist=True, precipitation=nl.sedimentation,
        relative_humidity=nl.relative_humidity,
        backend=nl.backend, storage_options=nl.so,
    )
    domain.horizontal_boundary.reference_state = state
    shp = (cgrid.nx, cgrid.ny, cgrid.nz)
    state["tendency_of_air_potential_temperature"] = FieldArray(
        jnp.zeros(shp, dtype=nl.so.dtype), "K s^-1", ("x", "y", "z")
    )
    pt_v = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    pt = FieldArray(np.asarray(pt_v), "Pa", ())
    c = build_components(nl, domain, pt, common)
    dict_op = DictOperator()

    def make_dycore(fast_tends=None, fast_diags=None):
        return IsentropicDynamicalCore(
            domain,
            moist=True,
            fast_tendency_component=fast_tends,
            fast_diagnostic_component=fast_diags,
            time_integration_scheme=nl.time_integration_scheme,
            horizontal_flux_scheme=nl.horizontal_flux_scheme,
            time_integration_properties={"pt": pt, "eps": nl.eps},
            damp=nl.damp, damp_type=nl.damp_type, damp_depth=nl.damp_depth,
            damp_max=nl.damp_max, damp_at_every_stage=nl.damp_at_every_stage,
            smooth=False, smooth_moist=False,
            enable_checks=nl.enable_checks,
            **common,
        )

    ptis = nl.physics_time_integration_scheme

    if coupling in ("fc", "lfc"):
        # physics chain as one concurrent coupling (reference driver_namelist_fc)
        chain = [c["turb"], c["ke"], c["sa"], c["t2d"], c["vf"], c["rfv"], c["sd"]]
        if "cf" in c:
            chain.insert(0, c["cf"])
        tend_cc = ConcurrentCoupling(*chain, execution_policy="serial")
        slow_diags = ConcurrentCoupling(
            c["rfv"], c["ap"], c["hs"], c["vc"], execution_policy="serial"
        )
        if coupling == "fc":
            dycore = make_dycore(fast_tends=tend_cc, fast_diags=c["dv"])

            def step_impl(st, dt_s):
                st = dycore(st, {}, dt_s)
                _, diags = slow_diags(st, dt_s)
                return dict_op.update(st, diags)

        else:  # lfc: tendencies evaluated lazily, once per step
            dycore = make_dycore()
            dv = c["dv"]

            def step_impl(st, dt_s):
                tends, diags = tend_cc(st, dt_s)
                st = dict_op.update(st, diags)
                st = dycore(st, tends, dt_s)
                st = dict_op.update(st, dv(st))
                _, diags2 = slow_diags(st, dt_s)
                return dict_op.update(st, diags2)

        return domain, state, step_impl

    # splitting-based variants share the SUS-style option list
    args = [TimeIntegrationOptions(component=c["dv"])]
    if "cf" in c:
        args.append(TimeIntegrationOptions(component=c["cf"], scheme=ptis))
    if nl.smooth:
        args.append(TimeIntegrationOptions(component=c["hs"]))
    args.append(TimeIntegrationOptions(component=c["turb"], scheme=ptis))
    args.append(TimeIntegrationOptions(component=c["vc"]))
    args.append(
        TimeIntegrationOptions(
            component=ConcurrentCoupling(c["ke"], c["t2d"], execution_policy="serial"),
            scheme=ptis,
        )
    )
    args.append(
        TimeIntegrationOptions(
            component=ConcurrentCoupling(
                c["d2t"], c["sa"], c["t2d"], execution_policy="serial"
            ),
            scheme=ptis,
        )
    )
    if nl.vertical_advection:
        args.append(TimeIntegrationOptions(component=c["vf"], scheme="rk3ws"))
    args.append(
        TimeIntegrationOptions(
            component=ConcurrentCoupling(c["rfv"], c["sd"], execution_policy="serial"),
            scheme="rk3ws",
        )
    )
    args.append(
        TimeIntegrationOptions(
            component=ConcurrentCoupling(c["rfv"], c["ap"], execution_policy="serial")
        )
    )

    dycore = make_dycore()

    if coupling == "ps":
        physics = ParallelSplitting(
            *args, execution_policy="serial",
            retrieve_diagnostics_from_provisional_state=False,
        )

        def step_impl(st, dt_s):
            prv = dycore(st, {}, dt_s)
            cur, prv = physics(st, prv, dt_s)
            return dict_op.update(cur, prv)

    elif coupling == "sts":
        physics = SequentialTendencySplitting(*args)

        def step_impl(st, dt_s):
            prv = dycore(st, {}, dt_s)
            cur, prv = physics(st, prv, dt_s)
            return dict_op.update(cur, prv)

    elif coupling == "ssus":
        half = len(args) // 2
        before = SequentialUpdateSplitting(*args[:half])
        after = SequentialUpdateSplitting(*args[half:])

        def step_impl(st, dt_s):
            st = before(st, dt_s)
            st = dycore(st, {}, dt_s)
            return after(st, dt_s)

    else:
        raise ValueError(f"unknown coupling {coupling!r}")

    return domain, state, step_impl


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--coupling", choices=("fc", "lfc", "ps", "sts", "sus", "ssus"), default="sus"
    )
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--platform", type=str, default=None)
    parser.add_argument("--backend", type=str, default=None)
    cli = parser.parse_args(argv)

    import jax

    from tasmania_jax.utils.device import configure_compile_cache

    configure_compile_cache()
    if cli.platform:
        jax.config.update("jax_platforms", cli.platform)
    import jax.numpy as jnp

    import importlib

    # each coupling variant consumes ITS namelist module (reference ships six
    # namelist_{fc,lfc,ps,sts,sus,ssus}.py; see the per-variant modules for
    # the verified constant parity)
    nl = importlib.import_module(f"drivers.namelist_{cli.coupling}")
    from tasmania_jax.framework.field import FieldArray

    if cli.nx:
        nl.nx = cli.nx
        nl.ny = cli.ny or cli.nx
    if cli.nz:
        nl.nz = cli.nz
    if cli.niter:
        nl.niter = cli.niter
    if cli.backend:
        nl.backend = cli.backend

    domain, state, step_impl = build_variant(nl, cli.coupling)
    cgrid = domain.numerical_grid
    dt_s = nl.timestep.total_seconds()
    nt = nl.niter

    hs_steady = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )
    topo_time = nl.topo_kwargs["time"].total_seconds()

    field_names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in field_names}
    dims = {k: state[k].dims for k in field_names}

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = step_impl(st, dt_s)
        return {k: st[k].data for k in field_names}

    step_c = jax.jit(step, donate_argnums=(0,))
    # copy: the initial arrays are shared with hb.reference_state, and step_c
    # donates its inputs
    fields = {k: jnp.array(state[k].data) for k in field_names}

    t0 = time.perf_counter()
    fields = jax.block_until_ready(step_c(dict(fields), hs_steady * 0.0))
    compile_s = time.perf_counter() - t0
    print(f"[{cli.coupling}] compile+warmup: {compile_s:.1f} s", flush=True)

    t0 = time.perf_counter()
    for i in range(nt):
        fact = min((i + 1) * dt_s / topo_time, 1.0)
        fields = step_c(dict(fields), fact * hs_steady)
    jax.block_until_ready(fields)
    elapsed = time.perf_counter() - t0

    print("Simulation successfully completed. HOORAY!")
    u = np.asarray(fields["x_velocity_at_u_locations"])
    v = np.asarray(fields["y_velocity_at_v_locations"])
    umax, vmax = u[:, :-1].max(), v[:-1, :].max()
    gps = cgrid.nx * cgrid.ny * cgrid.nz * nt / elapsed
    print(f"Validation: umax = {umax:.5f}, vmax = {vmax:.5f}")
    print(f"Compute time: {elapsed:.3f} s.")
    print(f"Throughput: {gps:.3e} gridpoints/s")
    return {
        "umax": float(umax), "vmax": float(vmax), "elapsed": elapsed, "gps": gps,
        "compile_s": compile_s,
    }


if __name__ == "__main__":
    main()
