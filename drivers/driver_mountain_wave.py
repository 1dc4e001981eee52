"""Linear mountain-wave validation driver — BASELINE config 3.

Runs 2-D isothermal flow over a 1-m Witch-of-Agnesi mountain and compares the
steady u-perturbation with the analytic solution (Durran 1981; reference
``src/tasmania/utils/meteo.py:51``), printing pattern correlation and
amplitude ratio.  Use ``--sweep`` for the resolution-convergence study
(TODO.md validation item).

Usage: python drivers/driver_mountain_wave.py [--nx 81] [--nz 60]
       [--hours 5] [--dt 20] [--platform cpu] [--sweep]
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def run_case(nx: int, nz: int, hours: float, dt_s: float,
             growth_hours: float = 0.0):
    """``growth_hours > 0`` grows the mountain linearly over that time (the
    reference benchmark's own smooth turn-on, ``namelist_sus.py:113-117``)
    instead of the impulsive t=0 start — the start-up transient, identified
    as the dominant noise floor of the full-window correlation (see
    ``--diagnose``), is then never excited."""
    import jax
    import jax.numpy as jnp

    from datetime import timedelta

    from tasmania_jax.domain import Domain
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.isentropic import (
        IsentropicDynamicalCore,
        get_isentropic_state_from_brunt_vaisala_frequency,
    )
    from tasmania_jax.isentropic.dynamics.diagnostics import (
        IsentropicDiagnostics as DynDiag,
    )
    from tasmania_jax.utils.meteo import get_isothermal_isentropic_analytical_solution

    T0, cp, g0 = 300.0, 1004.0, 9.80665
    N = g0 / np.sqrt(cp * T0)
    h, a_w = 1.0, 1e4

    import os

    xl = float(os.environ.get("MW_XHALF", "2e5"))  # domain half-width
    th_top = float(os.environ.get("MW_THETA_TOP", "360.0"))
    dampd = int(os.environ.get("MW_DAMP_DEPTH", str(max(8, nz // 5))))
    dampm = float(os.environ.get("MW_DAMP_MAX", "0.0005"))
    topo_kwargs = {"profile": lambda x, y: h * a_w**2 / (x**2 + a_w**2)}
    if growth_hours > 0.0:
        topo_kwargs["time"] = timedelta(hours=growth_hours)
    domain = Domain(
        (-xl, xl), nx, (0.0, 1.0), 1,
        FieldArray(np.array([th_top, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=3,
        horizontal_boundary_kwargs={"nr": 6},
        topography_type="user_defined",
        topography_kwargs=topo_kwargs,
    )
    cgrid = domain.numerical_grid
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        cgrid, datetime(2000, 1, 1),
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(N), "s^-1", ()),
    )
    domain.horizontal_boundary.reference_state = state
    pt = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    core = IsentropicDynamicalCore(
        domain, moist=False,
        time_integration_scheme="rk3ws_si",
        horizontal_flux_scheme="third_order_upwind",
        time_integration_properties={"pt": pt, "eps": 0.5},
        damp=True, damp_depth=dampd, damp_max=dampm,
        damp_at_every_stage=False,
        smooth=False,
    )
    dd = DynDiag(cgrid)

    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    hs_steady = jnp.asarray(
        np.asarray(cgrid.topography.steady_profile.to_units("m").data)
    )

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = core(st, {}, dt_s)
        mtg = dd.get_montgomery_potential(
            st["air_isentropic_density"].data, pt, hs=hs
        )
        st["montgomery_potential"] = st["montgomery_potential"].with_data(mtg)
        return {k: st[k].data for k in names}

    nt = int(round(hours * 3600.0 / dt_s))
    growth_s = growth_hours * 3600.0

    @jax.jit
    def run_all(fields, n):
        def body(i, f):
            if growth_s > 0.0:
                fact = jnp.minimum((i + 1.0) * dt_s / growth_s, 1.0)
            else:
                fact = 1.0
            return step(f, fact * hs_steady)

        return jax.lax.fori_loop(0, n, body, fields)

    fields = {k: state[k].data for k in names}
    fields = run_all(fields, nt)
    u_num = np.asarray(
        jnp.asarray(fields["x_velocity_at_u_locations"])
    )[:, 0, :]

    u_an, _ = get_isothermal_isentropic_analytical_solution(
        domain.physical_grid,
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(T0), "K", ()),
        FieldArray(np.asarray(h), "m", ()),
        FieldArray(np.asarray(a_w), "m", ()),
    )
    u_an = np.asarray(u_an.data)[:, 0, :]

    # compare perturbations on the interior, away from the sponge
    kd = dampd
    du_n2 = u_num[6:-6, kd + 4 :] - 10.0
    du_a2 = u_an[6:-6, kd + 4 :] - 10.0
    corr = float(np.corrcoef(du_n2.ravel(), du_a2.ravel())[0, 1])
    amp = float(np.abs(du_n2).max() / np.abs(du_a2).max())

    # focused metrics over |x| <= 6a: the analytic wave decays like 1/x, so
    # beyond a few half-widths the signal sits below the noise floor left by
    # the impulsive start (transients advect out at U, reflect weakly off the
    # relaxed inflow/outflow) — the far field contributes only noise to the
    # domain-wide correlation.  Diagnosed per-region (round 2): corr ~0.96
    # over the mountain, ~0.08 for x > 50 km where rms_analytic is ~2e-3 m/s.
    xs = np.asarray(domain.physical_grid.x_at_u_locations.data)
    m = np.abs(xs) <= 6.0 * a_w
    du_nf = u_num[m, kd + 4 :] - 10.0
    du_af = u_an[m, kd + 4 :] - 10.0
    corr_f = float(np.corrcoef(du_nf.ravel(), du_af.ravel())[0, 1])
    # rms error over the focused window: the convergence-order quantity
    err = float(np.sqrt(np.mean((du_nf - du_af) ** 2)))
    return {"nx": nx, "nz": nz, "hours": hours, "dt": dt_s,
            "corr": round(corr, 4), "corr_focused": round(corr_f, 4),
            "rms_err_focused": err, "amplitude_ratio": round(amp, 4),
            "_fields": (u_num, u_an, xs, kd)}


def diagnose(nx: int, nz: int, hours: float, dt_s: float,
             growth_hours: float = 0.0):
    """Attribution study for the full-window correlation plateau (VERDICT r3
    item 4): correlation / signal / noise as a function of the comparison
    window, swept against the x-extent (in mountain half-widths) and the
    vertical sponge clearance."""
    r = run_case(nx, nz, hours, dt_s, growth_hours)
    u_num, u_an, xs, kd = r.pop("_fields")
    print(json.dumps(r), flush=True)
    a_w = 1e4
    rows = []
    for xfac in (2.0, 4.0, 6.0, 10.0, 20.0, 1e9):
        m = np.abs(xs) <= xfac * a_w
        for koff in (0, 4, 8):
            dn = u_num[m, kd + koff :] - 10.0
            da = u_an[m, kd + koff :] - 10.0
            rows.append({
                "window_halfwidths": xfac if xfac < 1e8 else "full",
                "sponge_clearance": koff,
                "corr": round(float(np.corrcoef(dn.ravel(), da.ravel())[0, 1]), 4),
                "rms_analytic": float(np.sqrt(np.mean(da**2))),
                "rms_error": float(np.sqrt(np.mean((dn - da) ** 2))),
            })
    for row in rows:
        print(json.dumps(row), flush=True)
    # error localization: steady-noise attribution (upstream reflection vs
    # downstream dispersive wake vs top-sponge leakage)
    err = (u_num - u_an)[:, kd + 4 :]
    half = len(xs) // 2
    loc = {
        "rms_upstream(x<-2a)": float(
            np.sqrt(np.mean(err[xs < -2 * a_w] ** 2))
        ),
        "rms_mountain(|x|<2a)": float(
            np.sqrt(np.mean(err[np.abs(xs) <= 2 * a_w] ** 2))
        ),
        "rms_downstream(x>2a)": float(
            np.sqrt(np.mean(err[xs > 2 * a_w] ** 2))
        ),
        "rms_by_k_quartile_top_to_sfc": [
            float(np.sqrt(np.mean(
                err[:, q * err.shape[1] // 4 : (q + 1) * err.shape[1] // 4]
                ** 2
            )))
            for q in range(4)
        ],
    }
    print(json.dumps(loc), flush=True)
    np.savez("/tmp/mw_fields.npz", u_num=u_num, u_an=u_an, xs=xs, kd=kd)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=81)
    ap.add_argument("--nz", type=int, default=60)
    ap.add_argument("--hours", type=float, default=5.0)
    ap.add_argument("--dt", type=float, default=20.0)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="resolution-convergence study")
    ap.add_argument("--diagnose", action="store_true",
                    help="window/sponge attribution study at (--nx, --nz)")
    ap.add_argument("--growth-hours", type=float, default=0.0,
                    help="grow the mountain linearly over this many hours")
    cli = ap.parse_args(argv)
    import jax

    from tasmania_jax.utils.device import configure_compile_cache

    configure_compile_cache()
    if cli.platform:
        jax.config.update("jax_platforms", cli.platform)

    if cli.diagnose:
        return diagnose(cli.nx, cli.nz, cli.hours, cli.dt, cli.growth_hours)

    if cli.sweep:
        results = [
            run_case(81, 60, cli.hours, 20.0, cli.growth_hours),
            run_case(161, 90, cli.hours, 10.0, cli.growth_hours),
            run_case(321, 120, cli.hours, 5.0, cli.growth_hours),
        ]
    else:
        results = [run_case(cli.nx, cli.nz, cli.hours, cli.dt, cli.growth_hours)]
    for r in results:
        r.pop("_fields", None)
        print(json.dumps(r), flush=True)
    if cli.sweep:
        # observed convergence order from the focused rms error (dx halves
        # between consecutive cases)
        for a, b in zip(results, results[1:]):
            p = np.log2(a["rms_err_focused"] / b["rms_err_focused"])
            print(json.dumps({
                "convergence_order": round(float(p), 3),
                "from_nx": a["nx"], "to_nx": b["nx"],
            }), flush=True)
    return results


if __name__ == "__main__":
    main()
