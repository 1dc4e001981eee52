"""Mountain-wave validation vs the analytic isothermal solution
(Durran 1981; reference ``utils/meteo.py:51``) — BASELINE config 3.

Two gates (VERDICT r4 next #3):

* the FAST SMOKE below (shallow domain, 81x60, 5 h, ~40 s) keeps loose
  thresholds — its configuration's ~λz/3 Rayleigh absorber partially
  reflects the wave (docs/mountain_wave_validation.md), capping what any
  numerics could score;
* ``test_deep_domain_validation_gate`` asserts the attribution study's
  result with the DIAGNOSED configuration (θ-top 420 K, sponge ≥ λz,
  161x120, 10 h): mountain-window correlation ≥ 0.95 (measured 0.983).
  The 1800-step in-jit loop runs in ~35 s on this box.
"""

import os
from datetime import datetime

import numpy as np
import pytest

import jax

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


def test_linear_mountain_wave_matches_analytic_solution():
    """2-D isothermal flow over a 1-m Witch-of-Agnesi mountain: after ~5 h the
    simulated u-perturbation matches the analytic steady wave in pattern
    (corr > 0.6) and amplitude (50–120%)."""
    T0, cp, g0 = 300.0, 1004.0, 9.80665
    N = g0 / np.sqrt(cp * T0)  # isothermal Brunt-Vaisala frequency
    h, a_w = 1.0, 1e4

    domain = Domain(
        (-2e5, 2e5), 81, (0.0, 1.0), 1,
        FieldArray(np.array([360.0, 300.0]), "K", ("z",)), 60,
        horizontal_boundary_type="relaxed", nb=3,
        horizontal_boundary_kwargs={"nr": 6},
        topography_type="user_defined",
        topography_kwargs={"profile": lambda x, y: h * a_w**2 / (x**2 + a_w**2)},
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
        damp=True, damp_depth=12, damp_max=0.0005, damp_at_every_stage=False,
        smooth=False,
    )
    dd = DynDiag(cgrid)

    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}

    def step(fields):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st = core(st, {}, 20.0)
        mtg = dd.get_montgomery_potential(st["air_isentropic_density"].data, pt)
        st["montgomery_potential"] = st["montgomery_potential"].with_data(mtg)
        return {k: st[k].data for k in names}

    stepc = jax.jit(step)
    fields = {k: state[k].data for k in names}
    for _ in range(900):
        fields = stepc(fields)

    u_num = np.asarray(fields["x_velocity_at_u_locations"])[:, 3, :]
    u_an, _ = get_isothermal_isentropic_analytical_solution(
        domain.physical_grid,
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(T0), "K", ()),
        FieldArray(np.asarray(h), "m", ()),
        FieldArray(np.asarray(a_w), "m", ()),
    )
    du_num = u_num - 10.0
    du_an = u_an[:, 0, :] - 10.0
    sl = (slice(10, -10), slice(15, None))  # away from sponge + lateral frame
    corr = np.corrcoef(du_num[sl].ravel(), du_an[sl].ravel())[0, 1]
    amp = np.abs(du_num[sl]).max() / np.abs(du_an[sl]).max()
    assert corr > 0.6, f"wave-pattern correlation too low: {corr}"
    assert 0.5 < amp < 1.2, f"wave amplitude ratio off: {amp}"

    # focused window |x| <= 6a: where the analytic signal stands above the
    # start-up transient noise floor (the 1/x far-field tail dilutes the
    # domain-wide correlation; see drivers/driver_mountain_wave.py) the
    # pattern match is strong even at this coarse resolution
    xs = np.asarray(domain.physical_grid.x_at_u_locations.data)
    m = np.abs(xs) <= 6.0 * a_w
    corr_f = np.corrcoef(
        du_num[m, 15:].ravel(), du_an[m, 15:].ravel()
    )[0, 1]
    assert corr_f > 0.85, f"focused wave-pattern correlation too low: {corr_f}"


def test_deep_domain_validation_gate():
    """The attribution study's diagnosed configuration as the tested gate
    (docs/mountain_wave_validation.md): deep domain (θ-top 420 K ≈ 10.3 km,
    Rayleigh sponge 2.6–5 km ≥ λz), 161x120, 10 h — the top absorber no
    longer reflects the wave, so the mountain-window pattern correlation
    must clear 0.95 (measured: 2a 0.983, 3a 0.977, 4a 0.969)."""
    import importlib

    import drivers.driver_mountain_wave as mw

    importlib.reload(mw)
    old = {k: os.environ.get(k) for k in ("MW_THETA_TOP", "MW_DAMP_DEPTH")}
    os.environ["MW_THETA_TOP"] = "420"
    os.environ["MW_DAMP_DEPTH"] = "60"
    try:
        r = mw.run_case(161, 120, 10.0, 20.0, 0.0)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    u_num, u_an, xs, kd = r.pop("_fields")
    a_w = 1e4

    def wcorr(mult):
        m = np.abs(xs) <= mult * a_w
        dn = u_num[m, kd + 4 :] - 10.0
        da = u_an[m, kd + 4 :] - 10.0
        return float(np.corrcoef(dn.ravel(), da.ravel())[0, 1]), dn, da

    c2, dn, da = wcorr(2)
    c4, _, _ = wcorr(4)
    assert c2 >= 0.95, f"mountain-window (2a) correlation {c2} < 0.95"
    assert c4 >= 0.93, f"4a-window correlation {c4} < 0.93"
    amp = np.abs(dn).max() / np.abs(da).max()
    assert 0.7 < amp < 1.2, f"amplitude ratio {amp} (resolution-limited at 161)"
