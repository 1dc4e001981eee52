"""Hypothesis suite coverage: all steppers x couplers x isentropic prognostics.

The reference's test style (SURVEY.md §4; ``tests/suites/steppers.py:123,194``,
``tests/suites/{concurrent_coupling,*_splitting}.py``) applied with the
strategy library (tests/strategies.py): random domains/states/timesteps, each
stepper and coupler checked against an INDEPENDENT numpy re-derivation of its
stage algebra over a NONLINEAR tendency (so every stage evaluation point
matters, not just the amplification factor), across the numpy and jax
backends; the isentropic prognostic schemes checked against a standalone numpy
re-derivation of the semi-implicit stage recurrence.
"""

from datetime import timedelta

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hyp_st

from tasmania_jax.framework import (
    ConcurrentCoupling,
    ParallelSplitting,
    SequentialTendencySplitting,
    SequentialUpdateSplitting,
    SequentialTendencyStepper,
    TendencyComponent,
    TendencyStepper,
    TimeIntegrationOptions,
)
from tasmania_jax.framework.field import FieldArray

from strategies import st_domain, st_raw_field, st_rng

DIMS3 = ("x", "y", "z")
hyp = settings(max_examples=10, deadline=None)


class Quadratic(TendencyComponent):
    """d(phi)/dt = a·phi² — nonlinear, so each stage's evaluation point shows
    up in the result."""

    def __init__(self, domain, a, **kwargs):
        super().__init__(domain, "numerical", **kwargs)
        self.a = a

    @property
    def input_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-2"}}

    def array_call(self, state):
        return {"phi": self.a * state["phi"] * state["phi"]}, {}


def _phi_state(domain, draw_field, units="m s^-1"):
    g = domain.numerical_grid
    data = draw_field((g.nx, g.ny, g.nz))
    return {"phi": FieldArray(data, units, DIMS3)}


# --------------------------------------------------------------------------- #
# tendency steppers: numpy oracles of the exact stage algebra                  #
# (framework/steppers.py:188-260)                                              #
# --------------------------------------------------------------------------- #

def _oracle_stepper(scheme, phi, f, dt):
    if scheme == "forward_euler":
        return phi + dt * f(phi)
    if scheme in ("rk2", "rk2sa"):
        s1 = phi + 0.5 * dt * f(phi)
        return phi + dt * f(s1)
    if scheme == "rk3ws":
        s1 = phi + dt / 3.0 * f(phi)
        s2 = phi + 0.5 * dt * f(s1)
        return phi + dt * f(s2)
    raise ValueError(scheme)


@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk2sa", "rk3ws"])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
@hyp
@given(data=hyp_st.data())
def test_tendency_stepper_vs_oracle(scheme, backend, data):
    domain = data.draw(
        st_domain(boundary_types=("identity",), nz_range=(1, 4), backend=backend)
    )
    a = data.draw(hyp_st.floats(-0.5, 0.5, allow_subnormal=False))
    dt = data.draw(hyp_st.floats(0.1, 10.0))
    g = domain.numerical_grid
    phi0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )

    import jax.numpy as jnp

    stepper = TendencyStepper.factory(scheme, Quadratic(domain, a, backend=backend))
    data0 = phi0 if backend == "numpy" else jnp.asarray(phi0)
    state = {"phi": FieldArray(data0, "m s^-1", DIMS3)}
    _, out = stepper(state, dt)

    expected = _oracle_stepper(scheme, phi0, lambda p: a * p * p, dt)
    np.testing.assert_allclose(
        np.asarray(out["phi"].data), expected, rtol=1e-12, err_msg=scheme
    )


def _oracle_sts_stepper(scheme, phi, prv, f, dt):
    """framework/steppers.py:266-307 + dict_operator sts stage combos."""
    if scheme == "forward_euler":
        return prv + dt * f(phi)
    if scheme == "rk2":
        s1 = 0.5 * (phi + prv + dt * f(phi))
        return prv + dt * f(s1)
    if scheme == "rk3ws":
        s1 = (2.0 * phi + prv + dt * f(phi)) / 3.0
        s2 = 0.5 * (phi + prv + dt * f(s1))
        return prv + dt * f(s2)
    raise ValueError(scheme)


@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
@hyp
@given(data=hyp_st.data())
def test_sequential_tendency_stepper_vs_oracle(scheme, data):
    domain = data.draw(st_domain(boundary_types=("identity",), nz_range=(1, 3)))
    a = data.draw(hyp_st.floats(-0.5, 0.5, allow_subnormal=False))
    dt = data.draw(hyp_st.floats(0.1, 10.0))
    g = domain.numerical_grid
    shape = (g.nx, g.ny, g.nz)
    phi0 = np.asarray(data.draw(st_raw_field(shape, -1.0, 1.0, backend="numpy")))
    prv0 = np.asarray(data.draw(st_raw_field(shape, -1.0, 1.0, backend="numpy")))

    stepper = SequentialTendencyStepper.factory(scheme, Quadratic(domain, a))
    state = {"phi": FieldArray(phi0, "m s^-1", DIMS3)}
    prv = {"phi": FieldArray(prv0, "m s^-1", DIMS3)}
    _, out = stepper(state, prv, dt)

    expected = _oracle_sts_stepper(scheme, phi0, prv0, lambda p: a * p * p, dt)
    np.testing.assert_allclose(
        np.asarray(out["phi"].data), expected, rtol=1e-12, err_msg=scheme
    )


# --------------------------------------------------------------------------- #
# couplers: two nonlinear processes, numpy re-derivation of the splitting      #
# algebra (framework/splitting.py; concurrent_coupling.py)                     #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["serial", "as_parallel"])
@hyp
@given(data=hyp_st.data())
def test_concurrent_coupling_sums_tendencies(policy, data):
    domain = data.draw(st_domain(boundary_types=("identity",), nz_range=(1, 3)))
    a1 = data.draw(hyp_st.floats(-0.5, 0.5, allow_subnormal=False))
    a2 = data.draw(hyp_st.floats(-0.5, 0.5, allow_subnormal=False))
    g = domain.numerical_grid
    phi0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    cc = ConcurrentCoupling(
        Quadratic(domain, a1), Quadratic(domain, a2), execution_policy=policy
    )
    state = {"phi": FieldArray(phi0, "m s^-1", DIMS3)}
    tends, _ = cc(state, timedelta(seconds=1.0))
    # no diagnostics are produced, so serial == as_parallel == plain sum
    # atol floor: when a1 ~ -a2 the sum cancels and the relative error of
    # (a1·p² + a2·p²) vs (a1+a2)·p² is unbounded (one extra rounding each)
    np.testing.assert_allclose(
        np.asarray(tends["phi"].data),
        (a1 + a2) * phi0 * phi0,
        rtol=1e-12,
        atol=1e-15,
    )


@hyp
@given(data=hyp_st.data())
def test_sequential_update_splitting_vs_oracle(data):
    domain = data.draw(st_domain(boundary_types=("identity",), nz_range=(1, 3)))
    a1 = data.draw(hyp_st.floats(-0.4, 0.4))
    a2 = data.draw(hyp_st.floats(-0.4, 0.4))
    dt = data.draw(hyp_st.integers(1, 50)) / 10.0  # us-exact (splittings use timedelta)
    g = domain.numerical_grid
    phi0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    sus = SequentialUpdateSplitting(
        TimeIntegrationOptions(component=Quadratic(domain, a1), scheme="forward_euler"),
        TimeIntegrationOptions(component=Quadratic(domain, a2), scheme="rk2"),
    )
    out = sus({"phi": FieldArray(phi0, "m s^-1", DIMS3)}, dt)

    f1 = lambda p: a1 * p * p
    f2 = lambda p: a2 * p * p
    mid = _oracle_stepper("forward_euler", phi0, f1, dt)
    expected = _oracle_stepper("rk2", mid, f2, dt)
    np.testing.assert_allclose(np.asarray(out["phi"].data), expected, rtol=1e-12)


@hyp
@given(data=hyp_st.data())
def test_parallel_splitting_vs_oracle(data):
    domain = data.draw(st_domain(boundary_types=("identity",), nz_range=(1, 3)))
    a1 = data.draw(hyp_st.floats(-0.4, 0.4))
    a2 = data.draw(hyp_st.floats(-0.4, 0.4))
    dt = data.draw(hyp_st.integers(1, 50)) / 10.0  # us-exact (splittings use timedelta)
    g = domain.numerical_grid
    phi0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    prv0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    ps = ParallelSplitting(
        TimeIntegrationOptions(component=Quadratic(domain, a1), scheme="forward_euler"),
        TimeIntegrationOptions(component=Quadratic(domain, a2), scheme="forward_euler"),
    )
    _, prv = ps(
        {"phi": FieldArray(phi0, "m s^-1", DIMS3)},
        {"phi": FieldArray(prv0, "m s^-1", DIMS3)},
        dt,
    )
    # prv += (stepped_i - state) for each process, both stepped from `state`
    expected = prv0 + dt * a1 * phi0 * phi0 + dt * a2 * phi0 * phi0
    np.testing.assert_allclose(np.asarray(prv["phi"].data), expected, rtol=1e-10)


@hyp
@given(data=hyp_st.data())
def test_sequential_tendency_splitting_vs_oracle(data):
    domain = data.draw(st_domain(boundary_types=("identity",), nz_range=(1, 3)))
    a1 = data.draw(hyp_st.floats(-0.4, 0.4))
    a2 = data.draw(hyp_st.floats(-0.4, 0.4))
    dt = data.draw(hyp_st.integers(1, 50)) / 10.0  # us-exact (splittings use timedelta)
    g = domain.numerical_grid
    phi0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    prv0 = np.asarray(
        data.draw(st_raw_field((g.nx, g.ny, g.nz), -1.0, 1.0, backend="numpy"))
    )
    sts = SequentialTendencySplitting(
        TimeIntegrationOptions(component=Quadratic(domain, a1), scheme="forward_euler"),
        TimeIntegrationOptions(component=Quadratic(domain, a2), scheme="rk2"),
    )
    _, prv = sts(
        {"phi": FieldArray(phi0, "m s^-1", DIMS3)},
        {"phi": FieldArray(prv0, "m s^-1", DIMS3)},
        dt,
    )
    f1 = lambda p: a1 * p * p
    f2 = lambda p: a2 * p * p
    # process 1: tendencies on `state`, applied to prv; process 2 sees the
    # UPDATED provisional state but still evaluates on `state`
    prv1 = _oracle_sts_stepper("forward_euler", phi0, prv0, f1, dt)
    expected = _oracle_sts_stepper("rk2", phi0, prv1, f2, dt)
    np.testing.assert_allclose(np.asarray(prv["phi"].data), expected, rtol=1e-10)


# --------------------------------------------------------------------------- #
# isentropic prognostics vs a standalone numpy re-derivation                    #
# (isentropic/dynamics/prognostic.py; reference rk3ws_si.py:105-231)           #
# --------------------------------------------------------------------------- #


def _np_upwind_flux_x(u, phi):
    uf = u[1:-1]
    return uf * np.where(uf > 0.0, phi[:-1], phi[1:])


def _np_upwind_flux_y(v, phi):
    vf = v[:, 1:-1]
    return vf * np.where(vf > 0.0, phi[:, :-1], phi[:, 1:])


def _np_montgomery(s, pt, dz, theta_s, hs, g=9.80665, rd=287.05, cp=1004.0, pref=1e5):
    """Standalone re-derivation of the hydrostatic column recurrence
    (isentropic/dynamics/diagnostics.py; reference diagnostics.py:320-471)."""
    nz = s.shape[2]
    p = np.empty((s.shape[0], s.shape[1], nz + 1))
    p[:, :, 0] = pt
    for k in range(1, nz + 1):
        p[:, :, k] = p[:, :, k - 1] + g * dz * s[:, :, k - 1]
    exn = cp * (p / pref) ** (rd / cp)
    mtg = np.empty_like(s)
    mtg_s = theta_s * exn[:, :, nz] + g * hs
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]
    return mtg


def _np_si_stage(s0, su0, sv0, mtg0, s_int, su_int, sv_int, u, v, dt, dx, dy, nb,
                 pt, dz, theta_s, hs, gamma, ref, eps=0.5):
    """One semi-implicit stage, upwind fluxes, relaxed BC on the density."""
    def div(phi):
        fx = _np_upwind_flux_x(u, phi)
        fy = _np_upwind_flux_y(v, phi)
        out = np.zeros_like(phi)
        out[1:-1, 1:-1] = (fx[1:, 1:-1] - fx[:-1, 1:-1]) / dx + (
            fy[1:-1, 1:] - fy[1:-1, :-1]
        ) / dy
        return out[nb:-nb, nb:-nb]

    s_new = s0.copy()
    s_new[nb:-nb, nb:-nb] = s0[nb:-nb, nb:-nb] - dt * div(s_int)
    # relaxed BC on the stepped density
    g3 = gamma[:, :, None]
    s_new = np.where(g3 == 0.0, s_new, np.where(g3 == 1.0, ref, s_new - g3 * (s_new - ref)))
    mtg_new = _np_montgomery(s_new, pt, dz, theta_s, hs)

    iin = slice(nb, s0.shape[0] - nb)
    jin = slice(nb, s0.shape[1] - nb)
    ip1 = slice(nb + 1, s0.shape[0] - nb + 1)
    im1 = slice(nb - 1, s0.shape[0] - nb - 1)
    jp1 = slice(nb + 1, s0.shape[1] - nb + 1)
    jm1 = slice(nb - 1, s0.shape[1] - nb - 1)
    pgx = (1 - eps) * s0[iin, jin] * (mtg0[ip1, jin] - mtg0[im1, jin]) / (2 * dx) + (
        eps * s_new[iin, jin] * (mtg_new[ip1, jin] - mtg_new[im1, jin]) / (2 * dx)
    )
    pgy = (1 - eps) * s0[iin, jin] * (mtg0[iin, jp1] - mtg0[iin, jm1]) / (2 * dy) + (
        eps * s_new[iin, jin] * (mtg_new[iin, jp1] - mtg_new[iin, jm1]) / (2 * dy)
    )
    su_new, sv_new = su0.copy(), sv0.copy()
    su_new[nb:-nb, nb:-nb] = su0[nb:-nb, nb:-nb] - dt * (div(su_int) + pgx)
    sv_new[nb:-nb, nb:-nb] = sv0[nb:-nb, nb:-nb] - dt * (div(sv_int) + pgy)
    return s_new, su_new, sv_new, mtg_new


@pytest.mark.parametrize("scheme,fracs", [
    ("forward_euler_si", (1.0,)),
    ("rk3ws_si", (1.0 / 3.0, 0.5, 1.0)),
])
@settings(max_examples=6, deadline=None)
@given(data=hyp_st.data())
def test_isentropic_prognostic_vs_numpy_rederivation(scheme, fracs, data):
    from tasmania_jax.domain import Domain
    from tasmania_jax.isentropic.dynamics.prognostic import IsentropicPrognostic

    nx = data.draw(hyp_st.integers(7, 14))
    ny = data.draw(hyp_st.integers(7, 14))
    nz = data.draw(hyp_st.integers(2, 5))
    nb, nr = 1, min(4, nx // 2, ny // 2)
    dx = data.draw(hyp_st.floats(1e3, 1e4))
    domain = Domain(
        (0.0, dx * (nx - 1)), nx, (0.0, dx * (ny - 1)), ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=nb,
        horizontal_boundary_kwargs={"nr": nr},
    )
    g = domain.numerical_grid
    rng = data.draw(st_rng())
    shape = (nx, ny, nz)
    s0 = rng.uniform(50.0, 100.0, shape)
    su0 = rng.uniform(-500.0, 500.0, shape)
    sv0 = rng.uniform(-500.0, 500.0, shape)
    u = rng.uniform(-20.0, 20.0, (nx + 1, ny, nz))
    v = rng.uniform(-20.0, 20.0, (nx, ny + 1, nz))
    hs = np.zeros((nx, ny))
    pt, dt = 100.0, data.draw(hyp_st.floats(0.5, 5.0))
    dz = float(np.asarray(g.dz.data))
    theta_s = float(np.asarray(g.z_on_interface_levels.data)[-1])

    ref_state = {
        "air_isentropic_density": FieldArray(s0 * 0 + 75.0, "kg m^-2 K^-1", DIMS3),
        "x_momentum_isentropic": FieldArray(su0 * 0, "kg m^-1 K^-1 s^-1", DIMS3),
        "y_momentum_isentropic": FieldArray(sv0 * 0, "kg m^-1 K^-1 s^-1", DIMS3),
    }
    domain.horizontal_boundary.reference_state = ref_state

    prog = IsentropicPrognostic.factory(
        scheme, "upwind", domain, False,
        pt=FieldArray(np.asarray(pt), "Pa", ()), eps=0.5, backend="jax",
    )
    mtg0 = _np_montgomery(s0, pt, dz, theta_s, hs)
    state = {
        "air_isentropic_density": s0,
        "montgomery_potential": mtg0,
        "x_momentum_isentropic": su0,
        "y_momentum_isentropic": sv0,
        "x_velocity_at_u_locations": u,
        "y_velocity_at_v_locations": v,
        "topography_height": hs,
    }

    gamma = np.asarray(domain.horizontal_boundary._gamma[:nx, :ny])
    s_ref = np.asarray(ref_state["air_isentropic_density"].data)

    # framework stages
    out = dict(state)
    for stage in range(len(fracs)):
        res = prog.stage_call(stage, dt, out, {})
        out.update({k: np.asarray(v) for k, v in res.items()})

    # oracle stages (the "now" state is captured at stage 0)
    s_i, su_i, sv_i = s0, su0, sv0
    for frac in fracs:
        s_i, su_i, sv_i, _ = _np_si_stage(
            s0, su0, sv0, mtg0, s_i, su_i, sv_i, u, v, frac * dt, dx, dx, nb,
            pt, dz, theta_s, hs, gamma, s_ref,
        )
        # NOTE: the framework's BC relax applies to density only inside the
        # stage; momenta BC happens at the dycore level, so compare raw here

    np.testing.assert_allclose(
        np.asarray(out["air_isentropic_density"]), s_i, rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(out["x_momentum_isentropic"]), su_i, rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(out["y_momentum_isentropic"]), sv_i, rtol=1e-9
    )


# --------------------------------------------------------------------------- #
# stepper suites x NON-IDENTITY boundaries (exercises _post_stage enforcement  #
# at every RK stage, framework/steppers.py:123-133; VERDICT r2 item 7)         #
# --------------------------------------------------------------------------- #

from suites import (  # noqa: E402
    DomainSuite,
    SequentialTendencyStepperTestSuite,
    TendencyStepperTestSuite,
)


@pytest.mark.parametrize(
    "boundary", ["identity", "periodic", "relaxed", "dirichlet"]
)
@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk2sa", "rk3ws"])
def test_tendency_stepper_enforces_boundaries(scheme, backend, boundary):
    rng = np.random.default_rng(hash((scheme, backend, boundary)) % 2**32)
    ds = DomainSuite(
        rng, boundary_type=boundary, nb=2, backend=backend, nz_range=(1, 4)
    )
    a = float(rng.uniform(-0.5, 0.5))
    suite = TendencyStepperTestSuite(
        ds,
        lambda dom: Quadratic(dom, a, backend=backend),
        lambda p: a * p * p,
        enforce_hb=True,
    )
    suite.run(scheme, dt_s=float(rng.uniform(0.1, 10.0)))


@pytest.mark.parametrize(
    "boundary", ["identity", "periodic", "relaxed", "dirichlet"]
)
@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
def test_sts_stepper_enforces_boundaries(scheme, boundary):
    rng = np.random.default_rng(hash((scheme, boundary, 7)) % 2**32)
    ds = DomainSuite(rng, boundary_type=boundary, nb=2, nz_range=(1, 4))
    a = float(rng.uniform(-0.5, 0.5))
    suite = SequentialTendencyStepperTestSuite(
        ds,
        lambda dom: Quadratic(dom, a),
        lambda p: a * p * p,
        enforce_hb=True,
    )
    suite.run(scheme, dt_s=float(rng.uniform(0.1, 10.0)))
