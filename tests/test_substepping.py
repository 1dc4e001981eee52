"""Substepping in the DynamicalCore skeleton.

The reference scaffolds substepping but raises ``NotImplementedError``
(reference ``framework/dycore.py:590-592``); this framework implements the
commented design (``dycore.py:594-680``).  Oracle: hand-stepped numpy forward
Euler at dt/substeps.
"""

from datetime import datetime, timedelta

import numpy as np

from tasmania_jax.domain import Domain
from tasmania_jax.framework import FieldArray, TendencyComponent
from tasmania_jax.framework.dycore import DynamicalCore

DIMS3 = ("x", "y", "z")


def make_domain(nx=6, ny=5, nz=2):
    return Domain(
        (0.0, 1e3),
        nx,
        (0.0, 1e3),
        ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
        nz,
        horizontal_boundary_type="identity",
        nb=1,
    )


class LinearB(TendencyComponent):
    """d(b)/dt = alpha * b — the superfast process."""

    def __init__(self, domain, alpha=0.25, **kwargs):
        super().__init__(domain, "numerical", **kwargs)
        self.alpha = alpha

    @property
    def input_properties(self):
        return {"b": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"b": {"dims": DIMS3, "units": "m s^-2"}}

    def array_call(self, state):
        return {"b": self.alpha * state["b"]}, {}


class ToyCore(DynamicalCore):
    """One-stage forward-Euler core on 'a'; 'b' is substepped."""

    @property
    def stages(self):
        return 1

    @property
    def stage_input_properties(self):
        return {"a": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def stage_tendency_properties(self):
        return {"a": {"dims": DIMS3, "units": "m s^-2"}}

    @property
    def stage_output_properties(self):
        return {"a": {"dims": DIMS3, "units": "m s^-1"}}

    def stage_array_call(self, stage, raw_state, raw_tendencies, timestep):
        a = raw_state["a"]
        if "a" in raw_tendencies:
            a = a + timestep * raw_tendencies["a"]
        return {"a": a}

    # -- substep hooks -- #
    @property
    def substep_input_properties(self):
        return {"b": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def substep_tendency_properties(self):
        return {"b": {"dims": DIMS3, "units": "m s^-2"}}

    @property
    def substep_output_properties(self):
        return {"b": {"dims": DIMS3, "units": "m s^-1"}}

    def substep_array_call(
        self, stage, substep, raw_state, raw_stage_state, raw_substep_state,
        raw_tendencies, timestep,
    ):
        db = raw_tendencies.get("b", 0.0)
        return {"b": raw_substep_state["b"] + (timestep / self.substeps) * db}


def _state(domain, seed=0):
    rng = np.random.default_rng(seed)
    g = domain.numerical_grid
    shape = (g.nx, g.ny, g.nz)
    return {
        "time": datetime(2000, 1, 1),
        "a": FieldArray(rng.random(shape), "m s^-1", DIMS3),
        "b": FieldArray(rng.random(shape), "m s^-1", DIMS3),
    }


def test_substepping_forward_euler_oracle():
    domain = make_domain()
    substeps = 4
    alpha = 0.25
    core = ToyCore(
        domain,
        substeps=substeps,
        superfast_tendency_component=LinearB(domain, alpha=alpha),
    )
    state = _state(domain)
    a0 = np.asarray(state["a"].data).copy()
    b0 = np.asarray(state["b"].data).copy()
    dt = timedelta(seconds=8.0)

    tend_a = 0.01 * np.ones_like(a0)
    tendencies = {"a": FieldArray(tend_a, "m s^-2", DIMS3)}
    out = core(state, tendencies, dt)

    np.testing.assert_allclose(np.asarray(out["a"].data), a0 + 8.0 * tend_a, rtol=1e-12)
    # b: n substeps of forward Euler with d(b)/dt = alpha*b at dt/substeps
    b_ref = b0 * (1.0 + alpha * 8.0 / substeps) ** substeps
    np.testing.assert_allclose(np.asarray(out["b"].data), b_ref, rtol=1e-12)
    assert out["time"] == state["time"] + dt


def test_substeps_zero_leaves_substep_fields_untouched():
    domain = make_domain()
    core = ToyCore(domain, substeps=0)
    state = _state(domain, seed=1)
    b0 = np.asarray(state["b"].data).copy()
    out = core(state, {}, timedelta(seconds=2.0))
    np.testing.assert_allclose(np.asarray(out["b"].data), b0)


def test_substep_fractions_multi_stage():
    """A 2-stage core with substep_fractions (0.5, 1.0): stage 0 runs
    substeps/2 substeps, stage 1 restarts from stage-0's substepped value."""

    class TwoStage(ToyCore):
        @property
        def stages(self):
            return 2

        @property
        def substep_fractions(self):
            return (0.5, 1.0)

        def stage_array_call(self, stage, raw_state, raw_tendencies, timestep):
            return {"a": raw_state["a"]}

    domain = make_domain()
    substeps = 4
    alpha = 0.1
    core = TwoStage(
        domain,
        substeps=substeps,
        superfast_tendency_component=LinearB(domain, alpha=alpha),
    )
    state = _state(domain, seed=2)
    b0 = np.asarray(state["b"].data).copy()
    dtv = 8.0
    out = core(state, {}, timedelta(seconds=dtv))
    growth = 1.0 + alpha * dtv / substeps
    b_ref = b0 * growth**2 * growth**4  # 2 substeps (stage 0) + 4 (stage 1)
    np.testing.assert_allclose(np.asarray(out["b"].data), b_ref, rtol=1e-12)


def test_substep_count_truncates_and_zero_stage_keeps_input():
    """``n = int(frac * substeps)`` truncates (reference scaffold,
    ``dycore.py:613``): with fractions (1/3, 1/2, 1) and substeps=2, stage 0
    runs int(2/3)=0 substeps — the substepped variable keeps its stage-input
    value through that stage — and stage 1 runs int(1)=1, stage 2 int(2)=2."""

    class ThreeStage(ToyCore):
        @property
        def stages(self):
            return 3

        @property
        def substep_fractions(self):
            return (1.0 / 3.0, 0.5, 1.0)

        def stage_array_call(self, stage, raw_state, raw_tendencies, timestep):
            return {"a": raw_state["a"]}

    domain = make_domain()
    substeps = 2
    alpha = 0.1
    core = ThreeStage(
        domain,
        substeps=substeps,
        superfast_tendency_component=LinearB(domain, alpha=alpha),
    )
    state = _state(domain, seed=3)
    b0 = np.asarray(state["b"].data).copy()
    dtv = 6.0
    out = core(state, {}, timedelta(seconds=dtv))
    growth = 1.0 + alpha * dtv / substeps
    # stage 0: 0 substeps (b unchanged) -> stage 1: 1 substep from b0 ->
    # stage 2 restarts from the stage-input b (= stage-1 output): 2 substeps
    b_ref = b0 * growth**1 * growth**2
    np.testing.assert_allclose(np.asarray(out["b"].data), b_ref, rtol=1e-12)
