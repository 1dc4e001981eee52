"""Component-model + coupling + stepper tests.

Oracle style: fake components with analytically known dynamics (linear ODEs),
verifying each stepper/splitting against its hand-derived stage algebra —
mirroring the reference's coupling test suites (tests/suites/*, SURVEY.md §4).
"""

from datetime import datetime, timedelta

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework import (
    ConcurrentCoupling,
    DiagnosticComponent,
    FieldArray,
    ParallelSplitting,
    SequentialTendencySplitting,
    SequentialUpdateSplitting,
    TendencyComponent,
    TendencyStepper,
    SequentialTendencyStepper,
    TimeIntegrationOptions,
)


def make_domain(nx=8, ny=8, nz=2):
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


DIMS3 = ("x", "y", "z")


class LinearTendency(TendencyComponent):
    """d(phi)/dt = alpha * phi"""

    def __init__(self, domain, alpha=0.1, **kwargs):
        super().__init__(domain, "numerical", **kwargs)
        self.alpha = alpha

    @property
    def input_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-2"}}

    def array_call(self, state):
        return {"phi": self.alpha * state["phi"]}, {}


class ConstantTendency(TendencyComponent):
    """d(phi)/dt = c"""

    def __init__(self, domain, c=2.0, **kwargs):
        super().__init__(domain, "numerical", **kwargs)
        self.c = c

    @property
    def input_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-2"}}

    def array_call(self, state):
        return {"phi": self.c * jnp.ones_like(state["phi"])}, {}


class DoublerDiagnostic(DiagnosticComponent):
    """psi = 2*phi"""

    @property
    def input_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def diagnostic_properties(self):
        return {"psi": {"dims": DIMS3, "units": "m s^-1"}}

    def array_call(self, state):
        return {"psi": 2.0 * state["phi"]}


class PsiConsumer(TendencyComponent):
    """d(phi)/dt = psi  (requires serial threading of the diagnostic)"""

    @property
    def input_properties(self):
        return {"psi": {"dims": DIMS3, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"phi": {"dims": DIMS3, "units": "m s^-2"}}

    def array_call(self, state):
        return {"phi": state["psi"]}, {}


def make_state(domain, value=1.0):
    g = domain.numerical_grid
    return {
        "time": datetime(2000, 1, 1),
        "phi": FieldArray(
            value * jnp.ones((g.nx, g.ny, g.nz)), "m s^-1", DIMS3
        ),
    }


class TestConcurrentCoupling:
    def test_serial_threads_diagnostics(self):
        d = make_domain()
        cc = ConcurrentCoupling(DoublerDiagnostic(d), PsiConsumer(d))
        state = make_state(d, 3.0)
        tends, diags = cc(state, timedelta(seconds=1))
        np.testing.assert_allclose(np.asarray(tends["phi"].data), 6.0)
        np.testing.assert_allclose(np.asarray(diags["psi"].data), 6.0)
        # derived properties: psi satisfied internally, phi needed
        assert "phi" in cc.input_properties
        assert "psi" not in cc.input_properties

    def test_as_parallel_no_threading(self):
        d = make_domain()
        cc = ConcurrentCoupling(
            DoublerDiagnostic(d), PsiConsumer(d), execution_policy="as_parallel"
        )
        assert "psi" in cc.input_properties

    def test_tendencies_sum(self):
        d = make_domain()
        cc = ConcurrentCoupling(LinearTendency(d, 0.1), ConstantTendency(d, 2.0))
        state = make_state(d, 10.0)
        tends, _ = cc(state, timedelta(seconds=1))
        np.testing.assert_allclose(np.asarray(tends["phi"].data), 1.0 + 2.0)

    def test_unit_conversion_in_sum(self):
        d = make_domain()

        class KmTendency(ConstantTendency):
            @property
            def tendency_properties(self):
                return {"phi": {"dims": DIMS3, "units": "km s^-2"}}

        cc = ConcurrentCoupling(ConstantTendency(d, 1.0), KmTendency(d, 1.0))
        tends, _ = cc(make_state(d), timedelta(seconds=1))
        # 1 m/s^2 + 1 km/s^2 = 1001 m/s^2
        np.testing.assert_allclose(np.asarray(tends["phi"].data), 1001.0)


class TestTendencySteppers:
    """dphi/dt = a·phi with phi0=1: compare to the scheme's exact amplification."""

    @pytest.mark.parametrize(
        "scheme,amp",
        [
            ("forward_euler", lambda z: 1 + z),
            ("rk2", lambda z: 1 + z + z * z / 2),
            ("rk2sa", lambda z: 1 + z + z * z / 2),
            ("rk3ws", lambda z: 1 + z + z**2 / 2 + z**3 / 6),
        ],
    )
    def test_amplification(self, scheme, amp):
        d = make_domain()
        a, dt = 0.25, 2.0
        stepper = TendencyStepper.factory(scheme, LinearTendency(d, a))
        state = make_state(d, 1.0)
        _, out = stepper(state, timedelta(seconds=dt))
        np.testing.assert_allclose(
            np.asarray(out["phi"].data), amp(a * dt), rtol=1e-12
        )
        assert out["time"] == state["time"] + timedelta(seconds=dt)

    def test_output_properties(self):
        d = make_domain()
        stepper = TendencyStepper.factory("rk2", LinearTendency(d))
        assert stepper.output_properties["phi"]["units"] == "m s^-1"


class TestSequentialTendencySteppers:
    @pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
    def test_constant_tendency(self, scheme):
        """With constant f, every STS scheme gives out = prv + dt*c exactly."""
        d = make_domain()
        stepper = SequentialTendencyStepper.factory(scheme, ConstantTendency(d, 3.0))
        state = make_state(d, 1.0)
        prv = make_state(d, 5.0)
        _, out = stepper(state, prv, timedelta(seconds=2.0))
        np.testing.assert_allclose(np.asarray(out["phi"].data), 5.0 + 2.0 * 3.0)

    def test_rk2_algebra(self):
        """STS-RK2 with f=a·phi: out = prv + dt·a·(0.5·(x + prv + dt·a·x))."""
        d = make_domain()
        a, dt, x0, p0 = 0.1, 2.0, 1.0, 4.0
        stepper = SequentialTendencyStepper.factory("rk2", LinearTendency(d, a))
        _, out = stepper(
            make_state(d, x0), make_state(d, p0), timedelta(seconds=dt)
        )
        s1 = 0.5 * (x0 + p0 + dt * a * x0)
        expected = p0 + dt * a * s1
        np.testing.assert_allclose(np.asarray(out["phi"].data), expected, rtol=1e-12)


class TestSplittings:
    def test_sequential_update(self):
        d = make_domain()
        sus = SequentialUpdateSplitting(
            TimeIntegrationOptions(LinearTendency(d, 0.1), scheme="forward_euler"),
            TimeIntegrationOptions(DoublerDiagnostic(d)),
            TimeIntegrationOptions(ConstantTendency(d, 1.0), scheme="forward_euler"),
        )
        state = make_state(d, 1.0)
        dt = 1.0
        out = sus(state, timedelta(seconds=dt))
        # phi: (1*(1+0.1)) then +1*1 = 2.1; psi = 2*1.1 (diag computed mid-chain)
        np.testing.assert_allclose(np.asarray(out["phi"].data), 2.1)
        np.testing.assert_allclose(np.asarray(out["psi"].data), 2.2)
        assert out["time"] == state["time"] + timedelta(seconds=dt)

    def test_parallel_splitting(self):
        d = make_domain()
        ps = ParallelSplitting(
            TimeIntegrationOptions(LinearTendency(d, 0.1), scheme="forward_euler"),
            TimeIntegrationOptions(ConstantTendency(d, 1.0), scheme="forward_euler"),
        )
        state = make_state(d, 2.0)
        prv = make_state(d, 3.0)
        cur, out_prv = ps(state, prv, timedelta(seconds=1.0))
        # prv + (state*(1.1) - state) + (state + 1 - state) = 3 + 0.2 + 1
        np.testing.assert_allclose(np.asarray(out_prv["phi"].data), 4.2)

    def test_sequential_tendency_splitting(self):
        d = make_domain()
        sts = SequentialTendencySplitting(
            TimeIntegrationOptions(ConstantTendency(d, 1.0), scheme="forward_euler"),
            TimeIntegrationOptions(ConstantTendency(d, 2.0), scheme="forward_euler"),
        )
        state = make_state(d, 2.0)
        prv = make_state(d, 3.0)
        _, out_prv = sts(state, prv, timedelta(seconds=1.0))
        # prv <- prv + dt*1 = 4; prv <- 4 + dt*2 = 6
        np.testing.assert_allclose(np.asarray(out_prv["phi"].data), 6.0)


class TestJit:
    def test_splitting_inside_jit(self):
        """A whole SUS step traces into one jitted function."""
        d = make_domain()
        sus = SequentialUpdateSplitting(
            TimeIntegrationOptions(LinearTendency(d, 0.1), scheme="rk3ws"),
            TimeIntegrationOptions(DoublerDiagnostic(d)),
        )

        @jax.jit
        def step(phi):
            state = {"phi": FieldArray(phi, "m s^-1", DIMS3)}
            out = sus(state, 1.0)
            return out["phi"].data, out["psi"].data

        g = d.numerical_grid
        phi0 = jnp.ones((g.nx, g.ny, g.nz))
        phi1, psi1 = step(phi0)
        z = 0.1
        np.testing.assert_allclose(
            np.asarray(phi1), 1 + z + z**2 / 2 + z**3 / 6, rtol=1e-12
        )
        np.testing.assert_allclose(np.asarray(psi1), 2 * np.asarray(phi1))
