"""Reusable component / stepper test harnesses.

JAX re-design of reference ``tests/suites/{domain,component,steppers}.py``
(SURVEY.md §4): compose a random domain + state, run a component (or a
stepper wrapping one), and validate against a numpy re-derivation supplied by
the concrete suite.  Mirrors the reference apparatus's axes:

* backend parametrization (numpy oracle vs jax arrays) — reference
  ``tests/conf.py:31-95``;
* staggered-field states (shape inferred from ``at_u_locations`` etc. name
  conventions) — reference ``tests/strategies.py:569``;
* out-buffer calls (components accept pre-allocated ``out=`` dicts) —
  reference out-buffer strategies ``tests/strategies.py:1724-1791``;
* non-identity boundaries in stepper suites (exercises the ``_post_stage``
  enforcement seam, ``framework/steppers.py:123-133``) — reference
  ``tests/suites/steppers.py:123,194``.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np

import jax.numpy as jnp

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray, field_shape

#: the backend sweep every parameterized suite runs over
BACKENDS = ("numpy", "jax")


class DomainSuite:
    """Random-ish domain factory (reference ``suites/domain.py:35``)."""

    def __init__(
        self,
        rng: np.random.Generator,
        nx_range=(8, 20),
        ny_range=(8, 20),
        nz_range=(3, 8),
        boundary_type: str = "identity",
        nb: int = 1,
        boundary_kwargs: Optional[Dict[str, Any]] = None,
        backend: str = "jax",
    ) -> None:
        nx = int(rng.integers(*nx_range))
        ny = int(rng.integers(*ny_range))
        nz = int(rng.integers(*nz_range))
        if boundary_type == "relaxed":
            boundary_kwargs = dict(boundary_kwargs or {})
            boundary_kwargs.setdefault("nr", min(8, nx // 2, ny // 2))
        self.domain = Domain(
            (0.0, 1e4 * nx),
            nx,
            (0.0, 1e4 * ny),
            ny,
            FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
            nz,
            horizontal_boundary_type=boundary_type,
            nb=nb,
            horizontal_boundary_kwargs=boundary_kwargs,
        )
        self.grid = self.domain.numerical_grid
        self.rng = rng
        self.backend = backend

    def raw_array(self, shape, lo=-1.0, hi=1.0):
        data = self.rng.uniform(lo, hi, size=shape)
        return np.asarray(data) if self.backend == "numpy" else jnp.asarray(data)

    def random_field(self, name: str, units: str, lo=-1.0, hi=1.0) -> FieldArray:
        """Shape follows the staggered-name convention (``at_u_locations`` →
        nx+1 etc., ``framework/field.py``)."""
        shape = field_shape(name, (self.grid.nx, self.grid.ny, self.grid.nz))
        return FieldArray(self.raw_array(shape, lo, hi), units, ("x", "y", "z"))

    def set_reference_state(self, properties: Mapping[str, Mapping[str, Any]],
                            lo=0.5, hi=2.0) -> Dict[str, Any]:
        """Install a random reference state covering ``properties`` on the
        boundary (required by relaxed/dirichlet enforcement)."""
        ref: Dict[str, Any] = {"time": datetime(2000, 1, 1)}
        for name, props in properties.items():
            ref[name] = self.random_field(name, props["units"], lo, hi)
        self.domain.horizontal_boundary.reference_state = ref
        return ref


class ComponentTestSuite:
    """Abstract harness (reference ``suites/component.py:39``): build a state
    from the component's declared inputs, run it, compare against
    :meth:`reference_call` (a numpy oracle the subclass provides).

    ``run_diagnostic`` / ``run_tendency`` also exercise the out-buffer call
    path when ``with_out=True``: pre-allocated output dicts are passed through
    ``out=`` / ``out_tendencies=`` and the merge semantics are checked
    (computed fields overwrite, unrelated pre-existing keys survive)."""

    #: tolerance for the oracle comparison (subclasses may tighten/loosen)
    atol = 1e-10

    def __init__(self, ds: DomainSuite, component) -> None:
        self.ds = ds
        self.component = component

    def make_state(self, time: Optional[datetime] = None) -> Dict[str, Any]:
        state: Dict[str, Any] = {"time": time or datetime(2000, 1, 1)}
        for name, props in self.component.input_properties.items():
            state[name] = self.ds.random_field(name, props["units"], 0.5, 2.0)
        return state

    def make_out_buffers(self, properties) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "__sentinel__": FieldArray(
                self.ds.raw_array((2, 2)), "1", ("x", "y")
            )
        }
        for name, props in properties.items():
            out[name] = self.ds.random_field(name, props["units"], -9.0, -8.0)
        return out

    def raw(self, state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        return {
            k: np.asarray(v.data)
            for k, v in state.items()
            if isinstance(v, FieldArray)
        }

    def reference_call(self, raw_state: Mapping[str, np.ndarray]):
        raise NotImplementedError

    def run_diagnostic(
        self, atol: Optional[float] = None, with_out: bool = False
    ) -> None:
        atol = self.atol if atol is None else atol
        state = self.make_state()
        expected = self.reference_call(self.raw(state))
        if with_out:
            out_buf = self.make_out_buffers(self.component.diagnostic_properties)
            out = self.component(state, out=out_buf)
            assert "__sentinel__" in out, "out= merge dropped unrelated keys"
        else:
            out = self.component(state)
        for name, exp in expected.items():
            np.testing.assert_allclose(
                np.asarray(out[name].data), exp, atol=atol, err_msg=name
            )

    def run_tendency(
        self, atol: Optional[float] = None, with_out: bool = False
    ) -> None:
        atol = self.atol if atol is None else atol
        state = self.make_state()
        exp_tends, exp_diags = self.reference_call(self.raw(state))
        exp_tends = dict(exp_tends)
        if with_out:
            tbuf = self.make_out_buffers(self.component.tendency_properties)
            dbuf = self.make_out_buffers(self.component.diagnostic_properties)
            tends, diags = self.component(
                state, out_tendencies=tbuf, out_diagnostics=dbuf
            )
            assert "__sentinel__" in tends and "__sentinel__" in diags
            # tendency buffers ACCUMULATE (reference CC summation semantics,
            # core_components.merge_tendencies); diagnostics overwrite
            for name in exp_tends:
                exp_tends[name] = exp_tends[name] + np.asarray(tbuf[name].data)
        else:
            tends, diags = self.component(state)
        for name, exp in exp_tends.items():
            np.testing.assert_allclose(
                np.asarray(tends[name].data), exp, atol=atol, err_msg=name
            )
        for name, exp in exp_diags.items():
            np.testing.assert_allclose(
                np.asarray(diags[name].data), exp, atol=atol, err_msg=name
            )


# --------------------------------------------------------------------------- #
# stepper suites                                                              #
# --------------------------------------------------------------------------- #

#: exact stage algebra of each scheme (framework/steppers.py:188-258); the
#: ``enforce`` hook is applied to every stage output, mirroring _post_stage
_STAGE_FRACS = {
    "forward_euler": (1.0,),
    "rk2": (0.5, 1.0),
    "rk2sa": (0.5, 1.0),
    "rk3ws": (1.0 / 3.0, 0.5, 1.0),
}


def oracle_tendency_stepper(scheme, phi, f, dt, enforce):
    stage = phi
    for frac in _STAGE_FRACS[scheme]:
        stage = enforce(phi + frac * dt * f(stage))
    return stage


def oracle_sts_stepper(scheme, phi, prv, f, dt, enforce):
    """STS stage algebra (framework/steppers.py:266-308)."""
    if scheme == "forward_euler":
        return enforce(prv + dt * f(phi))
    if scheme == "rk2":
        s1 = enforce(0.5 * (phi + prv + dt * f(phi)))
        return enforce(prv + dt * f(s1))
    if scheme == "rk3ws":
        s1 = enforce((2.0 * phi + prv + dt * f(phi)) / 3.0)
        s2 = enforce(0.5 * (phi + prv + dt * f(s1)))
        return enforce(prv + dt * f(s2))
    raise ValueError(scheme)


class TendencyStepperTestSuite:
    """Validate ``TendencyStepper.factory(scheme, component)`` against the
    numpy stage algebra with per-stage boundary enforcement (reference
    ``tests/suites/steppers.py:123``).

    ``component_factory(domain) -> TendencyComponent`` must expose exactly one
    prognostic field ``field_name`` whose tendency is ``f(phi)`` given by
    ``tendency_fn`` (a numpy function).
    """

    def __init__(
        self,
        ds: DomainSuite,
        component_factory: Callable[[Domain], Any],
        tendency_fn: Callable[[np.ndarray], np.ndarray],
        field_name: str = "phi",
        units: str = "m s^-1",
        enforce_hb: bool = False,
    ) -> None:
        self.ds = ds
        self.field_name = field_name
        self.units = units
        self.enforce_hb = enforce_hb
        self.tendency_fn = tendency_fn
        self.component = component_factory(ds.domain)
        if enforce_hb:
            ds.set_reference_state({field_name: {"units": units}})

    def _enforce_np(self, arr: np.ndarray) -> np.ndarray:
        # time=None mirrors _post_stage: the stepped dict carries no "time"
        # key, so hb.enforce sees None (framework/steppers.py:123-133)
        if not self.enforce_hb:
            return arr
        hb = self.ds.domain.horizontal_boundary
        return np.asarray(
            hb.enforce_field(
                jnp.asarray(arr) if self.ds.backend != "numpy" else arr,
                field_name=self.field_name,
                field_units=self.units,
                time=None,
            )
        )

    def run(self, scheme: str, dt_s: float = 7.0, rtol: float = 1e-11) -> None:
        stepper = TendencyStepperFactory(
            scheme, self.component, enforce_horizontal_boundary=self.enforce_hb
        )
        g = self.ds.grid
        phi0 = np.asarray(self.ds.rng.uniform(0.5, 2.0, (g.nx, g.ny, g.nz)))
        time = datetime(2000, 1, 1)
        state = {
            "time": time,
            self.field_name: FieldArray(
                phi0 if self.ds.backend == "numpy" else jnp.asarray(phi0),
                self.units,
                ("x", "y", "z"),
            ),
        }
        # float seconds, NOT timedelta: timedelta quantizes to microseconds
        # (1.3899487... -> 1.389949), a ~1e-7 relative error vs the oracle
        _, out = stepper(state, dt_s)
        expected = oracle_tendency_stepper(
            scheme, phi0, self.tendency_fn, dt_s, self._enforce_np
        )
        np.testing.assert_allclose(
            np.asarray(out[self.field_name].data), expected, rtol=rtol,
            atol=1e-13,
            err_msg=f"{scheme}/{type(self.ds.domain.horizontal_boundary).__name__}",
        )


class SequentialTendencyStepperTestSuite(TendencyStepperTestSuite):
    """Same, for the (state, provisional) stepper family (reference
    ``tests/suites/steppers.py:194``)."""

    def run(self, scheme: str, dt_s: float = 7.0, rtol: float = 1e-11) -> None:
        stepper = SequentialTendencyStepperFactory(
            scheme, self.component, enforce_horizontal_boundary=self.enforce_hb
        )
        g = self.ds.grid
        phi0 = np.asarray(self.ds.rng.uniform(0.5, 2.0, (g.nx, g.ny, g.nz)))
        prv0 = np.asarray(self.ds.rng.uniform(0.5, 2.0, (g.nx, g.ny, g.nz)))
        time = datetime(2000, 1, 1)
        wrap = (lambda a: a) if self.ds.backend == "numpy" else jnp.asarray
        state = {
            "time": time,
            self.field_name: FieldArray(wrap(phi0), self.units, ("x", "y", "z")),
        }
        prv = {
            self.field_name: FieldArray(wrap(prv0), self.units, ("x", "y", "z")),
        }
        _, out = stepper(state, prv, dt_s)
        expected = oracle_sts_stepper(
            scheme, phi0, prv0, self.tendency_fn, dt_s, self._enforce_np
        )
        np.testing.assert_allclose(
            np.asarray(out[self.field_name].data), expected, rtol=rtol,
            atol=1e-13,
            err_msg=f"{scheme}/{type(self.ds.domain.horizontal_boundary).__name__}",
        )


def TendencyStepperFactory(scheme, component, **kwargs):
    from tasmania_jax.framework import TendencyStepper

    return TendencyStepper.factory(scheme, component, **kwargs)


def SequentialTendencyStepperFactory(scheme, component, **kwargs):
    from tasmania_jax.framework import SequentialTendencyStepper

    return SequentialTendencyStepper.factory(scheme, component, **kwargs)
