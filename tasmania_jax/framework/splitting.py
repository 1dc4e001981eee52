"""Physics–dynamics splitting strategies: parallel, sequential-update,
sequential-tendency.

JAX re-design of reference
``src/tasmania/framework/parallel_splitting.py:54``,
``sequential_update_splitting.py:52``, ``sequential_tendency_splitting.py:51``.
Each coupler consumes ``TimeIntegrationOptions`` bundles (component + scheme)
and is a *functional* combinator: state dicts in, state dicts out (the
reference mutates in place).  A driver wraps one full splitting call in
``jax.jit`` — every wrapped component, stepper stage, and dict op fuses into a
single device program.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from tasmania_jax.framework.composite import DiagnosticComponentComposite
from tasmania_jax.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_jax.framework.core_components import DiagnosticComponent
from tasmania_jax.framework.dict_operator import DictOperator
from tasmania_jax.framework.field import ensure_timedelta_seconds
from tasmania_jax.framework.options import TimeIntegrationOptions
from tasmania_jax.framework.steppers import SequentialTendencyStepper, TendencyStepper

_DIAGNOSTIC_TYPES = (DiagnosticComponent, DiagnosticComponentComposite)

def _is_diagnostic(component) -> bool:
    return isinstance(component, _DIAGNOSTIC_TYPES) or (
        hasattr(component, "diagnostic_properties")
        and not hasattr(component, "tendency_properties")
        and not hasattr(component, "output_properties")
    )


def _build_steppers(
    options: Sequence[TimeIntegrationOptions], stepper_family
) -> List[Any]:
    out = []
    for opt in options:
        if isinstance(opt, TimeIntegrationOptions):
            comp = opt.component
            if _is_diagnostic(comp) or opt.scheme is None:
                out.append((comp, 1))
            else:
                stepper = stepper_family.factory(
                    opt.scheme,
                    comp,
                    enforce_horizontal_boundary=opt.enforce_horizontal_boundary,
                    backend=opt.backend,
                    backend_options=opt.backend_options,
                    storage_options=opt.storage_options,
                    **opt.kwargs,
                )
                out.append((stepper, opt.substeps))
        else:  # bare component / prebuilt stepper
            out.append((opt, 1))
    return out


class SequentialUpdateSplitting:
    """Processes applied one after another, each updating the state in place
    (Donahue & Caldwell ordering; reference ``sequential_update_splitting.py:144``)."""

    def __init__(self, *args: TimeIntegrationOptions) -> None:
        self._steppers = _build_steppers(args, TendencyStepper)
        self._dict_op = DictOperator()

        self.input_properties: Dict[str, Any] = {}
        self.output_properties: Dict[str, Any] = {}
        available: set = set()
        for comp, _ in self._steppers:
            for name, props in (getattr(comp, "input_properties", {}) or {}).items():
                if name not in available and name not in self.input_properties:
                    self.input_properties[name] = dict(props)
            for attr in ("diagnostic_properties", "output_properties"):
                for name, props in (getattr(comp, attr, {}) or {}).items():
                    self.output_properties[name] = dict(props)
                    available.add(name)

    @property
    def components(self):
        return tuple(c for c, _ in self._steppers)

    def __call__(self, state: Mapping[str, Any], timestep) -> Dict[str, Any]:
        dt = ensure_timedelta_seconds(timestep)
        td = timedelta(seconds=dt)
        current_time = state.get("time", None)
        out = dict(state)
        for comp, substeps in self._steppers:
            if _is_diagnostic(comp):
                diags = comp(out)
                out = self._dict_op.update(out, diags)
            elif isinstance(comp, ConcurrentCoupling):
                # scheme-less tendency coupling: only its diagnostics feed the
                # state (reference SUS usage: [fall velocity + precipitation])
                _, diags = comp(out, td)
                out = self._dict_op.update(out, diags)
            else:
                sub_td = td / substeps
                for _ in range(substeps):
                    diagnostics, stepped = comp(out, sub_td)
                    out = self._dict_op.update(out, diagnostics)
                    out = self._dict_op.update(out, stepped)
            if current_time is not None:
                out["time"] = current_time
        if current_time is not None:
            out["time"] = current_time + td
        return out


class ParallelSplitting:
    """All processes consume the same current state; increments accumulate onto
    a provisional state (reference ``parallel_splitting.py:54,222,256``)."""

    def __init__(
        self,
        *args: TimeIntegrationOptions,
        execution_policy: str = "serial",
        retrieve_diagnostics_from_provisional_state: bool = False,
    ) -> None:
        self._steppers = _build_steppers(args, TendencyStepper)
        self._policy = execution_policy
        self._diagnostics_from_provisional = retrieve_diagnostics_from_provisional_state
        self._dict_op = DictOperator()

        self.provisional_output_properties: Dict[str, Any] = {}
        for comp, _ in self._steppers:
            for name, props in (getattr(comp, "output_properties", {}) or {}).items():
                self.provisional_output_properties[name] = dict(props)

    @property
    def components(self):
        return tuple(c for c, _ in self._steppers)

    def __call__(
        self, state: Mapping[str, Any], state_prv: Mapping[str, Any], timestep
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Returns (state_with_diagnostics, new_provisional_state)."""
        dt = ensure_timedelta_seconds(timestep)
        td = timedelta(seconds=dt)
        cur = dict(state)
        prv = dict(state_prv)

        for comp, substeps in self._steppers:
            if _is_diagnostic(comp):
                target = prv if self._diagnostics_from_provisional else cur
                diags = comp(target)
                if self._diagnostics_from_provisional:
                    prv = self._dict_op.update(prv, diags)
                else:
                    cur = self._dict_op.update(cur, diags)
            else:
                sub_td = td / substeps
                diagnostics, stepped = comp(cur, sub_td)
                for _ in range(1, substeps):
                    aux = self._dict_op.update(dict(cur), stepped)
                    _, stepped = comp(aux, sub_td)
                # prv += stepped - state  over this process's output variables
                # (addsub returns only the filtered keys; merge, don't replace)
                delta = self._dict_op.addsub(
                    prv,
                    stepped,
                    cur,
                    field_properties={
                        k: v
                        for k, v in self.provisional_output_properties.items()
                        if k in getattr(comp, "output_properties", {})
                    },
                )
                prv = self._dict_op.update(prv, delta)
                cur = self._dict_op.update(cur, diagnostics)

        if "time" in state:
            prv["time"] = state["time"] + td
        return cur, prv


class SequentialTendencySplitting:
    """Each stepper evaluates tendencies on the current state and applies them
    to the provisional state (reference ``sequential_tendency_splitting.py:154``)."""

    def __init__(self, *args: TimeIntegrationOptions) -> None:
        self._steppers = _build_steppers(args, SequentialTendencyStepper)
        self._dict_op = DictOperator()

    @property
    def components(self):
        return tuple(c for c, _ in self._steppers)

    def __call__(
        self, state: Mapping[str, Any], state_prv: Mapping[str, Any], timestep
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Returns (state_with_diagnostics, new_provisional_state)."""
        dt = ensure_timedelta_seconds(timestep)
        td = timedelta(seconds=dt)
        cur = dict(state)
        prv = dict(state_prv)

        for comp, substeps in self._steppers:
            if _is_diagnostic(comp):
                diags = comp(prv)
                prv = self._dict_op.update(prv, diags)
            elif isinstance(comp, ConcurrentCoupling):
                # scheme-less tendency coupling: diagnostics only, on the
                # provisional state (mirrors the SUS handling)
                _, diags = comp(prv, td)
                prv = self._dict_op.update(prv, diags)
            else:
                sub_td = td / substeps
                diagnostics, stepped = comp(cur, prv, sub_td)
                cur = self._dict_op.update(cur, diagnostics)
                prv = self._dict_op.update(prv, stepped)

        if "time" in state:
            cur["time"] = state["time"]
            prv["time"] = state["time"] + td
        return cur, prv
