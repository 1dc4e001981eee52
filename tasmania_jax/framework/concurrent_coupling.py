"""Concurrent coupling: bundle N components into one tendency evaluation.

JAX re-design of reference ``src/tasmania/framework/concurrent_coupling.py:63``
with the property-union/checking helpers of ``concurrent_coupling_utils.py``.
The two execution policies are preserved as *dataflow orderings inside one
traced graph* (SURVEY.md §2.8): 'serial' threads each component's diagnostics
into the next component's input state; 'as_parallel' evaluates every component
against the same input.  Under jit the whole bundle fuses into one XLA
computation either way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from tasmania_jax.framework.composite import DiagnosticComponentComposite
from tasmania_jax.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
    TendencyComponent,
    merge_tendencies,
)
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.promoter import FromDiagnosticToTendency, FromTendencyToDiagnostic
from tasmania_jax.utils.exceptions import PropertyError
from tasmania_jax.utils.units import units_are_compatible

PropertyDict = Dict[str, Dict[str, Any]]


def _diag_props(component) -> Mapping[str, Any]:
    return getattr(component, "diagnostic_properties", {}) or {}


def _tend_props(component) -> Mapping[str, Any]:
    return getattr(component, "tendency_properties", {}) or {}


def _input_props(component) -> Mapping[str, Any]:
    if isinstance(component, FromTendencyToDiagnostic):
        return {}  # consumes tendencies, not state
    return getattr(component, "input_properties", {}) or {}


class ConcurrentCoupling:
    """Explicit concurrent coupling of diagnostic/tendency components
    (Staniforth et al. 2002)."""

    allowed_diagnostic_type = (DiagnosticComponent, DiagnosticComponentComposite)
    allowed_promoter_type = (FromDiagnosticToTendency, FromTendencyToDiagnostic)

    def __new__(cls, *args, **kwargs):
        # idempotent wrap (reference ``concurrent_coupling.py:111-115``)
        if len(args) == 1 and isinstance(args[0], ConcurrentCoupling):
            return args[0]
        return super().__new__(cls)

    def __init__(
        self,
        *args,
        execution_policy: str = "serial",
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        if getattr(self, "_initialized", False):
            return
        self._components = args
        self._policy = (
            execution_policy if execution_policy in ("serial", "as_parallel") else "serial"
        )
        self._enable_checks = enable_checks

        self.input_properties = self._derive_input_properties()
        self.tendency_properties = self._derive_tendency_properties()
        self.diagnostic_properties = self._derive_diagnostic_properties()

        # per-component overwrite flags: first producer of a tendency variable
        # overwrites any stale buffer entry (reference ``get_overwrite_tendencies``)
        self.overwrite_tendencies = []
        seen: set = set()
        for c in self._components:
            flags = {}
            for name in _tend_props(c):
                flags[name] = name not in seen
                seen.add(name)
            self.overwrite_tendencies.append(flags)

        # expose the horizontal boundary of the first domain-aware component
        self.horizontal_boundary = None
        for c in self._components:
            hb = getattr(c, "horizontal_boundary", None)
            if hb is not None:
                self.horizontal_boundary = hb
                break

        self._initialized = True

    # -- property derivation (reference concurrent_coupling_utils.py:48,169) -- #
    def _derive_input_properties(self) -> PropertyDict:
        inputs: PropertyDict = {}
        available: set = set()
        for c in self._components:
            for name, props in _input_props(c).items():
                if name not in available and name not in inputs:
                    inputs[name] = dict(props)
                elif self._enable_checks and name in inputs:
                    if not units_are_compatible(
                        inputs[name].get("units", "1"), props.get("units", "1")
                    ):
                        raise PropertyError(
                            f"incompatible units for input {name!r}: "
                            f"{inputs[name].get('units')} vs {props.get('units')}"
                        )
            if self._policy == "serial":
                available |= set(_diag_props(c).keys())
        return inputs

    def _derive_tendency_properties(self) -> PropertyDict:
        tends: PropertyDict = {}
        for c in self._components:
            for name, props in _tend_props(c).items():
                if name not in tends:
                    tends[name] = {
                        k: v for k, v in props.items() if k != "tendency_name"
                    }
                elif self._enable_checks:
                    if not units_are_compatible(
                        tends[name].get("units", "1"), props.get("units", "1")
                    ):
                        raise PropertyError(
                            f"incompatible units for tendency {name!r}"
                        )
        return tends

    def _derive_diagnostic_properties(self) -> PropertyDict:
        diags: PropertyDict = {}
        for c in self._components:
            for name, props in _diag_props(c).items():
                diags[name] = dict(props)
        return diags

    # -- public API ------------------------------------------------------------- #
    @property
    def components(self) -> Sequence:
        return self._components

    @property
    def execution_policy(self) -> str:
        return self._policy

    def __call__(
        self,
        state: Mapping[str, Any],
        timestep=None,
        *,
        out_tendencies: Optional[Mapping[str, Any]] = None,
        out_diagnostics: Optional[Mapping[str, Any]] = None,
        overwrite_tendencies: Optional[Mapping[str, bool]] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Evaluate the bundle: returns (tendencies, diagnostics) dicts."""
        call = self._call_serial if self._policy == "serial" else self._call_asparallel
        tendencies, diagnostics = call(
            state, timestep, out_tendencies, out_diagnostics, overwrite_tendencies
        )
        if "time" in state:
            tendencies["time"] = state["time"]
            diagnostics["time"] = state["time"]
        return tendencies, diagnostics

    # -- execution policies ------------------------------------------------------ #
    def _call_serial(
        self, state, timestep, out_tendencies, out_diagnostics, overwrite_tendencies
    ):
        """reference ``concurrent_coupling.py:316``"""
        tendencies: Dict[str, Any] = dict(out_tendencies or {})
        diagnostics: Dict[str, Any] = dict(out_diagnostics or {})
        overwrite_tendencies = overwrite_tendencies or {}
        aux_state = dict(state)

        for component, self_ot in zip(self._components, self.overwrite_tendencies):
            if isinstance(component, self.allowed_diagnostic_type):
                new_diags = component(aux_state)
                diagnostics.update(new_diags)
                aux_state.update(new_diags)
            elif isinstance(component, FromTendencyToDiagnostic):
                new_diags = component(tendencies)
                diagnostics.update(new_diags)
                aux_state.update(new_diags)
            elif isinstance(component, FromDiagnosticToTendency):
                new_tends = component(aux_state)
                tendencies = merge_tendencies(tendencies, new_tends, None)
            else:  # tendency-like (incl. nested ConcurrentCoupling)
                ot = {
                    name: flag and overwrite_tendencies.get(name, True)
                    for name, flag in self_ot.items()
                }
                tendencies, new_diags = component(
                    aux_state,
                    timestep,
                    out_tendencies=tendencies,
                    out_diagnostics=None,
                    overwrite_tendencies=ot,
                )
                diagnostics.update(new_diags)
                aux_state.update(
                    {k: new_diags[k] for k in _diag_props(component) if k in new_diags}
                )
        return tendencies, diagnostics

    def _call_asparallel(
        self, state, timestep, out_tendencies, out_diagnostics, overwrite_tendencies
    ):
        """reference ``concurrent_coupling.py:381``"""
        tendencies: Dict[str, Any] = dict(out_tendencies or {})
        diagnostics: Dict[str, Any] = dict(out_diagnostics or {})
        overwrite_tendencies = overwrite_tendencies or {}

        for component, self_ot in zip(self._components, self.overwrite_tendencies):
            if isinstance(component, self.allowed_diagnostic_type):
                diagnostics.update(component(state))
            elif isinstance(component, FromTendencyToDiagnostic):
                pass  # order-dependent: meaningless under as_parallel
            elif isinstance(component, FromDiagnosticToTendency):
                tendencies = merge_tendencies(tendencies, component(state), None)
            else:
                ot = {
                    name: flag and overwrite_tendencies.get(name, True)
                    for name, flag in self_ot.items()
                }
                tendencies, new_diags = component(
                    state,
                    timestep,
                    out_tendencies=tendencies,
                    out_diagnostics=None,
                    overwrite_tendencies=ot,
                )
                diagnostics.update(new_diags)
        return tendencies, diagnostics
