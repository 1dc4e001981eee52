"""Chains of diagnostic-only components.

JAX re-design of reference ``src/tasmania/framework/composite.py:41,76,123``
(``DiagnosticComponentComposite`` with serial / as_parallel policies).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from tasmania_jax.utils.units import units_are_compatible
from tasmania_jax.utils.exceptions import PropertyError


class DiagnosticComponentComposite:
    def __init__(self, *args, execution_policy: str = "serial") -> None:
        self._components = args
        self._policy = (
            execution_policy if execution_policy in ("serial", "as_parallel") else "serial"
        )

        self.input_properties: Dict[str, Any] = {}
        self.diagnostic_properties: Dict[str, Any] = {}
        available: set = set()
        for c in args:
            for name, props in (getattr(c, "input_properties", {}) or {}).items():
                if name not in available and name not in self.input_properties:
                    self.input_properties[name] = dict(props)
                elif name in self.input_properties and not units_are_compatible(
                    self.input_properties[name].get("units", "1"),
                    props.get("units", "1"),
                ):
                    raise PropertyError(f"incompatible units for input {name!r}")
            diag = getattr(c, "diagnostic_properties", {}) or {}
            self.diagnostic_properties.update({k: dict(v) for k, v in diag.items()})
            if self._policy == "serial":
                available |= set(diag.keys())

    @property
    def components(self):
        return self._components

    @property
    def execution_policy(self) -> str:
        return self._policy

    def __call__(
        self, state: Mapping[str, Any], *, out: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, Any]:
        diagnostics: Dict[str, Any] = dict(out or {})
        if self._policy == "serial":
            aux_state = dict(state)
            for c in self._components:
                new = c(aux_state)
                diagnostics.update(new)
                aux_state.update(new)
        else:
            for c in self._components:
                diagnostics.update(c(state))
        if "time" in state:
            diagnostics["time"] = state["time"]
        return diagnostics
