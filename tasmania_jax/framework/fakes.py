"""No-op stand-in components for tests and composition
(reference ``src/tasmania/framework/fakes.py:34,54``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from tasmania_jax.framework.core_components import TendencyComponent


class FakeTendencyComponent(TendencyComponent):
    """Produces no tendencies and no diagnostics."""

    @property
    def input_properties(self):
        return {}

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        return {}

    def array_call(self, state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return {}, {}


class FakeComponent:
    """Property-only shell wrapping another component's property dicts
    (reference ``fakes.py:54``)."""

    def __init__(self, src, property_names: Mapping[str, str]) -> None:
        for trg_name, src_name in property_names.items():
            setattr(self, trg_name, getattr(src, src_name))
