"""The component protocol: Diagnostic / Tendency / ImplicitTendency / Stepper.

JAX replacement for the sympl component kinds that the reference
subclasses (reference ``src/tasmania/framework/core_components.py:48,112,202,259``;
sympl dependency noted in SURVEY.md honesty note 4 — this framework provides its
own component/properties/units protocol).

Design shift versus the reference:

* Components are **pure**: ``array_call`` maps raw arrays to raw arrays; the
  public ``__call__`` does units conversion at the boundary and wraps results
  into ``FieldArray``s.  No out-buffers — XLA's buffer donation replaces the
  reference's preallocated-output idiom.
* Property declarations (``{name: {"dims": ..., "units": ...}}``) are checked
  at *build/trace* time, never inside the hot path.
* Everything composes under ``jax.jit``: a coupler calling ten components
  traces into one fused XLA computation.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple

from tasmania_jax.framework.base_components import DomainComponent
from tasmania_jax.framework.field import (
    FieldArray,
    field_dims,
    get_array_dict,
    ensure_timedelta_seconds,
)
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.timer import Timer

PropertyDict = Mapping[str, Mapping[str, Any]]


def _wrap_outputs(raw: Mapping[str, Any], properties: PropertyDict) -> Dict[str, FieldArray]:
    out: Dict[str, FieldArray] = {}
    for name, arr in raw.items():
        props = properties.get(name, {})
        out[name] = FieldArray(arr, props.get("units", "1"), field_dims(name))
    return out


def merge_tendencies(
    out_tendencies: Optional[Mapping[str, FieldArray]],
    new: Mapping[str, FieldArray],
    overwrite: Optional[Mapping[str, bool]] = None,
) -> Dict[str, FieldArray]:
    """Functional tendency accumulation: sum with pre-existing entries unless
    the per-variable overwrite flag is set (reference CC tendency-summation
    semantics, ``concurrent_coupling.py:316-381``)."""
    merged: Dict[str, FieldArray] = dict(out_tendencies or {})
    overwrite = overwrite or {}
    for name, fa in new.items():
        if name == "time":
            continue
        if name in merged and not overwrite.get(name, False):
            prev = merged[name]
            merged[name] = prev.with_data(prev.data + fa.to_units(prev.units).data)
        else:
            merged[name] = fa
    return merged


class _ComponentBase(DomainComponent, StencilFactory, abc.ABC):
    """Shared scaffolding: domain binding + backend bundle + timing."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        physical_constants: Optional[Mapping[str, Any]] = None,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        DomainComponent.__init__(self, domain, grid_type)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        from tasmania_jax.utils.constants import get_physical_constants

        self._physical_constants_overrides = physical_constants
        defaults = getattr(self, "default_physical_constants", {})
        self.rpc = get_physical_constants(defaults, physical_constants)

    # subclasses may extend
    default_physical_constants: Dict[str, Any] = {}


class DiagnosticComponent(_ComponentBase):
    """Computes diagnostics from the state (reference ``core_components.py:48``)."""

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def diagnostic_properties(self) -> PropertyDict:
        ...

    @abc.abstractmethod
    def array_call(self, state: Mapping[str, Any]) -> Dict[str, Any]:
        """Raw arrays in (declared units) -> raw diagnostics out."""

    def __call__(
        self, state: Mapping[str, Any], *, out: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, FieldArray]:
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_diags = self.array_call(raw)
        result = _wrap_outputs(raw_diags, self.diagnostic_properties)
        if out is not None:
            merged = dict(out)
            merged.update(result)
            return merged
        return result


class TendencyComponent(_ComponentBase):
    """Computes tendencies (+ diagnostics) from the state
    (reference ``core_components.py:259``)."""

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def tendency_properties(self) -> PropertyDict:
        ...

    @property
    def diagnostic_properties(self) -> PropertyDict:
        return {}

    @abc.abstractmethod
    def array_call(
        self, state: Mapping[str, Any]
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state -> (raw tendencies, raw diagnostics)."""

    def __call__(
        self,
        state: Mapping[str, Any],
        timestep=None,
        *,
        out_tendencies: Optional[Mapping[str, FieldArray]] = None,
        out_diagnostics: Optional[Mapping[str, FieldArray]] = None,
        overwrite_tendencies: Optional[Mapping[str, bool]] = None,
    ) -> Tuple[Dict[str, FieldArray], Dict[str, FieldArray]]:
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_tends, raw_diags = self.array_call(raw)
        tends = _wrap_outputs(raw_tends, self.tendency_properties)
        diags = _wrap_outputs(raw_diags, self.diagnostic_properties)
        tends = merge_tendencies(out_tendencies, tends, overwrite_tendencies)
        if out_diagnostics is not None:
            merged = dict(out_diagnostics)
            merged.update(diags)
            diags = merged
        return tends, diags


class ImplicitTendencyComponent(TendencyComponent):
    """Tendency component whose tendencies depend on the timestep
    (reference ``core_components.py:112``)."""

    @abc.abstractmethod
    def array_call(
        self, state: Mapping[str, Any], timestep: float
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state + dt (seconds) -> (raw tendencies, raw diagnostics)."""

    def __call__(
        self,
        state: Mapping[str, Any],
        timestep=None,
        *,
        out_tendencies: Optional[Mapping[str, FieldArray]] = None,
        out_diagnostics: Optional[Mapping[str, FieldArray]] = None,
        overwrite_tendencies: Optional[Mapping[str, bool]] = None,
    ) -> Tuple[Dict[str, FieldArray], Dict[str, FieldArray]]:
        dt = ensure_timedelta_seconds(timestep) if timestep is not None else 0.0
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_tends, raw_diags = self.array_call(raw, dt)
        tends = _wrap_outputs(raw_tends, self.tendency_properties)
        diags = _wrap_outputs(raw_diags, self.diagnostic_properties)
        tends = merge_tendencies(out_tendencies, tends, overwrite_tendencies)
        if out_diagnostics is not None:
            merged = dict(out_diagnostics)
            merged.update(diags)
            diags = merged
        return tends, diags


class Stepper(_ComponentBase):
    """Directly steps a subset of the state over a timestep
    (reference ``core_components.py:202``)."""

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def output_properties(self) -> PropertyDict:
        ...

    @property
    def diagnostic_properties(self) -> PropertyDict:
        return {}

    @abc.abstractmethod
    def array_call(
        self, state: Mapping[str, Any], timestep: float
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state + dt (seconds) -> (raw diagnostics, raw new state)."""

    def __call__(
        self, state: Mapping[str, Any], timestep
    ) -> Tuple[Dict[str, FieldArray], Dict[str, FieldArray]]:
        dt = ensure_timedelta_seconds(timestep)
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_diags, raw_out = self.array_call(raw, dt)
        diags = _wrap_outputs(raw_diags, self.diagnostic_properties)
        out = _wrap_outputs(raw_out, self.output_properties)
        if "time" in state:
            from datetime import timedelta

            out["time"] = state["time"] + timedelta(seconds=dt)
        return diags, out
