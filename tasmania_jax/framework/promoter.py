"""Promoters: rename/copy fields across the tendency ⇄ diagnostic namespaces.

JAX re-design of reference ``src/tasmania/framework/promoter.py:50,179``
(used e.g. to feed ``tendency_of_air_potential_temperature`` between Kessler
microphysics and vertical advection, driver ``driver_namelist_sus.py:279-341``).
Functionally these are pytree key remaps — free under jit.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional

from tasmania_jax.framework.base_components import DomainComponent
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.stencil import StencilFactory

PropertyDict = Mapping[str, Mapping[str, Any]]


class FromDiagnosticToTendency(DomainComponent, StencilFactory, abc.ABC):
    """Lift state diagnostics into the tendency namespace
    (reference ``promoter.py:50``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        DomainComponent.__init__(self, domain, grid_type)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self.tendency_properties = {
            props.get("tendency_name", name): {
                k: v for k, v in props.items() if k != "tendency_name"
            }
            for name, props in self.input_properties.items()
        }

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        """{diagnostic_name: {dims, units, tendency_name}}"""

    def __call__(
        self, state: Mapping[str, Any], *, out: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, FieldArray]:
        result: Dict[str, FieldArray] = dict(out or {})
        for name, props in self.input_properties.items():
            tendency_name = props.get("tendency_name", name)
            fa = state[name]
            if isinstance(fa, FieldArray):
                fa = fa.to_units(props["units"])
            result[tendency_name] = fa
        return result


class FromTendencyToDiagnostic(DomainComponent, StencilFactory, abc.ABC):
    """Expose computed tendencies as state diagnostics
    (reference ``promoter.py:179``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        DomainComponent.__init__(self, domain, grid_type)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self.diagnostic_properties = {
            props.get("diagnostic_name", f"tendency_of_{name}"): {
                k: v for k, v in props.items() if k != "diagnostic_name"
            }
            for name, props in self.input_tendency_properties.items()
        }

    @property
    @abc.abstractmethod
    def input_tendency_properties(self) -> PropertyDict:
        """{tendency_name: {dims, units, diagnostic_name}}"""

    def __call__(
        self, tendencies: Mapping[str, Any], *, out: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, FieldArray]:
        result: Dict[str, FieldArray] = dict(out or {})
        for name, props in self.input_tendency_properties.items():
            diag_name = props.get("diagnostic_name", f"tendency_of_{name}")
            fa = tendencies[name]
            if isinstance(fa, FieldArray):
                fa = fa.to_units(props["units"])
            result[diag_name] = fa
        return result
