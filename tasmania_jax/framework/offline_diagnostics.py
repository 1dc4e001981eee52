"""Offline comparison metrics between saved states
(reference ``src/tasmania/framework/offline_diagnostics.py:190,291,392``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.utils.array import to_numpy


def _get(state, name, units, sx, sy, sz):
    fa = state[name]
    arr = to_numpy(fa.to_units(units).data if isinstance(fa, FieldArray) else fa)
    return arr[sx or slice(None), sy or slice(None), sz or slice(None)]


class OfflineDiagnosticComponent:
    """Base: callable on two states, returns {name: metric value}."""

    def __call__(self, state1, state2) -> Dict[str, float]:
        raise NotImplementedError


class RMSD(OfflineDiagnosticComponent):
    """Root-mean-square deviation (reference ``offline_diagnostics.py:190``)."""

    def __init__(self, grid, fields: Mapping[str, Mapping[str, Any]], x=None, y=None, z=None):
        self._fields = fields
        self._x, self._y, self._z = x, y, z

    def __call__(self, state1, state2) -> Dict[str, float]:
        out = {}
        for name, props in self._fields.items():
            u = props.get("units", "1")
            a = _get(state1, name, u, self._x, self._y, self._z)
            b = _get(state2, name, u, self._x, self._y, self._z)
            out[name] = float(np.sqrt(np.mean((a - b) ** 2)))
        return out


class RRMSD(OfflineDiagnosticComponent):
    """Relative RMSD (reference ``offline_diagnostics.py:291``)."""

    def __init__(self, grid, fields: Mapping[str, Mapping[str, Any]], x=None, y=None, z=None):
        self._fields = fields
        self._x, self._y, self._z = x, y, z

    def __call__(self, state1, state2) -> Dict[str, float]:
        out = {}
        for name, props in self._fields.items():
            u = props.get("units", "1")
            a = _get(state1, name, u, self._x, self._y, self._z)
            b = _get(state2, name, u, self._x, self._y, self._z)
            denom = np.sqrt(np.sum(b**2))
            out[name] = float(np.sqrt(np.sum((a - b) ** 2)) / denom) if denom else 0.0
        return out


class ColumnSum(OfflineDiagnosticComponent):
    """Per-column vertical sum of one field
    (reference ``offline_diagnostics.py:392``)."""

    def __init__(self, grid, field_name: str, field_units: str):
        self._name = field_name
        self._units = field_units

    def __call__(self, state, state2=None) -> np.ndarray:
        fa = state[self._name]
        arr = to_numpy(
            fa.to_units(self._units).data if isinstance(fa, FieldArray) else fa
        )
        return arr.sum(axis=2)
