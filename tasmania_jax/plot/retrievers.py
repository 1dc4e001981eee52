"""Data retrieval from states for plotting
(reference ``src/tasmania/plot/retrievers.py:32,273``)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.utils.array import to_numpy


class DataRetriever:
    """Extract (a slice of) one field from a state, in requested units."""

    def __init__(
        self,
        grid,
        field_name: str,
        field_units: Optional[str] = None,
        x: Optional[slice] = None,
        y: Optional[slice] = None,
        z: Optional[slice] = None,
    ) -> None:
        self.grid = grid
        self.field_name = field_name
        self.field_units = field_units
        self.x = x if x is not None else slice(None)
        self.y = y if y is not None else slice(None)
        self.z = z if z is not None else slice(None)

    def __call__(self, state: Mapping[str, Any]) -> np.ndarray:
        fa = state[self.field_name]
        if isinstance(fa, FieldArray):
            data = fa.to_units(self.field_units).data if self.field_units else fa.data
        else:
            data = fa
        arr = to_numpy(data)
        idx = (self.x, self.y, self.z)[: arr.ndim]
        return np.squeeze(arr[idx])


class DataRetrieverComposite:
    """Retrieve several fields, possibly from several states."""

    def __init__(self, grid, fields: Sequence[Mapping[str, Any]]) -> None:
        self._retrievers = [
            DataRetriever(
                grid,
                spec["field_name"],
                spec.get("field_units"),
                spec.get("x"),
                spec.get("y"),
                spec.get("z"),
            )
            for spec in fields
        ]

    def __call__(self, *states):
        if len(states) == 1:
            return [r(states[0]) for r in self._retrievers]
        return [r(state) for r, state in zip(self._retrievers, states)]
