"""Units-aware field container — the pytree replacement for sympl's ``DataArray``.

The reference carries model state as dicts of sympl/xarray ``DataArray`` (units +
dims metadata attached at runtime; reference ``src/tasmania/utils/storage.py:49,134``).
Under ``jax.jit`` the metadata must be *static* so state dicts trace cleanly; a
``FieldArray`` is therefore a pytree whose only child is the device array, with
``units``/``dims`` as hashable aux data.  Unit conversion lowers to one scalar
multiply that XLA folds into neighbouring ops.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tasmania_jax.utils.units import conversion_factor, units_are_same

DimNames = Tuple[str, ...]

#: dimension-name conventions for staggered fields; a field whose *name* contains
#: the key is staggered along the value axis (reference:
#: ``framework/base_components.py:68-89`` ``get_field_grid_shape``).
STAGGER_X = "at_u_locations"
STAGGER_Y = "at_v_locations"
STAGGER_Z = "on_interface_levels"


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FieldArray:
    """A named array with units and dimension labels; a jit-safe pytree."""

    data: Any  # jnp.ndarray | np.ndarray
    units: str = "1"
    dims: DimNames = ("x", "y", "z")

    # -- pytree protocol ---------------------------------------------------- #
    def tree_flatten(self):
        return (self.data,), (self.units, self.dims)

    @classmethod
    def tree_unflatten(cls, aux, children):
        units, dims = aux
        return cls(children[0], units, dims)

    # -- basic API ---------------------------------------------------------- #
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def values(self):
        return self.data

    def to_units(self, units: str) -> "FieldArray":
        """Return the field expressed in ``units`` (no-op when already there)."""
        if units_are_same(self.units, units):
            return FieldArray(self.data, units, self.dims)
        factor = conversion_factor(self.units, units)
        return FieldArray(self.data * self.data.dtype.type(factor), units, self.dims)

    def with_data(self, data) -> "FieldArray":
        return FieldArray(data, self.units, self.dims)

    def astype(self, dtype) -> "FieldArray":
        return FieldArray(self.data.astype(dtype), self.units, self.dims)

    def __repr__(self):
        return f"FieldArray(shape={tuple(self.shape)}, units={self.units!r}, dims={self.dims})"


State = Dict[str, Union[FieldArray, datetime]]


def field_stagger_axes(name: str) -> Tuple[bool, bool, bool]:
    """(x-staggered, y-staggered, z-staggered) inferred from the field name."""
    return (STAGGER_X in name, STAGGER_Y in name, STAGGER_Z in name)


def field_dims(name: str, base: DimNames = ("x", "y", "z")) -> DimNames:
    sx, sy, sz = field_stagger_axes(name)
    out = []
    for ax, stag, tag in zip(base, (sx, sy, sz), (STAGGER_X, STAGGER_Y, STAGGER_Z)):
        out.append(f"{ax}_{tag}" if stag else ax)
    return tuple(out)


def field_shape(name: str, grid_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Shape of field ``name`` on a grid with ``grid_shape`` mass points."""
    sx, sy, sz = field_stagger_axes(name)
    nx, ny, nz = grid_shape
    return (nx + int(sx), ny + int(sy), nz + int(sz))


# --------------------------------------------------------------------------- #
# state helpers                                                               #
# --------------------------------------------------------------------------- #


def get_array_dict(
    state: Mapping[str, Any], properties: Mapping[str, Mapping[str, Any]]
) -> Dict[str, Any]:
    """Extract raw arrays from ``state`` converted to the units in ``properties``.

    JAX analogue of the reference's input operators
    (``framework/dycore_utils.py`` dynamic operators): components compute on raw
    arrays; unit conversion happens here at the boundary.
    """
    out: Dict[str, Any] = {}
    for name, props in properties.items():
        field = state[name]
        if isinstance(field, FieldArray):
            out[name] = field.to_units(props["units"]).data
        else:  # raw array assumed already in requested units
            out[name] = field
    return out


def get_field_dict(
    raw: Mapping[str, Any],
    properties: Mapping[str, Mapping[str, Any]],
    time: Optional[datetime] = None,
) -> State:
    """Wrap raw arrays back into ``FieldArray``s according to ``properties``."""
    out: State = {}
    for name, arr in raw.items():
        if name == "time":
            continue
        props = properties.get(name, {})
        out[name] = FieldArray(arr, props.get("units", "1"), field_dims(name))
    if time is not None:
        out["time"] = time
    return out


def ensure_timedelta_seconds(dt: Union[float, int, timedelta]) -> float:
    """Normalise a timestep (float seconds or ``timedelta``) to float seconds."""
    if isinstance(dt, timedelta):
        return dt.total_seconds()
    return float(dt)
