"""State-level storage helpers.

JAX re-design of reference ``src/tasmania/utils/storage.py:261-566``:
physical⇄numerical grid state mapping (through the domain's boundary object)
and deep copies.  ``get_dataarray_3d``'s role (units+dims wrapping) is covered
by :class:`FieldArray` + ``field_dims``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from tasmania_jax.framework.field import FieldArray, field_dims


def get_numerical_state(domain, state: Mapping[str, Any]) -> Dict[str, Any]:
    """Map a physical-grid state onto the numerical grid
    (reference ``storage.py:354``)."""
    hb = domain.horizontal_boundary
    out: Dict[str, Any] = {}
    for name, fa in state.items():
        if name == "time" or not isinstance(fa, FieldArray):
            out[name] = fa
            continue
        out[name] = fa.with_data(hb.get_numerical_field(fa.data, name))
    return out


def get_physical_state(domain, state: Mapping[str, Any]) -> Dict[str, Any]:
    """Map a numerical-grid state back onto the physical grid
    (reference ``storage.py:404``)."""
    hb = domain.horizontal_boundary
    out: Dict[str, Any] = {}
    for name, fa in state.items():
        if name == "time" or not isinstance(fa, FieldArray):
            out[name] = fa
            continue
        out[name] = fa.with_data(hb.get_physical_field(fa.data, name))
    return out


def deepcopy_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Host-side deep copy of a state dict (reference ``storage.py:518-566``).
    Device arrays are copied through numpy (forces materialisation)."""
    out: Dict[str, Any] = {}
    for name, fa in state.items():
        if isinstance(fa, FieldArray):
            out[name] = fa.with_data(np.array(np.asarray(fa.data), copy=True))
        else:
            out[name] = fa
    return out
