"""Lateral boundary handling: numerical⇄physical mapping + physical BCs.

JAX re-design of reference ``src/tasmania/domain/horizontal_boundary.py:44``.
Two deliberate departures from the reference:

* **Functional semantics** — ``enforce_field`` and friends return *new* arrays
  (the reference mutates in place); this is what ``jax.jit`` requires, and XLA
  fuses the edge pastes into neighbouring kernels.
* **Halo-awareness** — in the distributed build this same interface is
  implemented per-shard: physical BCs apply only on shards owning true domain
  edges while interior edges are filled by ppermute halo exchange (see
  ``tasmania_jax.parallel``); the single-device classes here are the exact
  semantics that path must reproduce.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


def change_dims(axis: FieldArray, dims: Optional[str] = None) -> FieldArray:
    return FieldArray(axis.data, axis.units, (dims,) if dims else axis.dims)


def extend_axis(axis: FieldArray, nb: int, dims: Optional[str] = None) -> FieldArray:
    """Linearly extend a 1-D coordinate axis by ``nb`` points on each side."""
    v = np.asarray(axis.data)
    if v.shape[0] > 1:
        d = v[1] - v[0]
    else:
        d = 1.0
    left = v[0] - d * np.arange(nb, 0, -1)
    right = v[-1] + d * np.arange(1, nb + 1)
    out = np.concatenate([left, v, right]).astype(v.dtype)
    return FieldArray(out, axis.units, (dims,) if dims else axis.dims)


def repeat_axis(axis: FieldArray, nb: int, dims: Optional[str] = None) -> FieldArray:
    """Pad a singleton axis by repeating its value ``nb`` times on each side,
    offset by the (unit) spacing — mirrors reference ``repeat_axis``."""
    v = np.asarray(axis.data)
    if v.shape[0] == 1:
        out = np.concatenate([np.repeat(v[:1], nb), v, np.repeat(v[-1:], nb)])
    else:  # staggered companion of a singleton axis (2 points)
        out = np.concatenate([np.repeat(v[:1], nb), v, np.repeat(v[-1:], nb)])
    return FieldArray(out.astype(v.dtype), axis.units, (dims,) if dims else axis.dims)


def field_extent(
    field_name: Optional[str], ni: int, nj: int, nz: int
) -> Tuple[int, int, int]:
    """Computational extent (mi, mj, mk) of a named field on the numerical grid
    (reference ``relaxed.py:123-140`` naming convention)."""
    name = field_name or ""
    mi = ni + 1 if ("at_u_locations" in name or "at_uv_locations" in name) else ni
    mj = nj + 1 if ("at_v_locations" in name or "at_uv_locations" in name) else nj
    mk = nz + 1 if "on_interface_levels" in name else nz
    return mi, mj, mk


def paste(arr, idx, value):
    """Functional slice assignment working for numpy and jax arrays."""
    if get_namespace(arr) is np:
        out = np.array(arr, copy=True)
        out[idx] = value
        return out
    return arr.at[idx].set(value)


class HorizontalBoundary(StencilFactory, abc.ABC):
    """ABC + factory (reference ``horizontal_boundary.py:44,437``)."""

    registry: Dict[str, Any] = {}

    def __init__(
        self,
        grid,
        nb: int,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self._pgrid = grid
        self._nb = nb
        # deferred import to avoid cycle
        from tasmania_jax.domain.grid import NumericalGrid

        self._ngrid = NumericalGrid(self)
        self._type = ""
        self._kwargs: Dict[str, Any] = {}
        self._ref_state: Optional[Dict[str, Any]] = None

    # -- basic properties ---------------------------------------------------- #
    @property
    def nb(self) -> int:
        return self._nb

    @property
    def nx(self) -> int:
        return self._pgrid.nx

    @property
    def ny(self) -> int:
        return self._pgrid.ny

    @property
    def nz(self) -> int:
        return self._pgrid.nz

    @property
    def physical_grid(self):
        return self._pgrid

    @property
    def numerical_grid(self):
        return self._ngrid

    @property
    def kwargs(self) -> Dict[str, Any]:
        return self._kwargs

    @property
    def type(self) -> str:
        return self._type

    @type.setter
    def type(self, value: str) -> None:
        self._type = value

    @property
    def reference_state(self) -> Dict[str, Any]:
        return self._ref_state if self._ref_state is not None else {}

    @reference_state.setter
    def reference_state(self, ref_state: Mapping[str, Any]) -> None:
        self._ref_state = dict(ref_state)

    # -- abstract geometry ---------------------------------------------------- #
    @property
    @abc.abstractmethod
    def ni(self) -> int:
        """Numerical-grid mass points along x."""

    @property
    @abc.abstractmethod
    def nj(self) -> int:
        """Numerical-grid mass points along y."""

    @abc.abstractmethod
    def get_numerical_xaxis(self, dims: Optional[str] = None) -> FieldArray:
        ...

    @abc.abstractmethod
    def get_numerical_xaxis_staggered(self, dims: Optional[str] = None) -> FieldArray:
        ...

    @abc.abstractmethod
    def get_numerical_yaxis(self, dims: Optional[str] = None) -> FieldArray:
        ...

    @abc.abstractmethod
    def get_numerical_yaxis_staggered(self, dims: Optional[str] = None) -> FieldArray:
        ...

    @abc.abstractmethod
    def get_numerical_field(self, field, field_name: Optional[str] = None):
        """Physical-grid raw field -> numerical-grid raw field (returns new array)."""

    @abc.abstractmethod
    def get_physical_field(self, field, field_name: Optional[str] = None):
        """Numerical-grid raw field -> physical-grid raw field (returns new array)."""

    @abc.abstractmethod
    def enforce_field(
        self,
        field,
        field_name: Optional[str] = None,
        field_units: Optional[str] = None,
        time=None,
    ):
        """Return ``field`` with lateral BCs enforced (functional)."""

    @abc.abstractmethod
    def set_outermost_layers_x(
        self, field, field_name=None, field_units=None, time=None
    ):
        """Return x-staggered ``field`` with its outermost x-layers set."""

    @abc.abstractmethod
    def set_outermost_layers_y(
        self, field, field_name=None, field_units=None, time=None
    ):
        """Return y-staggered ``field`` with its outermost y-layers set."""

    # -- bulk wrappers -------------------------------------------------------- #
    def enforce_raw(
        self,
        state: Mapping[str, Any],
        field_properties: Optional[Mapping[str, Mapping[str, Any]]] = None,
    ) -> Dict[str, Any]:
        """Functional counterpart of reference ``enforce_raw`` (``:299``)."""
        ref = self.reference_state
        rfps = {
            name: {"units": ref[name].units}
            for name in ref
            if name != "time" and isinstance(ref[name], FieldArray)
        }
        fps = (
            rfps
            if field_properties is None
            else {k: v for k, v in field_properties.items() if k in rfps}
        )
        time = state.get("time", None)
        out = dict(state)
        for name in state:
            if name == "time" or name not in fps:
                continue
            units = fps[name].get("units", rfps[name]["units"])
            out[name] = self.enforce_field(
                state[name], field_name=name, field_units=units, time=time
            )
        return out

    def enforce(
        self, state: Mapping[str, Any], field_names: Optional[Sequence[str]] = None
    ) -> Dict[str, Any]:
        """Functional counterpart of reference ``enforce`` (``:348``)."""
        ref = self.reference_state
        fns = (
            tuple(n for n in ref if n != "time")
            if field_names is None
            else tuple(n for n in field_names if n in ref)
        )
        time = state.get("time", None)
        out = dict(state)
        for name in fns:
            if name not in state:
                continue
            fa = state[name]
            new_data = self.enforce_field(
                fa.data, field_name=name, field_units=fa.units, time=time
            )
            out[name] = fa.with_data(new_data)
        return out

    # -- distribution hooks ------------------------------------------------------ #
    # These are the seams where the distributed build (``tasmania_jax.parallel.
    # distributed.DistributedBoundary``) splices halo exchange and global-frame
    # masking into the SAME component code paths that run single-device
    # (SURVEY.md §2.8/§5.8: the reference's ``enforce_*`` ghost-layer sites,
    # ``horizontal_boundary.py:44``, become the communication layer).  On a
    # single device they are all identity/no-cost.

    def refresh_halos(self, field, field_name: Optional[str] = None):
        """Validate the ghost layers of ``field``.

        Single device: identity (the numerical grid either has no ghost frame,
        or — periodic — the frame is maintained by ``enforce_field``).
        Distributed: ppermute halo exchange with the neighbouring shards.
        Components whose stencil outputs leave ghost layers stale (smoothing,
        Smagorinsky tendencies) call this on their outputs."""
        return field

    def refresh_halos_many(self, fields, field_names=None):
        """Bulk :meth:`refresh_halos`: single-device identity; distributed, one
        packed exchange for the whole list (2 collectives per axis total)."""
        return list(fields)

    def restrict_stencil_output(
        self, out, base=None, nb: Optional[int] = None, field_name=None
    ):
        """Restrict a stencil-computed ``out`` to the computational domain.

        The caller has already written its locally-computed interior into
        ``out`` (frame values taken from ``base`` or zero).  Single device the
        local frame IS the physical-domain frame, so this is identity.
        Distributed: additionally keep ``base`` (zero if None) on cells within
        ``nb`` of the *global* domain edge — the cells the single-device
        stencil never writes (reference computation domains
        ``origin=(nb,nb,0)``, ``rk3ws_si.py:175``)."""
        return out

    def zero_physical_frame(self, full, nb: int, field_name=None):
        """Zero ``full`` on the nb-wide frame of the *physical* domain, keeping
        the (pointwise-computed) values elsewhere.  For pointwise tendencies
        (e.g. Coriolis) that the reference restricts to the nb-inset interior:
        computing everywhere and masking the global frame keeps shard halos
        valid with no exchange."""
        from tasmania_jax.utils.array import get_namespace

        xp = get_namespace(full)
        if xp is np:
            out = np.zeros_like(full)
        else:
            out = xp.zeros_like(full)
        sl = (slice(nb, full.shape[0] - nb), slice(nb, full.shape[1] - nb))
        return paste(out, sl, full[sl])

    # -- reference-state access ------------------------------------------------ #
    def _ref_field(self, field_name: str, field_units: Optional[str]):
        ref = self.reference_state[field_name]
        if isinstance(ref, FieldArray):
            return ref.to_units(field_units).data if field_units else ref.data
        return ref

    # -- factory --------------------------------------------------------------- #
    @staticmethod
    def factory(
        boundary_type: str,
        grid,
        nb: int,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> "HorizontalBoundary":
        child_kwargs = {
            "backend": backend,
            "backend_options": backend_options,
            "storage_options": storage_options,
        }
        child_kwargs.update(kwargs)
        obj = factorize(boundary_type, HorizontalBoundary, (grid, nb), child_kwargs)
        obj.type = boundary_type
        return obj
