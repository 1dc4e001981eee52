"""Framework-integrated domain decomposition: the distributed HorizontalBoundary.

This module makes the REAL framework — ``IsentropicDynamicalCore``, the physics
chain, every component written against ``HorizontalBoundary`` — run under
explicit ``shard_map`` with ppermute halo exchange, with **no duplicated
numerics**: each shard executes the unmodified single-device component code on
a halo-extended local block, and the boundary object supplies the distributed
semantics at exactly the reference's ghost-layer seams
(reference ``src/tasmania/domain/horizontal_boundary.py:44`` ``enforce_*`` /
``set_outermost_layers_*`` sites; SURVEY.md §2.8/§5.8).

Design (all inside one ``shard_map``-traced step):

* every (nx, ny, …) cell field is carried globally block-sharded
  ``P('x','y',None)``; at step entry it is padded by ``nb`` ghost layers and
  halo-exchanged; at step exit the owned block is cropped back out;
* staggered fields cross the shard boundary **cell-anchored** (face ``i`` of
  cell ``i``, shape (nx, …)); inside the step the local (lx+1, …) staggered
  view is rebuilt by appending one (never-read) face — fluxes only consume
  faces ``[e, lx−e]`` (``horizontal_fluxes.py`` index convention), and the
  outermost *global* faces are pinned by ``set_outermost_layers_*``;
* ``enforce_field`` = physical BC on every local cell (a three-way ``where``
  against per-shard windows of the global relaxation coefficients and
  reference fields — exact ``boundaries/relaxed.py:133`` algebra) followed by
  halo exchange — so ghost layers are valid from the very sites where the
  single-device algorithm enforces BCs;
* pointwise/column-local ops (Kessler, saturation adjustment, vertical
  scans/solves, damping, dict algebra) preserve halo validity for free, so no
  further exchanges are needed; stencil components with un-enforced outputs
  (smoothing, Smagorinsky) call ``refresh_halos`` on them (see the hooks on
  ``HorizontalBoundary``).

Supported inner boundary types: ``relaxed`` (the flagship), ``periodic``,
``identity``, and ``dirichlet`` with time-independent (numpy-returning) cores
— the core is evaluated host-side over the global boundary bands at setup and
windowed per shard (``_dirichlet_pin_global``).  Unsupported, raising loudly
(tests/test_distributed_framework.py): 1-D grids (``AssertionError`` at
construction) and time-dependent Dirichlet cores returning traced jax arrays
(``NotImplementedError`` at ``set_reference_state``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from tasmania_jax.domain.grid import PhysicalGrid
from tasmania_jax.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    extend_axis,
    field_extent,
)
from tasmania_jax.framework.field import FieldArray, field_stagger_axes
from tasmania_jax.parallel.halo import halo_exchange
from tasmania_jax.parallel.mesh import CartesianDecomposition


class LocalDomain:
    """Per-shard domain shim: the object components bind to when they are
    constructed for distributed execution (same surface as ``domain.Domain``)."""

    def __init__(self, boundary: "DistributedBoundary") -> None:
        self._hb = boundary

    @property
    def physical_grid(self):
        return self._hb.physical_grid

    @property
    def numerical_grid(self):
        return self._hb.numerical_grid

    @property
    def horizontal_boundary(self):
        return self._hb

    def update_topography(self, time) -> None:  # traced topography is a state input
        pass


def _window_blocked(
    global_field: np.ndarray,
    decomp: CartesianDecomposition,
    staggered: Tuple[bool, bool],
    pad_value: float = 0.0,
    pad_mode: str = "constant",
) -> np.ndarray:
    """Tile the per-shard halo windows of a global constant into ONE blocked
    array shard-able ``P('x','y')``: block (i, j) of the result is shard
    (i, j)'s local view (owned block + halo ring; out-of-domain ghosts
    take the padding).  Host-side, runs once at setup."""
    hx, hy = decomp.pad_x, decomp.pad_y
    bx, by = decomp.bx, decomp.by
    px, py = decomp.px, decomp.py
    sx, sy = staggered
    f = np.asarray(global_field)
    pads = [(hx, hx), (hy, hy)] + [(0, 0)] * (f.ndim - 2)
    if pad_mode == "constant":
        fp = np.pad(f, pads, mode="constant", constant_values=pad_value)
    else:
        fp = np.pad(f, pads, mode="edge")
    lx = bx + 2 * hx + int(sx)
    ly = by + 2 * hy + int(sy)
    rows = []
    for i in range(px):
        cols = []
        for j in range(py):
            cols.append(fp[i * bx : i * bx + lx, j * by : j * by + ly])
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


class DistributedBoundary(HorizontalBoundary):
    """Halo-aware lateral boundary for one shard of a 2-D decomposition.

    Wraps an inner single-device boundary *type* (its physical-BC semantics)
    and reproduces them per-shard: BC algebra on per-shard windows of the
    global coefficient/reference arrays + ppermute halo exchange.  Constructed
    from the GLOBAL domain; the components are then built against
    ``LocalDomain(self)`` and traced inside ``shard_map``.
    """

    def __init__(
        self,
        global_domain,
        decomp: CartesianDecomposition,
        axis_names: Tuple[str, str] = ("x", "y"),
    ) -> None:
        ghb = global_domain.horizontal_boundary
        gpg = global_domain.physical_grid
        assert gpg.nx > 1 and gpg.ny > 1, "1-D grids are single-device-only"
        inner_type = ghb.type
        assert inner_type in ("relaxed", "periodic", "identity", "dirichlet"), (
            f"distributed build does not support boundary type {inner_type!r}"
        )

        self._global_hb = ghb
        self._decomp = decomp
        self._axis_names = axis_names
        self._gnx, self._gny = gpg.nx, gpg.ny
        nb = ghb.nb

        # local physical grid: the owned (bx, by) block; axes carry the right
        # spacings (only dx/dy/dz reach traced code — coordinates are host-side)
        dx = float(np.asarray(gpg.dx.data))
        dy = float(np.asarray(gpg.dy.data))
        lx_phys = decomp.bx + 2 * decomp.pad_x
        ly_phys = decomp.by + 2 * decomp.pad_y
        zhl = np.asarray(gpg.z_on_interface_levels.data)
        local_grid = PhysicalGrid(
            FieldArray(
                np.array([0.0, dx * (lx_phys - 1)]), gpg.x.units, (gpg.x.dims[0],)
            ),
            lx_phys,
            FieldArray(
                np.array([0.0, dy * (ly_phys - 1)]), gpg.y.units, (gpg.y.dims[0],)
            ),
            ly_phys,
            FieldArray(
                np.array([zhl[0], zhl[-1]]), gpg.z.units, (gpg.z.dims[0],)
            ),
            gpg.nz,
            z_interface=gpg.z_interface,
            topography_type="flat",  # hs is a traced state input in this path
        )
        # mirror the global topography's growth time so components that gate
        # on it (IsentropicDiagnostics input_properties) declare the same
        # inputs as single-device
        local_grid.topography._time = getattr(
            gpg.topography, "_time", local_grid.topography.time
        )

        super().__init__(local_grid, nb, backend="jax")
        self._type = f"distributed_{inner_type}"
        self._inner_type = inner_type
        self._kwargs = dict(ghb.kwargs)
        self._periodic = inner_type == "periodic"
        # explicit comm/compute overlap (SURVEY.md §2.8): halo exchanges
        # assemble by concatenation and the prognostic splits its stencils
        # into an interior band (pure slices of the pre-exchange core — no
        # dependency on the ppermutes) + four edge bands; XLA schedules the
        # interior concurrently with the collectives
        self.overlap_bands: bool = True

        # global physical-BC constants (host numpy, windowed at setup)
        self._host_consts: Dict[str, np.ndarray] = {}
        self._local_consts: Dict[str, Any] = {}
        self._build_bc_constants()

    # -- geometry: the numerical grid is the halo-extended local block -------- #
    @property
    def ni(self) -> int:
        return self._decomp.bx + 2 * self._decomp.pad_x

    @property
    def nj(self) -> int:
        return self._decomp.by + 2 * self._decomp.pad_y

    @property
    def pads(self) -> Tuple[int, int]:
        """Per-axis halo widths (0 on degenerate non-periodic axes)."""
        return (self._decomp.pad_x, self._decomp.pad_y)

    @property
    def is_degenerate(self) -> bool:
        """True when this 'decomposition' is a single pad-free shard — local
        coordinates equal global ones and every component runs the exact
        single-device program (the mesh(1,1) fast path)."""
        return (
            self._decomp.px == 1
            and self._decomp.py == 1
            and self._decomp.pad_x == 0
            and self._decomp.pad_y == 0
        )

    @property
    def decomposition(self) -> CartesianDecomposition:
        return self._decomp

    @property
    def axis_names(self) -> Tuple[str, str]:
        return self._axis_names

    def get_numerical_xaxis(self, dims=None):
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    def get_numerical_field(self, field, field_name=None):
        return field  # local physical grid already carries the ghost frame

    def get_physical_field(self, field, field_name=None):
        return field

    # -- per-shard constants ------------------------------------------------- #
    def _build_bc_constants(self) -> None:
        """Window the global BC data: relaxation coefficients (or the
        Dirichlet band indicator) and the reference fields."""
        ghb = self._global_hb
        nb = self._decomp.nb
        gnx, gny = self._gnx, self._gny

        if self._inner_type == "relaxed":
            # cell-point coefficients (boundaries/relaxed.py::_build_gamma)
            g_full = ghb._gamma  # (gnx+1, gny+1)
            self._host_consts["gamma"] = _window_blocked(
                g_full[:gnx, :gny], self._decomp, (False, False)
            )
        elif self._inner_type == "dirichlet":
            g = np.zeros((gnx, gny))
            g[:nb, :] = 1.0
            g[gnx - nb :, :] = 1.0
            g[:, :nb] = 1.0
            g[:, gny - nb :] = 1.0
            self._host_consts["gamma"] = _window_blocked(
                g, self._decomp, (False, False)
            )
        else:  # periodic / identity: no physical BC algebra
            self._host_consts["gamma"] = _window_blocked(
                np.zeros((gnx, gny)), self._decomp, (False, False)
            )

    def set_reference_state(self, ref_state: Mapping[str, Any]) -> Dict[str, Any]:
        """Window the GLOBAL reference state into blocked per-shard constants.

        Returns the full host-side constant dict (blocked numpy arrays) the
        runner must pass — sharded ``P('x','y',…)`` — into the traced step and
        hand back through :meth:`bind_local_constants`."""
        self._ref_meta: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        for name, fa in ref_state.items():
            if name == "time" or not isinstance(fa, FieldArray):
                continue
            # the decomposition is over the PHYSICAL domain: crop numerical-
            # grid reference fields (identity except under periodic BCs,
            # whose numerical grid carries a ghost frame)
            data = np.asarray(self._global_hb.get_physical_field(fa.data, name))
            if data.ndim < 2:
                continue
            sx, sy, _ = field_stagger_axes(name)
            self._host_consts[f"ref:{name}"] = _window_blocked(
                data, self._decomp, (sx, sy), pad_mode="edge"
            )
            if self._inner_type == "dirichlet":
                pin = self._dirichlet_pin_global(
                    name, fa.units, data, ref_state.get("time", None)
                )
                self._host_consts[f"pin:{name}"] = _window_blocked(
                    pin, self._decomp, (sx, sy), pad_mode="edge"
                )
            self._ref_meta[name] = (fa.units, fa.dims)
        return dict(self._host_consts)

    def _dirichlet_pin_global(self, name, units, data, time) -> np.ndarray:
        """Global pin target for a Dirichlet field: the user ``core`` evaluated
        over the four nb-wide global boundary bands (the windows the
        single-device class pastes, ``boundaries/dirichlet.py:119-152``), the
        interior left as the reference values (never read — gamma is 0 there).

        Only TIME-INDEPENDENT (numpy-returning) cores are supported
        distributed; a core returning a traced jax array raises."""
        core = self._global_hb.kwargs.get("core")
        if core is None:
            from tasmania_jax.domain.boundaries.dirichlet import placeholder

            core = placeholder
        nb = self.nb
        ggrid = self._global_hb.numerical_grid
        mi, mj = data.shape[:2]
        pin = np.array(data, copy=True)

        def band(si, sj):
            vals = core(time, ggrid, si, sj, name, units)
            if not isinstance(vals, (np.ndarray, list, tuple, float, int)):
                raise NotImplementedError(
                    "time-dependent Dirichlet cores (returning traced jax "
                    "arrays) are single-device-only; the distributed build "
                    "evaluates the core host-side at setup "
                    "(parallel/distributed.py::_dirichlet_pin_global)"
                )
            vals = np.asarray(vals, dtype=data.dtype)
            bi = si.stop - si.start
            bj = sj.stop - sj.start
            if data.ndim == 3:
                if vals.ndim == 2:
                    vals = vals[:, :, None]
                return np.broadcast_to(vals, (bi, bj, data.shape[2]))
            return np.broadcast_to(vals.reshape(bi, bj), (bi, bj))

        pin[0:nb, :] = band(slice(0, nb), slice(0, mj))
        pin[mi - nb :, :] = band(slice(mi - nb, mi), slice(0, mj))
        pin[nb : mi - nb, 0:nb] = band(slice(nb, mi - nb), slice(0, nb))
        pin[nb : mi - nb, mj - nb :] = band(
            slice(nb, mi - nb), slice(mj - nb, mj)
        )
        return pin

    @property
    def host_constants(self) -> Dict[str, np.ndarray]:
        return dict(self._host_consts)

    def bind_local_constants(self, consts: Mapping[str, Any]) -> None:
        """Install the traced per-shard windows (inside ``shard_map``)."""
        self._local_consts = dict(consts)

    # -- traced reference state ------------------------------------------------ #
    @property
    def reference_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, (units, dims) in getattr(self, "_ref_meta", {}).items():
            key = f"ref:{name}"
            if key in self._local_consts:
                out[name] = FieldArray(self._local_consts[key], units, dims)
        return out

    @reference_state.setter
    def reference_state(self, ref_state) -> None:
        raise RuntimeError(
            "DistributedBoundary reference state is set host-side via "
            "set_reference_state(global_ref_state)"
        )

    def _ref_field(self, field_name: str, field_units: Optional[str]):
        ref = self.reference_state[field_name]
        return ref.to_units(field_units).data if field_units else ref.data

    def _pin_target(self, field_name: str, field_units: Optional[str]):
        """The array boundary bands are pinned to: the windowed Dirichlet-core
        values when present, else the reference field (relaxed)."""
        key = f"pin:{field_name}"
        if key in self._local_consts:
            units, dims = self._ref_meta[field_name]
            fa = FieldArray(self._local_consts[key], units, dims)
            return fa.to_units(field_units).data if field_units else fa.data
        return self._ref_field(field_name, field_units)

    # -- masks (iota + axis_index; no constants needed) -------------------------- #
    def _global_coords(self, length: int, axis: int, staggered: bool):
        import jax.numpy as jnp
        from jax import lax

        block = self._decomp.bx if axis == 0 else self._decomp.by
        pad = self._decomp.pad_x if axis == 0 else self._decomp.pad_y
        idx = lax.axis_index(self._axis_names[axis])
        return idx * block + jnp.arange(length) - pad

    def _interior_mask2d(self, mi: int, mj: int, nb: int):
        """(mi, mj) bool: True where the cell lies >= nb from every global
        domain edge (the region the single-device stencil writes)."""
        import jax.numpy as jnp

        gx = self._global_coords(mi, 0, False)
        gy = self._global_coords(mj, 1, False)
        mx = (gx >= nb) & (gx < self._gnx - nb)
        my = (gy >= nb) & (gy < self._gny - nb)
        return mx[:, None] & my[None, :]

    # -- distribution hooks (the actual communication layer) -------------------- #
    def refresh_halos(self, field, field_name: Optional[str] = None):
        sx, sy, _ = field_stagger_axes(field_name or "")
        if sx or sy:
            # staggered fields travel cell-anchored: exchange the first-n
            # face entries; the trailing face is never read beyond the
            # consumed window (see module docstring)
            f = field
            core = f[: f.shape[0] - int(sx), : f.shape[1] - int(sy)]
            core = halo_exchange(
                core, self.pads, self._axis_names, (self._periodic, self._periodic)
            )
            import jax.numpy as jnp

            if sx:
                core = jnp.concatenate([core, f[-1:, : f.shape[1] - int(sy)]], axis=0)
            if sy:
                pad_col = f[: core.shape[0], -1:]
                core = jnp.concatenate([core, pad_col], axis=1)
            return core
        return halo_exchange(
            field, self.pads, self._axis_names, (self._periodic, self._periodic)
        )

    def refresh_halos_many(self, fields, field_names=None):
        from tasmania_jax.parallel.halo import halo_exchange_multi

        fields = list(fields)
        names = list(field_names) if field_names is not None else [""] * len(fields)
        assert not any(
            any(field_stagger_axes(n or "")[:2]) for n in names
        ), "bulk refresh is for cell fields; staggered go through refresh_halos"
        return halo_exchange_multi(
            fields, self.pads, self._axis_names, (self._periodic, self._periodic)
        )

    def restrict_stencil_output(self, out, base=None, nb=None, field_name=None):
        import jax.numpy as jnp

        nb = self.nb if nb is None else nb
        mask = self._interior_mask2d(out.shape[0], out.shape[1], nb)
        while mask.ndim < out.ndim:
            mask = mask[..., None]
        keep = jnp.zeros_like(out) if base is None else base
        return jnp.where(mask, out, keep)

    def zero_physical_frame(self, full, nb: int, field_name=None):
        return self.restrict_stencil_output(full, base=None, nb=nb)

    # -- enforcement -------------------------------------------------------------- #
    def _apply_physical_bc(self, field, field_name=None, field_units=None):
        """The BC algebra alone (no exchange)."""
        import jax.numpy as jnp

        sx, sy, _ = field_stagger_axes(field_name or "")
        assert not (sx or sy), (
            "distributed enforce_field on staggered fields is not implemented "
            "(the flagship algorithms only enforce cell fields; staggered "
            "outermost layers go through set_outermost_layers_*)"
        )
        if self._inner_type not in ("relaxed", "dirichlet"):
            return field
        g = self._local_consts["gamma"].astype(field.dtype)
        while g.ndim < field.ndim:
            g = g[..., None]
        ref = self._pin_target(field_name, field_units)
        ref = ref[tuple(slice(0, m) for m in field.shape)]
        # exact three-way select of boundaries/relaxed.py:133
        return jnp.where(
            g == 0.0,
            field,
            jnp.where(g == 1.0, ref, field - g * (field - ref)),
        )

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        out = self._apply_physical_bc(field, field_name, field_units)
        return halo_exchange(
            out, self.pads, self._axis_names, (self._periodic, self._periodic)
        )

    def enforce_raw(self, state, field_properties=None):
        """Bulk enforcement with a FUSED halo exchange: BC algebra per field,
        then ONE packed ppermute pair per axis for all enforced fields (N
        fields cost 2 collectives per axis instead of 2N; bitwise identical
        to the per-field base path — packing is copy-only)."""
        from tasmania_jax.parallel.halo import halo_exchange_multi

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
        out = dict(state)
        names = [n for n in state if n != "time" and n in fps]
        bced = [
            self._apply_physical_bc(
                state[n], n, fps[n].get("units", rfps[n]["units"])
            )
            for n in names
        ]
        exchanged = halo_exchange_multi(
            bced, self.pads, self._axis_names, (self._periodic, self._periodic)
        )
        out.update(dict(zip(names, exchanged)))
        return out

    def _pin_outermost(self, field, field_name, field_units, axis: int):
        import jax.numpy as jnp

        sx, sy, _ = field_stagger_axes(field_name or "")
        staggered = sx if axis == 0 else sy
        length = field.shape[axis]
        gcoord = self._global_coords(length, axis, staggered)
        gmax = (self._gnx if axis == 0 else self._gny) - 1 + int(staggered)
        mask1d = (gcoord == 0) | (gcoord == gmax)
        mask = mask1d[:, None] if axis == 0 else mask1d[None, :]
        while mask.ndim < field.ndim:
            mask = mask[..., None]
        if self._inner_type == "identity":
            # the single-device composition is concat-zero-fill (dwarfs/
            # diagnostics.py::get_velocity_components) + identity no-op: the
            # global outermost faces end up zero
            pinned = jnp.zeros_like(field)
        else:
            ref = self._pin_target(field_name, field_units)
            pinned = ref[tuple(slice(0, m) for m in field.shape)]
        return jnp.where(mask, pinned, field)

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        if self._inner_type == "periodic":
            # period-nx ring: every face is interior, the diagnosed value
            # (from wrap-filled halos) is already correct
            return field
        return self._pin_outermost(field, field_name, field_units, 0)

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        if self._inner_type == "periodic":
            return field
        return self._pin_outermost(field, field_name, field_units, 1)
