"""Halo exchange over a 2-D device mesh via ``lax.ppermute``.

The distributed replacement for the reference's single-device ghost-layer
machinery (``domain/horizontal_boundary.py``; SURVEY.md §5.8): each shard holds
a ``(bx+2nb, by+2nb, nz)`` block; interior edges are filled from neighbours by
neighbour-exchange collectives that XLA hands to the device
interconnect (NCCL on GPUs), while true domain edges
are left for the physical boundary conditions.

These functions must be called *inside* ``shard_map`` with mesh axis names
bound.  The exchange is issued as two independent ppermute pairs per axis, so
XLA can overlap the transfers with unrelated compute between issue and use.

Exchanged blocks are assembled by CONCATENATION — ``concat(recv_lo, core,
recv_hi)`` — not by in-place slice updates.  This is the key to explicit
comm/compute overlap (SURVEY.md §2.8 "overlapped with interior compute"):
XLA's algebraic simplifier rewrites a slice that falls entirely inside the
``core`` operand to a slice of ``core`` itself, so any downstream computation
that only touches interior cells carries **no data dependency on the
ppermutes** and schedules concurrently with them.  The prognostic's
interior/edge band split (``isentropic/dynamics/prognostic.py``,
``overlap_bands``) exploits exactly this.  Concatenation is also the
SPMD-robust construction (TODO.md scatter-partitioner note).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _take(f, axis: int, sl: slice):
    idx = [slice(None)] * f.ndim
    idx[axis] = sl
    return f[tuple(idx)]


def _put(f, axis: int, sl: slice, value):
    idx = [slice(None)] * f.ndim
    idx[axis] = sl
    return f.at[tuple(idx)].set(value)


def _assemble(f, axis: int, nb: int, lo, hi):
    """``concat(lo, core, hi)`` along ``axis`` — the interior cells are a pure
    slice of the pre-exchange array, so interior-only consumers do not depend
    on the collectives that produced ``lo``/``hi``."""
    core = _take(f, axis, slice(nb, f.shape[axis] - nb))
    return jnp.concatenate([lo, core, hi], axis=axis)


def halo_exchange_axis(
    f,
    nb: int,
    axis: int,
    axis_name: str,
    periodic: bool = True,
):
    """Fill the ``nb``-wide halos of ``f`` along ``axis`` from the neighbouring
    shards on mesh axis ``axis_name``."""
    if nb == 0:
        return f
    n = lax.axis_size(axis_name)
    if n == 1:
        if periodic:
            # single shard owns the whole ring: wrap locally
            m = f.shape[axis]
            return _assemble(
                f,
                axis,
                nb,
                _take(f, axis, slice(m - 2 * nb, m - nb)),
                _take(f, axis, slice(nb, 2 * nb)),
            )
        return f

    send_hi = _take(f, axis, slice(f.shape[axis] - 2 * nb, f.shape[axis] - nb))
    send_lo = _take(f, axis, slice(nb, 2 * nb))

    if periodic:
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
    else:
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i, i - 1) for i in range(1, n)]

    from_left = lax.ppermute(send_hi, axis_name, fwd)  # fills my low halo
    from_right = lax.ppermute(send_lo, axis_name, bwd)  # fills my high halo

    idx = lax.axis_index(axis_name)
    has_left = periodic or (idx > 0)
    has_right = periodic or (idx < n - 1)

    lo_halo = _take(f, axis, slice(0, nb))
    hi_halo = _take(f, axis, slice(f.shape[axis] - nb, f.shape[axis]))
    return _assemble(
        f,
        axis,
        nb,
        jnp.where(has_left, from_left, lo_halo),
        jnp.where(has_right, from_right, hi_halo),
    )


def halo_exchange(
    f,
    nb: int,
    axis_names: Tuple[str, str] = ("x", "y"),
    periodic: Tuple[bool, bool] = (True, True),
):
    """Exchange halos along both horizontal axes (x first, then y including the
    just-filled x-halos, so corner ghosts are consistent).  ``nb`` may be an
    int (same width both axes) or an ``(nbx, nby)`` pair — degenerate mesh
    axes carry width 0 (a no-op)."""
    nbx, nby = (nb, nb) if isinstance(nb, int) else nb
    f = halo_exchange_axis(f, nbx, 0, axis_names[0], periodic[0])
    f = halo_exchange_axis(f, nby, 1, axis_names[1], periodic[1])
    return f


def _exchange_axis_multi(fs, nb: int, axis: int, axis_name: str, periodic: bool):
    """One ppermute pair for the ``axis``-halos of ALL fields in ``fs``:
    the per-field edge strips are flattened and packed into a single message
    per direction, so N fields cost 2 collectives instead of 2·N — fewer
    collective launches to hide behind compute.  Packing is copy-only:
    bitwise identical to per-field exchange."""
    if nb == 0:
        return list(fs)
    n = lax.axis_size(axis_name)
    if n == 1:
        return [halo_exchange_axis(f, nb, axis, axis_name, periodic) for f in fs]

    hi_parts, lo_parts, shapes = [], [], []
    for f in fs:
        hi = _take(f, axis, slice(f.shape[axis] - 2 * nb, f.shape[axis] - nb))
        lo = _take(f, axis, slice(nb, 2 * nb))
        shapes.append(hi.shape)
        hi_parts.append(hi.reshape(-1))
        lo_parts.append(lo.reshape(-1))
    send_hi = jnp.concatenate(hi_parts)
    send_lo = jnp.concatenate(lo_parts)

    if periodic:
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
    else:
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i, i - 1) for i in range(1, n)]

    from_left = lax.ppermute(send_hi, axis_name, fwd)
    from_right = lax.ppermute(send_lo, axis_name, bwd)

    idx = lax.axis_index(axis_name)
    has_left = periodic or (idx > 0)
    has_right = periodic or (idx < n - 1)

    out, off = [], 0
    for f, shape in zip(fs, shapes):
        size = int(np.prod(shape))
        fl = from_left[off : off + size].reshape(shape)
        fr = from_right[off : off + size].reshape(shape)
        off += size
        lo_halo = _take(f, axis, slice(0, nb))
        hi_halo = _take(f, axis, slice(f.shape[axis] - nb, f.shape[axis]))
        out.append(
            _assemble(
                f,
                axis,
                nb,
                jnp.where(has_left, fl, lo_halo),
                jnp.where(has_right, fr, hi_halo),
            )
        )
    return out


def halo_exchange_multi(
    fields,
    nb: int,
    axis_names: Tuple[str, str] = ("x", "y"),
    periodic: Tuple[bool, bool] = (True, True),
):
    """Fused halo exchange of a LIST of same-dtype fields (2 ppermutes per
    axis total).  Semantically identical to mapping :func:`halo_exchange`.
    ``nb`` may be an int or an ``(nbx, nby)`` pair."""
    fields = list(fields)
    if not fields:
        return fields
    assert all(f.dtype == fields[0].dtype for f in fields), (
        "halo_exchange_multi packs one message: fields must share a dtype"
    )
    nbx, nby = (nb, nb) if isinstance(nb, int) else nb
    fields = _exchange_axis_multi(fields, nbx, 0, axis_names[0], periodic[0])
    fields = _exchange_axis_multi(fields, nby, 1, axis_names[1], periodic[1])
    return fields
