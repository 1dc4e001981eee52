"""Device mesh + 2-D horizontal domain decomposition.

The reference has no distributed layer (SURVEY.md §2.8); this module is the
replacement mandated by BASELINE.json: a ``jax.sharding.Mesh`` over the
devices with axes ``('x', 'y')``, prognostic fields block-sharded
``P('x','y',None)``, and the vertical axis kept local so column scans and
tridiagonal solves never communicate (SURVEY.md §5.7).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def _factor_2d(n: int) -> Tuple[int, int]:
    """Most-square (px, py) factorisation of ``n`` (px·py == n, px ≥ py)."""
    best = (n, 1)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (n // py, py)
    return best


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("x", "y"),
) -> Mesh:
    """2-D mesh over ``devices`` (default: all), in jax's device order.  The
    cards of one GPU host are joined all to all (NVLink), so the mesh shape
    follows the decomposition alone."""
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    px, py = shape if shape is not None else _factor_2d(n)
    assert px * py == n, f"mesh shape {px}x{py} != {n} devices"
    dev_array = np.asarray(devices).reshape(px, py)
    return Mesh(dev_array, axis_names)


class CartesianDecomposition:
    """Block decomposition of an (nx, ny) horizontal grid over a 2-D mesh.

    Owns the shard-local extents and which shards touch true domain edges —
    the information the halo-aware boundary layer needs to decide
    ppermute-fill vs physical-BC-fill (SURVEY.md §5.8).
    """

    def __init__(
        self,
        nx: int,
        ny: int,
        mesh: Mesh,
        nb: int,
        pad_x: Optional[int] = None,
        pad_y: Optional[int] = None,
    ) -> None:
        """``pad_x``/``pad_y`` are the shard-local ghost-ring widths (default
        ``nb``).  Degenerate axes (mesh extent 1, non-periodic) may carry pad
        0 — local coordinates then equal global ones and the shard runs the
        exact single-device program."""
        self.mesh = mesh
        self.nb = nb
        self.px, self.py = mesh.devices.shape
        assert nx % self.px == 0, f"nx={nx} not divisible by mesh x-extent {self.px}"
        assert ny % self.py == 0, f"ny={ny} not divisible by mesh y-extent {self.py}"
        self.nx, self.ny = nx, ny
        self.bx, self.by = nx // self.px, ny // self.py
        self.pad_x = nb if pad_x is None else pad_x
        self.pad_y = nb if pad_y is None else pad_y
        assert self.bx >= max(nb, self.pad_x) and self.by >= max(nb, self.pad_y), (
            f"shard block ({self.bx}, {self.by}) smaller than halo width "
            f"({max(nb, self.pad_x)}, {max(nb, self.pad_y)})"
        )

    @property
    def local_shape_with_halo(self) -> Tuple[int, int]:
        return (self.bx + 2 * self.pad_x, self.by + 2 * self.pad_y)
