"""Two-dimensional horizontal grids with staggered axes.

JAX re-design of reference ``src/tasmania/domain/horizontal_grid.py:38,202,282``.
Coordinates are host-side numpy wrapped in ``FieldArray`` (units + dims); device
fields never carry coordinates — only shapes and the staggering naming convention.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import StorageOptions

Interval = Union[FieldArray, Tuple[float, float]]


def make_interval(
    interval: Interval, default_units: str = "m", default_dims: str = "x"
) -> FieldArray:
    """Normalise an axis interval spec to a 2-item ``FieldArray``."""
    if isinstance(interval, FieldArray):
        return interval
    lo, hi = interval
    return FieldArray(np.array([lo, hi], dtype=float), default_units, (default_dims,))


def _axis(values: np.ndarray, units: str, dims: str) -> FieldArray:
    return FieldArray(values, units, (dims,))


class HorizontalGrid:
    """Rectilinear 2-D grid: mass axes + u/v staggered axes + spacings."""

    def __init__(
        self,
        x: FieldArray,
        y: FieldArray,
        x_at_u_locations: Optional[FieldArray] = None,
        y_at_v_locations: Optional[FieldArray] = None,
    ) -> None:
        self._x = x
        self._y = y

        xv, yv = np.asarray(x.data), np.asarray(y.data)
        self._nx, self._ny = xv.shape[0], yv.shape[0]

        dx_v = (xv[-1] - xv[0]) / (self._nx - 1) if self._nx > 1 else 1.0
        dx_v = 1.0 if dx_v == 0.0 else dx_v
        dy_v = (yv[-1] - yv[0]) / (self._ny - 1) if self._ny > 1 else 1.0
        dy_v = 1.0 if dy_v == 0.0 else dy_v
        self._dx = FieldArray(np.asarray(dx_v), x.units, ())
        self._dy = FieldArray(np.asarray(dy_v), y.units, ())

        if x_at_u_locations is not None:
            self._xu = x_at_u_locations
        else:
            xu = np.linspace(xv[0] - 0.5 * dx_v, xv[-1] + 0.5 * dx_v, self._nx + 1)
            self._xu = _axis(xu.astype(xv.dtype), x.units, x.dims[0] + "_at_u_locations")
        if y_at_v_locations is not None:
            self._yv = y_at_v_locations
        else:
            yv_s = np.linspace(yv[0] - 0.5 * dy_v, yv[-1] + 0.5 * dy_v, self._ny + 1)
            self._yv = _axis(yv_s.astype(yv.dtype), y.units, y.dims[0] + "_at_v_locations")

    # -- properties --------------------------------------------------------- #
    @property
    def x(self) -> FieldArray:
        return self._x

    @property
    def y(self) -> FieldArray:
        return self._y

    @property
    def x_at_u_locations(self) -> FieldArray:
        return self._xu

    @property
    def y_at_v_locations(self) -> FieldArray:
        return self._yv

    @property
    def nx(self) -> int:
        return self._nx

    @property
    def ny(self) -> int:
        return self._ny

    @property
    def dx(self) -> FieldArray:
        return self._dx

    @property
    def dy(self) -> FieldArray:
        return self._dy


class PhysicalHorizontalGrid(HorizontalGrid):
    """Horizontal grid built from axis intervals (reference ``horizontal_grid.py:202``)."""

    def __init__(
        self,
        domain_x: Interval,
        nx: int,
        domain_y: Interval,
        ny: int,
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        so = storage_options or StorageOptions()
        dom_x = make_interval(domain_x, "m", "x")
        dom_y = make_interval(domain_y, "m", "y")
        xv = np.asarray(dom_x.data, dtype=so.dtype)
        yv = np.asarray(dom_y.data, dtype=so.dtype)

        x_vals = (
            np.linspace(xv[0], xv[1], nx, dtype=so.dtype)
            if nx > 1
            else np.array([0.5 * (xv[0] + xv[1])], dtype=so.dtype)
        )
        y_vals = (
            np.linspace(yv[0], yv[1], ny, dtype=so.dtype)
            if ny > 1
            else np.array([0.5 * (yv[0] + yv[1])], dtype=so.dtype)
        )
        super().__init__(
            _axis(x_vals, dom_x.units, dom_x.dims[0]),
            _axis(y_vals, dom_y.units, dom_y.dims[0]),
        )


class NumericalHorizontalGrid(HorizontalGrid):
    """Horizontal grid spanned by a boundary's numerical axes
    (reference ``horizontal_grid.py:282``)."""

    def __init__(self, boundary) -> None:
        super().__init__(
            boundary.get_numerical_xaxis(),
            boundary.get_numerical_yaxis(),
            boundary.get_numerical_xaxis_staggered(),
            boundary.get_numerical_yaxis_staggered(),
        )
