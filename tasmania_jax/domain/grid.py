"""Three-dimensional rectilinear grids (physical + numerical).

JAX re-design of reference ``src/tasmania/domain/grid.py:44,234,351``.
Vertical levels follow COSMO ordering top→surface; the vertical coordinate is
abstract (height- or pressure-based).  Coordinates are host numpy; only field
*shapes* matter on device.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional

import numpy as np

from tasmania_jax.domain.horizontal_grid import (
    HorizontalGrid,
    Interval,
    NumericalHorizontalGrid,
    PhysicalHorizontalGrid,
    make_interval,
)
from tasmania_jax.domain.topography import NumericalTopography, PhysicalTopography, Topography
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import StorageOptions


class Grid:
    """3-D grid = horizontal grid + vertical levels + topography
    (reference ``grid.py:44``)."""

    def __init__(
        self,
        grid_xy: HorizontalGrid,
        z: FieldArray,
        z_on_interface_levels: FieldArray,
        z_interface: FieldArray,
        topography: Topography,
    ) -> None:
        self._grid_xy = grid_xy
        self._z = z
        self._zhl = z_on_interface_levels
        self._zi = z_interface
        self._topo = topography

        self._nz = int(np.asarray(z.data).shape[0])
        zhl_v = np.asarray(z_on_interface_levels.data)
        dz_v = abs(float(zhl_v[0]) - float(zhl_v[-1])) / self._nz
        dz_v = 1.0 if dz_v == 0.0 else dz_v
        self._dz = FieldArray(np.asarray(dz_v), z.units, ())

    # -- geometry ----------------------------------------------------------- #
    @property
    def grid_xy(self) -> HorizontalGrid:
        return self._grid_xy

    @property
    def nx(self) -> int:
        return self._grid_xy.nx

    @property
    def ny(self) -> int:
        return self._grid_xy.ny

    @property
    def nz(self) -> int:
        return self._nz

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def dx(self) -> FieldArray:
        return self._grid_xy.dx

    @property
    def dy(self) -> FieldArray:
        return self._grid_xy.dy

    @property
    def dz(self) -> FieldArray:
        return self._dz

    @property
    def x(self) -> FieldArray:
        return self._grid_xy.x

    @property
    def x_at_u_locations(self) -> FieldArray:
        return self._grid_xy.x_at_u_locations

    @property
    def y(self) -> FieldArray:
        return self._grid_xy.y

    @property
    def y_at_v_locations(self) -> FieldArray:
        return self._grid_xy.y_at_v_locations

    @property
    def z(self) -> FieldArray:
        return self._z

    @property
    def z_on_interface_levels(self) -> FieldArray:
        return self._zhl

    @property
    def z_interface(self) -> FieldArray:
        return self._zi

    @property
    def topography(self) -> Topography:
        return self._topo

    def update_topography(self, time: timedelta) -> None:
        self._topo.update(time)


class PhysicalGrid(Grid):
    """Grid over the physical domain, built from axis intervals
    (reference ``grid.py:234``)."""

    def __init__(
        self,
        domain_x: Interval,
        nx: int,
        domain_y: Interval,
        ny: int,
        domain_z: Interval,
        nz: int,
        z_interface: Optional[FieldArray] = None,
        topography_type: str = "flat",
        topography_kwargs: Optional[Dict[str, Any]] = None,
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        so = storage_options or StorageOptions()
        grid_xy = PhysicalHorizontalGrid(domain_x, nx, domain_y, ny, storage_options=so)

        dom_z = make_interval(domain_z, "K", "z")
        values_z = np.asarray(dom_z.data, dtype=so.dtype)
        units_z = dom_z.units
        dim_z = dom_z.dims[0]

        zhl_v = np.linspace(values_z[0], values_z[1], nz + 1, dtype=so.dtype)
        zhl = FieldArray(zhl_v, units_z, (dim_z + "_on_interface_levels",))
        z_v = 0.5 * (zhl_v[:-1] + zhl_v[1:])
        z = FieldArray(z_v, units_z, (dim_z,))

        if z_interface is None:
            zi = FieldArray(np.asarray(values_z[0]), units_z, ())
        else:
            zi = z_interface.to_units(units_z)
        zi_v = float(np.asarray(zi.data))
        lo, hi = sorted((float(values_z[0]), float(values_z[1])))
        if not (lo <= zi_v <= hi):
            raise ValueError(f"z_interface should be in the range ({lo}, {hi}).")

        kwargs = topography_kwargs if isinstance(topography_kwargs, dict) else {}
        topo = PhysicalTopography.factory(topography_type, grid_xy, **kwargs)

        super().__init__(grid_xy, z, zhl, zi, topo)


class NumericalGrid(Grid):
    """Grid over the numerical domain spanned by a boundary
    (reference ``grid.py:351``)."""

    def __init__(self, boundary) -> None:
        phys_grid = boundary.physical_grid
        grid_xy = NumericalHorizontalGrid(boundary)
        topo = NumericalTopography(boundary)
        super().__init__(
            grid_xy,
            phys_grid.z,
            phys_grid.z_on_interface_levels,
            phys_grid.z_interface,
            topo,
        )
