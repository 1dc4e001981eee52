"""The ``Domain``: physical grid + lateral boundary (+ numerical grid).

JAX re-design of reference ``src/tasmania/domain/domain.py:41``: builds a
``PhysicalGrid`` and a ``HorizontalBoundary`` (which owns the ``NumericalGrid``);
``update_topography`` fans out to both grids.  The distributed build attaches a
``CartesianDecomposition`` here (see ``tasmania_jax.parallel``) describing how
the numerical grid is block-sharded over a device mesh.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional

from tasmania_jax.domain.grid import PhysicalGrid
from tasmania_jax.domain.horizontal_boundary import HorizontalBoundary
from tasmania_jax.framework.options import BackendOptions, StorageOptions


class Domain:
    def __init__(
        self,
        domain_x,
        nx: int,
        domain_y,
        ny: int,
        domain_z,
        nz: int,
        z_interface=None,
        horizontal_boundary_type: str = "periodic",
        nb: int = 3,
        horizontal_boundary_kwargs: Optional[Dict[str, Any]] = None,
        topography_type: str = "flat",
        topography_kwargs: Optional[Dict[str, Any]] = None,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        self._pgrid = PhysicalGrid(
            domain_x,
            nx,
            domain_y,
            ny,
            domain_z,
            nz,
            z_interface=z_interface,
            topography_type=topography_type,
            topography_kwargs=topography_kwargs,
            storage_options=storage_options,
        )
        hb_kwargs = horizontal_boundary_kwargs or {}
        self._hb = HorizontalBoundary.factory(
            horizontal_boundary_type,
            self._pgrid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
            **hb_kwargs,
        )

    @property
    def physical_grid(self) -> PhysicalGrid:
        return self._pgrid

    @property
    def numerical_grid(self):
        return self._hb.numerical_grid

    @property
    def horizontal_boundary(self) -> HorizontalBoundary:
        return self._hb

    def update_topography(self, time: timedelta) -> None:
        """Fan the topography update out to both grids (reference ``domain.py:181``)."""
        self._pgrid.update_topography(time)
        self._hb.numerical_grid.update_topography(time)
