"""Time-dependent topography + registered profile shapes.

JAX re-design of reference ``src/tasmania/domain/topography.py:46,119,202,246``
and ``domain/subclasses/topographies/{flat,gaussian,schaer}.py``.  The profile is a
host-side numpy array (it feeds metric-term precomputation); the linear growth
factor over ``time`` is a plain float so a jitted step can take the *current*
profile as an input array without retracing (SURVEY.md §7 "time-dependent
topography" hard part).
"""

from __future__ import annotations

import abc
from datetime import timedelta
from typing import Any, Dict, Optional

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.utils.units import conversion_factor


def _scalar(value, units: str, default, target_units: str) -> float:
    """Extract a float in ``target_units`` from value-or-FieldArray-or-None."""
    if value is None:
        return float(default)
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units(target_units).data))
    return float(value) * conversion_factor(units, target_units)


class Topography:
    """Steady profile + optional linear growth over ``time``
    (reference ``topography.py:46,106-117``)."""

    def __init__(
        self,
        steady_profile: FieldArray,
        profile: Optional[FieldArray] = None,
        time: Optional[timedelta] = None,
    ) -> None:
        self._steady_profile = steady_profile.to_units("m")
        self._time = time or timedelta(seconds=0)
        self._fact = float(self._time.total_seconds() == 0.0)
        sp = np.asarray(self._steady_profile.data)
        self._profile = FieldArray(
            self._fact * sp if profile is None else np.asarray(profile.to_units("m").data),
            "m",
            steady_profile.dims,
        )

    @property
    def profile(self) -> FieldArray:
        return self._profile

    @property
    def steady_profile(self) -> FieldArray:
        return self._steady_profile

    @property
    def time(self) -> timedelta:
        return self._time

    def update(self, time: timedelta) -> None:
        """Grow the profile linearly until ``time >= self.time``."""
        if self._fact < 1.0:
            self._fact = min(
                time.total_seconds() / self._time.total_seconds(), 1.0
            )
            self._profile = FieldArray(
                self._fact * np.asarray(self._steady_profile.data),
                "m",
                self._steady_profile.dims,
            )


class PhysicalTopography(Topography, abc.ABC):
    """Topography over a physical grid; factory base (reference ``topography.py:119``)."""

    registry: Dict[str, type] = {}

    def __init__(self, grid, time, smooth: bool, **kwargs) -> None:
        self._type: Optional[str] = None
        topo_steady = np.asarray(
            self.compute_steady_profile(grid, **kwargs), dtype=np.asarray(grid.x.data).dtype
        )
        if smooth and topo_steady.shape[0] > 2 and topo_steady.shape[1] > 2:
            topo_steady = topo_steady.copy()
            topo_steady[1:-1, 1:-1] += 0.125 * (
                topo_steady[:-2, 1:-1]
                + topo_steady[2:, 1:-1]
                + topo_steady[1:-1, :-2]
                + topo_steady[1:-1, 2:]
                - 4.0 * topo_steady[1:-1, 1:-1]
            )
        self._kwargs = {"smooth": smooth, **kwargs}
        super().__init__(
            FieldArray(topo_steady, "m", (grid.x.dims[0], grid.y.dims[0])), time=time
        )

    @property
    def kwargs(self) -> Dict[str, Any]:
        return self._kwargs

    @property
    def type(self) -> str:
        assert self._type is not None
        return self._type

    @type.setter
    def type(self, topography_type: str) -> None:
        self._type = topography_type

    @abc.abstractmethod
    def compute_steady_profile(self, grid, **kwargs) -> np.ndarray:
        """Steady topography profile in [m] over ``grid`` mass points."""

    @staticmethod
    def factory(
        topography_type: str,
        grid,
        time: Optional[timedelta] = None,
        smooth: bool = False,
        **kwargs,
    ) -> "PhysicalTopography":
        obj = factorize(topography_type, PhysicalTopography, (grid, time, smooth), kwargs)
        obj.type = topography_type
        return obj


class NumericalTopography(Topography):
    """Physical topography transferred to the numerical grid
    (reference ``topography.py:246``)."""

    def __init__(self, boundary) -> None:
        ptopo = boundary.physical_grid.topography if hasattr(boundary, "physical_grid") else None
        # boundary may hand us either a 3-D grid or itself owning a physical grid
        phys_topo = ptopo
        self._kwargs = getattr(phys_topo, "kwargs", {})
        self._type = getattr(phys_topo, "_type", None)
        steady = boundary.get_numerical_field(
            np.asarray(phys_topo.steady_profile.data), "topography"
        )
        profile = boundary.get_numerical_field(
            np.asarray(phys_topo.profile.data), "topography"
        )
        dims = phys_topo.steady_profile.dims
        super().__init__(
            FieldArray(np.asarray(steady), "m", dims),
            FieldArray(np.asarray(profile), "m", dims),
            phys_topo.time,
        )
        self._boundary = boundary
        self._phys_topo = phys_topo

    @property
    def kwargs(self) -> Dict[str, Any]:
        return self._kwargs

    @property
    def type(self):
        return self._type

    def update(self, time: timedelta) -> None:
        if self._fact < 1.0 and self._time.total_seconds() > 0.0:
            self._fact = min(time.total_seconds() / self._time.total_seconds(), 1.0)
            self._profile = FieldArray(
                self._fact * np.asarray(self._steady_profile.data),
                "m",
                self._steady_profile.dims,
            )


# --------------------------------------------------------------------------- #
# registered profiles                                                          #
# --------------------------------------------------------------------------- #


@factor_register("flat")
class Flat(PhysicalTopography):
    """Flat terrain (reference ``subclasses/topographies/flat.py:31``)."""

    def __init__(self, grid, time, smooth, **kwargs):
        super().__init__(grid, time, smooth)

    def compute_steady_profile(self, grid, **kwargs):
        return np.zeros((grid.nx, grid.ny))


@factor_register("gaussian")
class Gaussian(PhysicalTopography):
    """Isolated Gaussian mountain h = hmax·exp(-((x-cx)/sx)² - ((y-cy)/sy)²)
    (reference ``subclasses/topographies/gaussian.py:33``)."""

    def __init__(
        self, grid, time, smooth, *,
        max_height=None, center_x=None, center_y=None, width_x=None, width_y=None,
        **kwargs,
    ):
        super().__init__(
            grid, time, smooth,
            max_height=max_height, center_x=center_x, center_y=center_y,
            width_x=width_x, width_y=width_y,
        )

    def compute_steady_profile(self, grid, **kwargs):
        xv, yv = np.asarray(grid.x.data), np.asarray(grid.y.data)
        xu, yu = grid.x.units, grid.y.units
        hmax = _scalar(kwargs.get("max_height"), "m", 500.0, "m")
        wx = _scalar(kwargs.get("width_x"), xu, 1.0, xu)
        wy = _scalar(kwargs.get("width_y"), yu, 1.0, yu)
        cx = _scalar(kwargs.get("center_x"), xu, 0.5 * (xv[0] + xv[-1]), xu)
        cy = _scalar(kwargs.get("center_y"), yu, 0.5 * (yv[0] + yv[-1]), yu)
        xx, yy = np.meshgrid(xv, yv, indexing="ij")
        return hmax * np.exp(-(((xx - cx) / wx) ** 2) - ((yy - cy) / wy) ** 2)


@factor_register("schaer")
class Schaer(PhysicalTopography):
    """Schaer & Durran (1997) mountain h = hmax / [1 + ((x-cx)/sx)² + ((y-cy)/sy)²]^1.5
    (reference ``subclasses/topographies/schaer.py:33``)."""

    def __init__(
        self, grid, time, smooth, *,
        max_height=None, center_x=None, center_y=None, width_x=None, width_y=None,
        **kwargs,
    ):
        super().__init__(
            grid, time, smooth,
            max_height=max_height, center_x=center_x, center_y=center_y,
            width_x=width_x, width_y=width_y,
        )

    def compute_steady_profile(self, grid, **kwargs):
        xv, yv = np.asarray(grid.x.data), np.asarray(grid.y.data)
        xu, yu = grid.x.units, grid.y.units
        hmax = _scalar(kwargs.get("max_height"), "m", 500.0, "m")
        wx = _scalar(kwargs.get("width_x"), xu, 1.0, xu)
        wy = _scalar(kwargs.get("width_y"), yu, 1.0, yu)
        cx = _scalar(kwargs.get("center_x"), xu, 0.5 * (xv[0] + xv[-1]), xu)
        cy = _scalar(kwargs.get("center_y"), yu, 0.5 * (yv[0] + yv[-1]), yu)
        xx, yy = np.meshgrid(xv, yv, indexing="ij")
        return hmax / (1.0 + ((xx - cx) / wx) ** 2 + ((yy - cy) / wy) ** 2) ** 1.5


@factor_register("user_defined")
class UserDefined(PhysicalTopography):
    """Profile given directly as an array or callable ``f(x2d, y2d)``."""

    def __init__(self, grid, time, smooth, *, profile=None, **kwargs):
        super().__init__(grid, time, smooth, profile=profile)

    def compute_steady_profile(self, grid, **kwargs):
        profile = kwargs.get("profile")
        if profile is None:
            return np.zeros((grid.nx, grid.ny))
        if callable(profile):
            xx, yy = np.meshgrid(
                np.asarray(grid.x.data), np.asarray(grid.y.data), indexing="ij"
            )
            return np.asarray(profile(xx, yy))
        if isinstance(profile, FieldArray):
            return np.asarray(profile.to_units("m").data)
        return np.asarray(profile)
