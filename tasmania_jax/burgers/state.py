"""Analytic Zhao solution + state factory for Burgers validation.

JAX re-design of reference ``src/tasmania/burgers/state.py`` (used
heavily by the reference tests as the correctness oracle): the Zhao test case
is an exact solution of the 2-D *viscous* Burgers equations with diffusivity
``eps``; the inviscid core + diffusion physics should track it.
"""

from __future__ import annotations

from datetime import datetime
from typing import Optional

import numpy as np

from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import StorageOptions
from tasmania_jax.utils.units import conversion_factor

DIMS = ("x", "y", "z")


class ZhaoSolutionFactory:
    """Exact velocity fields of the Zhao test case
    (reference ``burgers/state.py`` ``ZhaoSolutionFactory``)."""

    def __init__(self, initial_time: datetime, eps) -> None:
        self._itime = initial_time
        if isinstance(eps, FieldArray):
            self._eps = float(np.asarray(eps.to_units("m^2 s^-1").data))
        else:
            self._eps = float(eps)

    def __call__(
        self,
        time: datetime,
        grid,
        slice_x: Optional[slice] = None,
        slice_y: Optional[slice] = None,
        field_name: str = "x_velocity",
        field_units: Optional[str] = None,
    ) -> np.ndarray:
        eps = self._eps
        slice_x = slice(0, grid.nx) if slice_x is None else slice_x
        slice_y = slice(0, grid.ny) if slice_y is None else slice_y

        x1 = np.asarray(grid.x.to_units("m").data)[slice_x]
        y1 = np.asarray(grid.y.to_units("m").data)[slice_y]
        x = x1[:, None, None]
        y = y1[None, :, None]

        t = (time - self._itime).total_seconds()
        decay = np.exp(-5.0 * np.pi**2 * eps * t)
        denom = 2.0 + decay * np.sin(2.0 * np.pi * x) * np.sin(np.pi * y)

        if field_name == "x_velocity":
            tmp = (
                -4.0 * eps * np.pi * decay * np.cos(2.0 * np.pi * x) * np.sin(np.pi * y)
            ) / denom
        elif field_name == "y_velocity":
            tmp = (
                -2.0 * eps * np.pi * decay * np.sin(2.0 * np.pi * x) * np.cos(np.pi * y)
            ) / denom
        else:
            raise ValueError(f"unknown field {field_name!r}")

        factor = (
            1.0
            if field_units in (None, "m s^-1")
            else conversion_factor("m s^-1", field_units)
        )
        out = factor * tmp
        return np.broadcast_to(out, (len(x1), len(y1), grid.nz)).copy()


class ZhaoStateFactory:
    """Initial/exact states for the Zhao test case
    (reference ``burgers/state.py`` ``ZhaoStateFactory``)."""

    def __init__(
        self,
        initial_time: datetime,
        eps,
        *,
        backend: str = "jax",
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        self._solution = ZhaoSolutionFactory(initial_time, eps)
        self._backend = backend
        self._so = storage_options or StorageOptions()

    def __call__(self, time: datetime, grid):
        u = self._solution(time, grid, field_name="x_velocity")
        v = self._solution(time, grid, field_name="y_velocity")
        if not self._backend.startswith("numpy"):
            import jax.numpy as jnp

            u = jnp.asarray(u, dtype=self._so.dtype)
            v = jnp.asarray(v, dtype=self._so.dtype)
        return {
            "time": time,
            "x_velocity": FieldArray(u, "m s^-1", DIMS),
            "y_velocity": FieldArray(v, "m s^-1", DIMS),
        }
