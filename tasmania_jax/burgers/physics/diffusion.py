"""Diffusion tendencies for the 2-D Burgers equations.

JAX re-design of reference ``src/tasmania/burgers/physics/diffusion.py``:
a ``TendencyComponent`` wrapping the :class:`HorizontalDiffusion` dwarf on both
velocity components.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_jax.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_jax.framework.core_components import TendencyComponent
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import BackendOptions, StorageOptions

DIMS = ("x", "y", "z")


class BurgersHorizontalDiffusion(TendencyComponent):
    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        diffusion_type: str = "second_order",
        diffusion_coeff=None,
        *,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> None:
        super().__init__(
            domain,
            grid_type,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        nx, ny = self.grid.grid_xy.nx, self.grid.grid_xy.ny
        dx = float(np.asarray(self.grid.grid_xy.dx.to_units("m").data))
        dy = float(np.asarray(self.grid.grid_xy.dy.to_units("m").data))
        if isinstance(diffusion_coeff, FieldArray):
            coeff = float(np.asarray(diffusion_coeff.to_units("m^2 s^-1").data))
        else:
            coeff = float(diffusion_coeff if diffusion_coeff is not None else 0.0)
        self._diffuser = HorizontalDiffusion.factory(
            diffusion_type,
            (nx, ny, 1),
            dx,
            dy,
            diffusion_coeff=coeff,
            diffusion_coeff_max=coeff,
            diffusion_damp_depth=0,
            nb=self.horizontal_boundary.nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )

    @property
    def input_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-1"},
            "y_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-2"},
            "y_velocity": {"dims": DIMS, "units": "m s^-2"},
        }

    def array_call(self, state):
        return (
            {
                "x_velocity": self._diffuser(state["x_velocity"]),
                "y_velocity": self._diffuser(state["y_velocity"]),
            },
            {},
        )
