"""Dynamical core for the 2-D inviscid Burgers equations.

JAX re-design of reference ``src/tasmania/burgers/dynamics/dycore.py:38``:
requires ``nz == 1``; prognostic variables are the two velocity components;
each stage applies the Burgers stepper then enforces lateral BCs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from tasmania_jax.burgers.dynamics.stepper import BurgersStepper
from tasmania_jax.framework.dycore import DynamicalCore
from tasmania_jax.framework.options import BackendOptions, StorageOptions

DIMS = ("x", "y", "z")


class BurgersDynamicalCore(DynamicalCore):
    def __init__(
        self,
        domain,
        fast_tendency_component=None,
        time_integration_scheme: str = "forward_euler",
        flux_scheme: str = "upwind",
        *,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(
            domain,
            fast_tendency_component=fast_tendency_component,
            fast_diagnostic_component=None,
            substeps=0,
            enable_checks=enable_checks,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        assert self.grid.nz == 1, "Burgers model requires nz == 1 (reference dycore.py:102)"
        # map the reference's flux naming to the advection registry
        scheme = {"upwind": "first_order", "centered": "second_order"}.get(
            flux_scheme, flux_scheme
        )
        self._stepper = BurgersStepper.factory(
            time_integration_scheme,
            self.grid.grid_xy,
            self.horizontal_boundary.nb,
            scheme,
            backend=self.backend,
            backend_options=self.backend_options,
            storage_options=self.storage_options,
        )

    @property
    def stage_input_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-1"},
            "y_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def stage_tendency_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-2"},
            "y_velocity": {"dims": DIMS, "units": "m s^-2"},
        }

    @property
    def stage_output_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-1"},
            "y_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def stages(self) -> int:
        return self._stepper.stages

    def stage_array_call(
        self,
        stage: int,
        raw_state: Mapping[str, Any],
        raw_tendencies: Mapping[str, Any],
        timestep: float,
    ) -> Dict[str, Any]:
        out = self._stepper(stage, raw_state, raw_tendencies, timestep)
        return self.horizontal_boundary.enforce_raw(
            out,
            field_properties={
                "x_velocity": {"units": "m s^-1"},
                "y_velocity": {"units": "m s^-1"},
            },
        )
