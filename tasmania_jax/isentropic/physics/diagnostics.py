"""Diagnostic components exposing the isentropic-core diagnostics to the
physics chain (reference ``src/tasmania/isentropic/physics/diagnostics.py:44,199``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_jax.dwarfs.diagnostics import HorizontalVelocity
from tasmania_jax.framework.core_components import DiagnosticComponent
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic.dynamics.diagnostics import (
    IsentropicDiagnostics as DynamicsDiagnostics,
)

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")
DIMS_U = ("x_at_u_locations", "y", "z")
DIMS_V = ("x", "y_at_v_locations", "z")


class IsentropicDiagnostics(DiagnosticComponent):
    """p / exn / mtg / h (+ rho, T when moist) from the isentropic density
    (reference ``physics/diagnostics.py:44``)."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        moist: bool = False,
        pt=None,
        physical_constants=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, physical_constants=physical_constants, **kwargs)
        self._moist = moist
        if isinstance(pt, FieldArray):
            self._pt = float(np.asarray(pt.to_units("Pa").data))
        else:
            self._pt = float(pt if pt is not None else 0.0)
        self._core = DynamicsDiagnostics(
            self.grid,
            physical_constants=physical_constants,
            backend=self.backend,
            backend_options=self.backend_options,
            storage_options=self.storage_options,
        )

    @property
    def input_properties(self):
        props = {"air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"}}
        # time-dependent topography enters through the state (like the dycore,
        # ``framework/dycore.py``) so mtg/h track the growing mountain under
        # jit — the reference reads the live grid topography each step
        # (reference ``drivers/.../driver_namelist_sus.py`` update_topography)
        if self.grid.topography.time.total_seconds() > 0.0:
            props["topography_height"] = {"dims": ("x", "y"), "units": "m"}
        return props

    @property
    def diagnostic_properties(self):
        props = {
            "air_pressure_on_interface_levels": {"dims": DIMS_Z, "units": "Pa"},
            "exner_function_on_interface_levels": {
                "dims": DIMS_Z,
                "units": "J K^-1 kg^-1",
            },
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
        }
        if self._moist:
            props["air_density"] = {"dims": DIMS, "units": "kg m^-3"}
            props["air_temperature"] = {"dims": DIMS, "units": "K"}
        return props

    def array_call(self, state):
        s = state["air_isentropic_density"]
        res = self._core.get_diagnostic_variables(
            s, self._pt, hs=state.get("topography_height"), moist=self._moist
        )
        out = {
            "air_pressure_on_interface_levels": res[0],
            "exner_function_on_interface_levels": res[1],
            "montgomery_potential": res[2],
            "height_on_interface_levels": res[3],
        }
        if self._moist:
            out["air_density"] = res[4]
            out["air_temperature"] = res[5]
        return out


class IsentropicVelocityComponents(DiagnosticComponent):
    """Staggered velocities from the momenta, with outermost layers from the
    lateral boundary (reference ``physics/diagnostics.py:199``)."""

    def __init__(self, domain, **kwargs) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self._hv = HorizontalVelocity(
            self.grid,
            staggering=True,
            backend=self.backend,
            backend_options=self.backend_options,
            storage_options=self.storage_options,
        )

    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {
            "x_velocity_at_u_locations": {"dims": DIMS_U, "units": "m s^-1"},
            "y_velocity_at_v_locations": {"dims": DIMS_V, "units": "m s^-1"},
        }

    def array_call(self, state):
        hb = self.horizontal_boundary
        u, v = self._hv.get_velocity_components(
            state["air_isentropic_density"],
            state["x_momentum_isentropic"],
            state["y_momentum_isentropic"],
        )
        u = hb.set_outermost_layers_x(
            u, "x_velocity_at_u_locations", "m s^-1", time=None
        )
        v = hb.set_outermost_layers_y(
            v, "y_velocity_at_v_locations", "m s^-1", time=None
        )
        return {
            "x_velocity_at_u_locations": u,
            "y_velocity_at_v_locations": v,
        }
