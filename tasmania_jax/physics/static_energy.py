"""Dry / moist static energy diagnostics
(reference ``src/tasmania/physics/static_energy.py:43,176``)."""

from __future__ import annotations

from tasmania_jax.framework.core_components import DiagnosticComponent

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


class DryStaticEnergy(DiagnosticComponent):
    """dse = cp·T + g·h (h averaged to main levels when staggered)."""

    default_physical_constants = {
        "gravitational_acceleration": (9.80665, "m s^-2"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def __init__(self, domain, grid_type: str = "numerical", height_on_interface_levels: bool = True, **kwargs):
        self._stgz = height_on_interface_levels
        super().__init__(domain, grid_type, **kwargs)

    @property
    def input_properties(self):
        props = {"air_temperature": {"dims": DIMS, "units": "K"}}
        if self._stgz:
            props["height_on_interface_levels"] = {"dims": DIMS_Z, "units": "m"}
        else:
            props["height"] = {"dims": DIMS, "units": "m"}
        return props

    @property
    def diagnostic_properties(self):
        return {"montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"}}

    def array_call(self, state):
        g = self.rpc["gravitational_acceleration"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        t = state["air_temperature"]
        if self._stgz:
            h_if = state["height_on_interface_levels"]
            h = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        else:
            h = state["height"]
        return {"montgomery_potential": cp * t + g * h}


class MoistStaticEnergy(DiagnosticComponent):
    """mse = dse + Lhv·qv."""

    default_physical_constants = {
        "latent_heat_of_vaporization_of_water": (2.5e6, "J kg^-1"),
    }

    @property
    def input_properties(self):
        return {
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "mass_fraction_of_water_vapor_in_air": {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {"moist_static_energy": {"dims": DIMS, "units": "m^2 s^-2"}}

    def array_call(self, state):
        lhv = self.rpc["latent_heat_of_vaporization_of_water"]
        return {
            "moist_static_energy": state["montgomery_potential"]
            + lhv * state["mass_fraction_of_water_vapor_in_air"]
        }
