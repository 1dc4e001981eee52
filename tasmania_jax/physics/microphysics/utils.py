"""Microphysics utilities: clipping, precipitation, sedimentation fluxes.

JAX re-design of reference ``src/tasmania/physics/microphysics/utils.py:58,144,326``
and ``microphysics/sedimentation_fluxes/{first,second}_order.py:30``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from tasmania_jax.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
)
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.utils.array import get_namespace

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


class Clipping(DiagnosticComponent):
    """Clip water species to q ≥ 0 (reference ``utils.py:58``)."""

    def __init__(self, domain, grid_type: str = "numerical", water_species_names: Optional[Sequence[str]] = None, **kwargs):
        self._names = tuple(water_species_names or (mfwv, mfcw, mfpw))
        super().__init__(domain, grid_type, **kwargs)

    @property
    def input_properties(self):
        return {name: {"dims": DIMS, "units": "g g^-1"} for name in self._names}

    @property
    def diagnostic_properties(self):
        return {name: {"dims": DIMS, "units": "g g^-1"} for name in self._names}

    def array_call(self, state):
        xp = get_namespace(state[self._names[0]])
        return {
            name: xp.where(state[name] > 0.0, state[name], xp.zeros_like(state[name]))
            for name in self._names
        }


class Precipitation(ImplicitTendencyComponent):
    """Surface precipitation rate + accumulated precipitation from the
    sedimentation flux at the surface level (reference ``utils.py:144``)."""

    default_physical_constants = {
        "density_of_liquid_water": (1000.0, "kg m^-3"),
    }

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
            "raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"},
            "accumulated_precipitation": {"dims": DIMS, "units": "mm"},
        }

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        return {
            "precipitation": {"dims": DIMS, "units": "mm hr^-1"},
            "accumulated_precipitation": {"dims": DIMS, "units": "mm"},
        }

    def array_call(self, state, timestep: float):
        rhow = self.rpc["density_of_liquid_water"]
        # surface level = last main level (COSMO ordering)
        rho_s = state["air_density"][:, :, -1:]
        qr_s = state[mfpw][:, :, -1:]
        vt_s = state["raindrop_fall_velocity"][:, :, -1:]
        accprec = state["accumulated_precipitation"]
        prec = 3.6e6 * rho_s * qr_s * vt_s / rhow  # [mm/hr]
        new_acc = accprec + timestep * prec / 3.6e3
        return {}, {"precipitation": prec, "accumulated_precipitation": new_acc}


class SedimentationFlux:
    """Vertical-derivative-of-flux factory (reference ``utils.py:326``);
    returns dfdz on levels [extent, nz)."""

    registry = {}
    nb: int = 1  # flux extent

    @staticmethod
    def factory(flux_type: str, backend: str = "jax"):
        return factorize(flux_type, SedimentationFlux, ())

    def __call__(self, rho, h, q, vt):
        raise NotImplementedError


@factor_register("first_order_upwind")
class FirstOrderUpwind(SedimentationFlux):
    """(reference ``sedimentation_fluxes/first_order.py:30``)"""

    nb = 1

    def __call__(self, rho, h, q, vt):
        return (
            rho[:, :, :-1] * q[:, :, :-1] * vt[:, :, :-1]
            - rho[:, :, 1:] * q[:, :, 1:] * vt[:, :, 1:]
        ) / (h[:, :, :-1] - h[:, :, 1:])


@factor_register("second_order_upwind")
class SecondOrderUpwind(SedimentationFlux):
    """(reference ``sedimentation_fluxes/second_order.py:30``)"""

    nb = 2

    def __call__(self, rho, h, q, vt):
        a = (2.0 * h[:, :, 2:] - h[:, :, 1:-1] - h[:, :, :-2]) / (
            (h[:, :, 1:-1] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 2:])
        )
        b = (h[:, :, :-2] - h[:, :, 2:]) / (
            (h[:, :, 1:-1] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 1:-1])
        )
        c = (h[:, :, 2:] - h[:, :, 1:-1]) / (
            (h[:, :, :-2] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 1:-1])
        )
        return (
            a * rho[:, :, 2:] * q[:, :, 2:] * vt[:, :, 2:]
            + b * rho[:, :, 1:-1] * q[:, :, 1:-1] * vt[:, :, 1:-1]
            + c * rho[:, :, :-2] * q[:, :, :-2] * vt[:, :, :-2]
        )
