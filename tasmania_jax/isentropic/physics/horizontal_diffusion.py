"""Horizontal diffusion tendencies for the isentropic prognostic fields.

JAX re-design of reference
``src/tasmania/isentropic/physics/horizontal_diffusion.py:46``: a
``TendencyComponent`` applying the :class:`HorizontalDiffusion` dwarf to
s, su, sv (+ water species when moist, with independent coefficients).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_jax.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_jax.framework.core_components import TendencyComponent
from tasmania_jax.framework.field import FieldArray

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


def _coeff(value, default=0.0) -> float:
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units("s^-1").data))
    return float(value if value is not None else default)


class IsentropicHorizontalDiffusion(TendencyComponent):
    def __init__(
        self,
        domain,
        diffusion_type: str = "second_order",
        diffusion_coeff=None,
        diffusion_coeff_max=None,
        diffusion_damp_depth: int = 0,
        moist: bool = False,
        diffusion_moist_coeff=None,
        diffusion_moist_coeff_max=None,
        diffusion_moist_damp_depth: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self._moist = moist
        g = self.grid
        dx = float(np.asarray(g.dx.to_units("m").data))
        dy = float(np.asarray(g.dy.to_units("m").data))
        nb = self.horizontal_boundary.nb
        coeff = _coeff(diffusion_coeff, 0.0)
        coeff_max = _coeff(diffusion_coeff_max, coeff)
        self._core = HorizontalDiffusion.factory(
            diffusion_type,
            (g.nx, g.ny, g.nz),
            dx,
            dy,
            coeff,
            coeff_max,
            diffusion_damp_depth,
            nb,
            backend=self.backend,
            backend_options=self.backend_options,
            storage_options=self.storage_options,
        )
        if moist:
            mcoeff = _coeff(diffusion_moist_coeff, coeff)
            mcoeff_max = _coeff(diffusion_moist_coeff_max, mcoeff)
            self._core_moist = HorizontalDiffusion.factory(
                diffusion_type,
                (g.nx, g.ny, g.nz),
                dx,
                dy,
                mcoeff,
                mcoeff_max,
                diffusion_moist_damp_depth or 0,
                nb,
                backend=self.backend,
                backend_options=self.backend_options,
                storage_options=self.storage_options,
            )

    @property
    def input_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def tendency_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1 s^-1"}
        return props

    def array_call(self, state):
        tends = {
            name: self._core(state[name])
            for name in (
                "air_isentropic_density",
                "x_momentum_isentropic",
                "y_momentum_isentropic",
            )
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                tends[q] = self._core_moist(state[q])
        # distributed hooks (identity single-device): zeros on the GLOBAL
        # nb-frame, halo rings refreshed in ONE fused exchange
        hb = self.horizontal_boundary
        names = list(tends)
        restricted = [
            hb.restrict_stencil_output(tends[n], nb=self._core.nb) for n in names
        ]
        return dict(zip(names, hb.refresh_halos_many(restricted, names))), {}
