"""Horizontal smoothing of the isentropic prognostic fields.

JAX re-design of reference
``src/tasmania/isentropic/physics/horizontal_smoothing.py:44``: a
``DiagnosticComponent`` overwriting s, su, sv (+ moist species) with their
Shapiro-filtered values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_jax.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_jax.framework.core_components import DiagnosticComponent
from tasmania_jax.framework.field import FieldArray

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


class IsentropicHorizontalSmoothing(DiagnosticComponent):
    def __init__(
        self,
        domain,
        smooth_type: str = "first_order",
        smooth_coeff: float = 0.03,
        smooth_coeff_max: Optional[float] = None,
        smooth_damp_depth: int = 0,
        moist: bool = False,
        smooth_moist_coeff: Optional[float] = None,
        smooth_moist_coeff_max: Optional[float] = None,
        smooth_moist_damp_depth: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self._moist = moist
        g = self.grid
        nb = self.horizontal_boundary.nb
        cmax = smooth_coeff_max if smooth_coeff_max is not None else smooth_coeff
        self._core = HorizontalSmoothing.factory(
            smooth_type,
            (g.nx, g.ny, g.nz),
            smooth_coeff,
            cmax,
            smooth_damp_depth,
            nb,
            backend=self.backend,
            backend_options=self.backend_options,
            storage_options=self.storage_options,
        )
        if moist:
            mc = smooth_moist_coeff if smooth_moist_coeff is not None else smooth_coeff
            mcm = smooth_moist_coeff_max if smooth_moist_coeff_max is not None else mc
            self._core_moist = HorizontalSmoothing.factory(
                smooth_type,
                (g.nx, g.ny, g.nz),
                mc,
                mcm,
                smooth_moist_damp_depth or 0,
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
    def diagnostic_properties(self):
        return dict(self.input_properties)

    def _finish_all(self, state, out):
        """Distributed hooks (identity single-device): keep the input on the
        GLOBAL nb-frame — the single-device filter only writes the interior —
        and refresh the stale halo rings from the neighbours in ONE fused
        exchange."""
        hb = self.horizontal_boundary
        names = list(out)
        restricted = [
            hb.restrict_stencil_output(out[n], base=state[n], nb=self._core.nb)
            for n in names
        ]
        return dict(zip(names, hb.refresh_halos_many(restricted, names)))

    def array_call(self, state):
        out = {
            name: self._core(state[name])
            for name in (
                "air_isentropic_density",
                "x_momentum_isentropic",
                "y_momentum_isentropic",
            )
        }
        if self._moist:
            for q in (mfwv, mfcw, mfpw):
                out[q] = self._core_moist(state[q])
        return self._finish_all(state, out)
