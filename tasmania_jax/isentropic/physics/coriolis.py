"""f-plane Coriolis tendencies on the isentropic momenta
(reference ``src/tasmania/isentropic/physics/coriolis.py:44``):
tnd_su = +f·sv, tnd_sv = −f·su on the nb-inset interior."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_jax.framework.core_components import TendencyComponent
from tasmania_jax.framework.field import FieldArray

DIMS = ("x", "y", "z")


class IsentropicConservativeCoriolis(TendencyComponent):
    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        coriolis_parameter=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        if isinstance(coriolis_parameter, FieldArray):
            self._f = float(np.asarray(coriolis_parameter.to_units("rad s^-1").data))
        else:
            self._f = float(coriolis_parameter if coriolis_parameter is not None else 1e-4)
        self._nb = self.horizontal_boundary.nb if grid_type == "numerical" else 0

    @property
    def input_properties(self):
        return {
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }

    def array_call(self, state):
        su = state["x_momentum_isentropic"]
        sv = state["y_momentum_isentropic"]
        nb = self._nb
        # pointwise everywhere, then zero the physical-domain frame: on a
        # single device this equals the reference's interior-window write; in
        # the distributed build it keeps shard halos valid with no exchange
        # (HorizontalBoundary.zero_physical_frame)
        if self._grid_type == "numerical":
            hb = self.horizontal_boundary
            tnd_su = hb.zero_physical_frame(self._f * sv, nb)
            tnd_sv = hb.zero_physical_frame(-self._f * su, nb)
        else:
            tnd_su = self._f * sv
            tnd_sv = -self._f * su
        return {
            "x_momentum_isentropic": tnd_su,
            "y_momentum_isentropic": tnd_sv,
        }, {}
