"""Smagorinsky turbulence in conservative (momentum) form for the isentropic
model (reference ``src/tasmania/isentropic/physics/turbulence.py:38``):
u = su/s, apply the velocity-form core, then scale tendencies by s."""

from __future__ import annotations

from tasmania_jax.physics.turbulence import Smagorinsky2d, _frame_paste, smagorinsky_core
from tasmania_jax.utils.array import get_namespace

DIMS = ("x", "y", "z")


class IsentropicSmagorinsky(Smagorinsky2d):
    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
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
        s = state["air_isentropic_density"]
        u = state["x_momentum_isentropic"] / s
        v = state["y_momentum_isentropic"] / s
        xp = get_namespace(s)
        dx, dy = self._spacings()
        nb = self._nb
        hb = self.horizontal_boundary
        u_tnd, v_tnd = smagorinsky_core(u, v, dx, dy, self._cs, nb)
        s_in = s[nb : s.shape[0] - nb, nb : s.shape[1] - nb]
        # distributed: global-frame zeroing + ONE fused halo refresh on the
        # tendencies (identity single-device; see Smagorinsky2d.array_call)
        out_su, out_sv = hb.refresh_halos_many(
            [
                hb.restrict_stencil_output(
                    _frame_paste(s.shape, nb, s_in * u_tnd, xp, s.dtype), nb=nb
                ),
                hb.restrict_stencil_output(
                    _frame_paste(s.shape, nb, s_in * v_tnd, xp, s.dtype), nb=nb
                ),
            ]
        )
        return (
            {"x_momentum_isentropic": out_su, "y_momentum_isentropic": out_sv},
            {},
        )
