"""2-D Smagorinsky turbulence closure.

JAX re-design of reference ``src/tasmania/physics/turbulence.py:42``:
strain-rate tensor from centred differences, eddy viscosity
``nu = cs²·dx·dy·|S|``, tendency = 2·∇·(nu·S).  The stencil halo is 2 points
(one ring for S, one for ∇·); tendencies are zero on the frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tasmania_jax.framework.core_components import TendencyComponent
from tasmania_jax.utils.array import get_namespace

DIMS = ("x", "y", "z")


def smagorinsky_core(u, v, dx: float, dy: float, cs: float, nb: int):
    """(u_tnd, v_tnd) on the (nb..-nb) interior window
    (reference ``turbulence.py:210-227`` ``_core_numpy``)."""
    # strain rate on the window extended by one ring
    ib, ie = nb, u.shape[0] - nb
    jb, je = nb, u.shape[1] - nb
    s00 = (u[ib : ie + 2, jb - 1 : je + 1] - u[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx)
    s01 = 0.5 * (
        (u[ib - 1 : ie + 1, jb : je + 2] - u[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
        + (v[ib : ie + 2, jb - 1 : je + 1] - v[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx)
    )
    s11 = (v[ib - 1 : ie + 1, jb : je + 2] - v[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
    nu = cs**2 * dx * dy * (2.0 * (s00**2 + 2.0 * s01**2 + s11**2)) ** 0.5
    u_tnd = 2.0 * (
        (nu[2:, 1:-1] * s00[2:, 1:-1] - nu[:-2, 1:-1] * s00[:-2, 1:-1]) / (2.0 * dx)
        + (nu[1:-1, 2:] * s01[1:-1, 2:] - nu[1:-1, :-2] * s01[1:-1, :-2]) / (2.0 * dy)
    )
    v_tnd = 2.0 * (
        (nu[2:, 1:-1] * s01[2:, 1:-1] - nu[:-2, 1:-1] * s01[:-2, 1:-1]) / (2.0 * dx)
        + (nu[1:-1, 2:] * s11[1:-1, 2:] - nu[1:-1, :-2] * s11[1:-1, :-2]) / (2.0 * dy)
    )
    return u_tnd, v_tnd


def _frame_paste(shape, nb, interior, xp, dtype):
    out = xp.zeros(shape, dtype=dtype)
    sl = (slice(nb, shape[0] - nb), slice(nb, shape[1] - nb))
    if xp is np:
        out[sl] = interior
        return out
    return out.at[sl].set(interior)


class Smagorinsky2d(TendencyComponent):
    """Velocity-form Smagorinsky tendencies (reference ``turbulence.py:42``)."""

    def __init__(
        self,
        domain,
        smagorinsky_constant: float = 0.18,
        *,
        enable_checks: bool = True,
        backend: str = "jax",
        backend_options=None,
        storage_options=None,
        **kwargs,
    ) -> None:
        super().__init__(
            domain,
            "numerical",
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
        )
        self._cs = smagorinsky_constant
        assert self.horizontal_boundary.nb >= 2, (
            "Smagorinsky requires nb >= 2 (reference turbulence.py:103)"
        )
        self._nb = max(2, self.horizontal_boundary.nb)

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

    def _spacings(self) -> Tuple[float, float]:
        dx = float(np.asarray(self.grid.dx.to_units("m").data))
        dy = float(np.asarray(self.grid.dy.to_units("m").data))
        return dx, dy

    def array_call(self, state):
        u, v = state["x_velocity"], state["y_velocity"]
        xp = get_namespace(u)
        dx, dy = self._spacings()
        nb = self._nb
        hb = self.horizontal_boundary
        u_tnd, v_tnd = smagorinsky_core(u, v, dx, dy, self._cs, nb)
        # distributed: keep zeros on the GLOBAL frame and fill the stale halo
        # rings from the neighbours in one fused exchange (the downstream
        # pointwise update then preserves halo validity); both hooks are
        # identity single-device
        out_u, out_v = hb.refresh_halos_many(
            [
                hb.restrict_stencil_output(
                    _frame_paste(u.shape, nb, u_tnd, xp, u.dtype), nb=nb
                ),
                hb.restrict_stencil_output(
                    _frame_paste(v.shape, nb, v_tnd, xp, v.dtype), nb=nb
                ),
            ]
        )
        return ({"x_velocity": out_u, "y_velocity": out_v}, {})
