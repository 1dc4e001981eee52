"""Time steppers for the 2-D Burgers dynamical core.

JAX re-design of reference ``src/tasmania/burgers/dynamics/stepper.py:45,132``
and ``burgers/dynamics/subclasses/stepper/{forward_euler,rk2,rk3ws}.py:31``.
Stage algebra (RK-within-dycore convention: each stage steps from the *base*
state using the advection of the *latest provisional* state):

* FE    : out = u0 − dt·A(u0)
* RK2   : s0: out = u0 − dt/2·A(u0);  s1: out = u0 − dt·A(u_s0)
* RK3WS : dt/3, dt/2, dt across the three stages (RK3WS subclasses RK2 in the
  reference too)

Prescribed physics tendencies enter each stage as
``out = u0 − dt·(A − tnd)`` (reference ``stepper.py:190-268``).

The base-state capture at stage 0 mirrors the reference's stateful
``_stencil_args``; under jit all stages trace within one call so the captured
tracers are consistent.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from tasmania_jax.burgers.dynamics.advection import BurgersAdvection
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


class BurgersStepper(StencilFactory):
    """Factory base (reference ``stepper.py:45``)."""

    registry = {}

    def __init__(
        self,
        grid_xy,
        nb: int,
        flux_scheme: str,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(backend, backend_options, storage_options)
        self._grid_xy = grid_xy
        self._advection = BurgersAdvection.factory(flux_scheme, backend)
        assert nb >= self._advection.extent, (
            f"nb={nb} must be >= flux extent {self._advection.extent}"
        )
        self._nb = nb
        self._u0 = None
        self._v0 = None

    @property
    def stages(self) -> int:
        raise NotImplementedError

    @staticmethod
    def factory(
        time_integration_scheme: str,
        grid_xy,
        nb: int,
        flux_scheme: str,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> "BurgersStepper":
        return factorize(
            time_integration_scheme,
            BurgersStepper,
            (grid_xy, nb, flux_scheme, backend, backend_options, storage_options),
        )

    # -- single forward-Euler stage (shared by all schemes) --------------------- #
    def _stage(
        self,
        dt: float,
        u0,
        v0,
        state: Mapping[str, Any],
        tendencies: Mapping[str, Any],
    ) -> Dict[str, Any]:
        import numpy as np

        from tasmania_jax.utils.units import conversion_factor

        nb, ext = self._nb, self._advection.extent
        nx, ny = self._grid_xy.nx, self._grid_xy.ny
        dx = float(np.asarray(self._grid_xy.dx.to_units("m").data))
        dy = float(np.asarray(self._grid_xy.dy.to_units("m").data))

        u_tmp = state["x_velocity"]
        v_tmp = state["y_velocity"]
        xp = get_namespace(u_tmp)

        iw = slice(nb - ext, u_tmp.shape[0] - nb + ext)
        jw = slice(nb - ext, u_tmp.shape[1] - nb + ext)
        adv_u_x, adv_u_y, adv_v_x, adv_v_y = self._advection(
            dx, dy, u_tmp[iw, jw], v_tmp[iw, jw]
        )

        i = slice(nb, u_tmp.shape[0] - nb)
        j = slice(nb, u_tmp.shape[1] - nb)
        du = adv_u_x + adv_u_y
        dv = adv_v_x + adv_v_y
        if "x_velocity" in tendencies:
            du = du - tendencies["x_velocity"][i, j]
        if "y_velocity" in tendencies:
            dv = dv - tendencies["y_velocity"][i, j]

        out_u_in = u0[i, j] - dt * du
        out_v_in = v0[i, j] - dt * dv
        if xp is np:
            out_u = np.array(u_tmp, copy=True)
            out_v = np.array(v_tmp, copy=True)
            out_u[i, j] = out_u_in
            out_v[i, j] = out_v_in
        else:
            out_u = u_tmp.at[i, j].set(out_u_in)
            out_v = v_tmp.at[i, j].set(out_v_in)
        return {"x_velocity": out_u, "y_velocity": out_v}

    def __call__(
        self,
        stage: int,
        state: Mapping[str, Any],
        tendencies: Mapping[str, Any],
        timestep: float,
    ) -> Dict[str, Any]:
        raise NotImplementedError


def _with_time(out, state, offset_s: float):
    """Per-stage time stamp (reference steppers set ``out_state['time']``)."""
    if "time" in state:
        from datetime import timedelta

        out["time"] = state["time"] + timedelta(seconds=offset_s)
    return out


@factor_register("forward_euler")
class ForwardEuler(BurgersStepper):
    @property
    def stages(self) -> int:
        return 1

    def __call__(self, stage, state, tendencies, timestep):
        out = self._stage(
            timestep, state["x_velocity"], state["y_velocity"], state, tendencies
        )
        return _with_time(out, state, timestep)


@factor_register("rk2")
class RK2(BurgersStepper):
    @property
    def stages(self) -> int:
        return 2

    def _stage_dt(self, stage: int, dt: float) -> float:
        return 0.5 * dt if stage == 0 else dt

    def __call__(self, stage, state, tendencies, timestep):
        if stage == 0:
            self._u0 = state["x_velocity"]
            self._v0 = state["y_velocity"]
        out = self._stage(
            self._stage_dt(stage, timestep), self._u0, self._v0, state, tendencies
        )
        # cumulative stage times: rk2 -> t+dt/2, t+dt; rk3ws -> t+dt/3, t+dt/2, t+dt
        return _with_time(out, state, self._stage_time_offset(stage, timestep))

    def _stage_time_offset(self, stage: int, dt: float) -> float:
        if self.stages == 2:
            return 0.5 * dt
        return dt / 3.0 if stage == 0 else (dt / 6.0 if stage == 1 else 0.5 * dt)


@factor_register("rk3ws")
class RK3WS(RK2):
    """Wicker–Skamarock RK3 (subclasses RK2 like the reference, ``rk3ws.py``)."""

    @property
    def stages(self) -> int:
        return 3

    def _stage_dt(self, stage: int, dt: float) -> float:
        return dt / 3.0 if stage == 0 else (0.5 * dt if stage == 1 else dt)
