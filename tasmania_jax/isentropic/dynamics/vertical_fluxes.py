"""Vertical numerical fluxes for the isentropic model.

JAX re-design of reference
``src/tasmania/isentropic/dynamics/vertical_fluxes.py:40`` and
``subclasses/minimal_vertical_fluxes/{upwind,centered,third_order_upwind,
fifth_order_upwind}.py``.  Index convention (COSMO k: top → surface):
inputs are ``w`` on interface levels (nz+1) and ``phi`` on main levels (nz);
``__call__`` returns fluxes at interior interfaces [extent, nz+1-extent),
length nz+1-2·extent.  Positive w = dθ/dt (upward-decreasing k), hence the
upwind pick ``phi[m]`` when ``w[m] > 0`` (the cell *below* interface m).
"""

from __future__ import annotations

from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.utils.array import get_namespace


class IsentropicMinimalVerticalFlux:
    registry = {}
    extent: int = 1
    order: int = 1

    def __init__(self, *, backend: str = "jax") -> None:
        self._backend = backend

    @classmethod
    def factory(cls, scheme: str, *, backend: str = "jax"):
        return factorize(scheme, IsentropicMinimalVerticalFlux, (), {"backend": backend})

    def __call__(self, dt, dz, w, phi):
        raise NotImplementedError


@factor_register("upwind")
class Upwind(IsentropicMinimalVerticalFlux):
    extent = 1
    order = 1

    def __call__(self, dt, dz, w, phi):
        xp = get_namespace(w)
        wf = w[:, :, 1:-1]
        return wf * xp.where(wf > 0.0, phi[:, :, 1:], phi[:, :, :-1])


@factor_register("centered")
class Centered(IsentropicMinimalVerticalFlux):
    extent = 1
    order = 2

    def __call__(self, dt, dz, w, phi):
        return w[:, :, 1:-1] * 0.5 * (phi[:, :, 1:] + phi[:, :, :-1])


@factor_register("third_order_upwind")
class ThirdOrderUpwind(IsentropicMinimalVerticalFlux):
    extent = 2
    order = 3

    def __call__(self, dt, dz, w, phi):
        xp = get_namespace(w)
        wf = w[:, :, 2:-2]
        return wf / 12.0 * (
            7.0 * (phi[:, :, 1:-2] + phi[:, :, 2:-1]) - (phi[:, :, :-3] + phi[:, :, 3:])
        ) - xp.abs(wf) / 12.0 * (
            3.0 * (phi[:, :, 1:-2] - phi[:, :, 2:-1]) - (phi[:, :, :-3] - phi[:, :, 3:])
        )


@factor_register("fifth_order_upwind")
class FifthOrderUpwind(IsentropicMinimalVerticalFlux):
    extent = 3
    order = 5

    def __call__(self, dt, dz, w, phi):
        xp = get_namespace(w)
        wf = w[:, :, 3:-3]
        return wf / 60.0 * (
            37.0 * (phi[:, :, 2:-3] + phi[:, :, 3:-2])
            - 8.0 * (phi[:, :, 1:-4] + phi[:, :, 4:-1])
            + (phi[:, :, :-5] + phi[:, :, 5:])
        ) - xp.abs(wf) / 60.0 * (
            10.0 * (phi[:, :, 2:-3] - phi[:, :, 3:-2])
            - 5.0 * (phi[:, :, 1:-4] - phi[:, :, 4:-1])
            + (phi[:, :, :-5] - phi[:, :, 5:])
        )
