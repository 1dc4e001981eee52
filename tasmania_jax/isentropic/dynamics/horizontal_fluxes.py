"""Horizontal numerical fluxes for the isentropic dynamical core.

JAX re-design of reference
``src/tasmania/isentropic/dynamics/horizontal_fluxes.py:40,141`` and
``subclasses/{horizontal_fluxes,minimal_horizontal_fluxes}/*``: four schemes —
``upwind`` (extent 1), ``centered`` (1), ``third_order_upwind`` (2),
``fifth_order_upwind`` (3) — each defining x/y face fluxes of an advected
density.  The "minimal" and full factories share these kernels (the full
variant's extra pressure-gradient arguments are handled by the prognostic
stencils here, as in the reference's semi-implicit path).

Index convention with exact per-field shapes (no uniform-storage padding):
``phi`` has nx cells, ``u`` has nx+1 faces; ``flux_x(u, phi)[k]`` is the flux
through face ``k + extent`` — faces [extent, nx+1-extent), length nx+1-2·extent.
Cell ``i``'s divergence uses faces ``i`` and ``i+1``.  All kernels are pure
slicing + arithmetic; XLA fuses the whole flux-divergence expression.
"""

from __future__ import annotations

from typing import Tuple

from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.utils.array import get_namespace


class IsentropicMinimalHorizontalFlux:
    """Scheme factory (reference ``horizontal_fluxes.py:141``)."""

    registry = {}
    extent: int = 1
    order: int = 1

    def __init__(self, *, backend: str = "jax") -> None:
        self._backend = backend

    @classmethod
    def factory(cls, scheme: str, *, backend: str = "jax"):
        return factorize(scheme, IsentropicMinimalHorizontalFlux, (), {"backend": backend})

    # subclasses implement the face-flux kernels
    def flux_x(self, u, phi):
        raise NotImplementedError

    def flux_y(self, v, phi):
        raise NotImplementedError

    # -- bundles mirroring the reference subroutine signatures ----------------- #
    def flux_dry(self, dt, dx, dy, s, u, v, su, sv, mtg=None, **kw) -> Tuple:
        """(flux_s_x, flux_s_y, flux_su_x, flux_su_y, flux_sv_x, flux_sv_y)"""
        return (
            self.flux_x(u, s),
            self.flux_y(v, s),
            self.flux_x(u, su),
            self.flux_y(v, su),
            self.flux_x(u, sv),
            self.flux_y(v, sv),
        )

    def flux_moist(self, dt, dx, dy, s, u, v, sqv, sqc, sqr, **kw) -> Tuple:
        return (
            self.flux_x(u, sqv),
            self.flux_y(v, sqv),
            self.flux_x(u, sqc),
            self.flux_y(v, sqc),
            self.flux_x(u, sqr),
            self.flux_y(v, sqr),
        )


class IsentropicHorizontalFlux(IsentropicMinimalHorizontalFlux):
    """Full-flux factory (reference ``horizontal_fluxes.py:40``); shares the
    minimal kernels — the pressure-gradient terms live in the prognostic
    stencils for the semi-implicit schemes used throughout."""

    registry = IsentropicMinimalHorizontalFlux.registry


@factor_register("upwind")
class Upwind(IsentropicMinimalHorizontalFlux):
    """First-order upwind (reference ``horizontal_fluxes/upwind.py:54``)."""

    extent = 1
    order = 1

    def flux_x(self, u, phi):
        xp = get_namespace(u)
        uf = u[1:-1]  # faces 1..nx-1
        return uf * xp.where(uf > 0.0, phi[:-1], phi[1:])

    def flux_y(self, v, phi):
        xp = get_namespace(v)
        vf = v[:, 1:-1]
        return vf * xp.where(vf > 0.0, phi[:, :-1], phi[:, 1:])


@factor_register("centered")
class Centered(IsentropicMinimalHorizontalFlux):
    """Second-order centred (reference ``horizontal_fluxes/centered.py:30``)."""

    extent = 1
    order = 2

    def flux_x(self, u, phi):
        return u[1:-1] * 0.5 * (phi[:-1] + phi[1:])

    def flux_y(self, v, phi):
        return v[:, 1:-1] * 0.5 * (phi[:, :-1] + phi[:, 1:])


@factor_register("third_order_upwind")
class ThirdOrderUpwind(IsentropicMinimalHorizontalFlux):
    """Third-order upwind-biased
    (reference ``horizontal_fluxes/third_order_upwind.py:92``):
    fourth-order centred flux minus |u|-weighted dissipation."""

    extent = 2
    order = 3

    def flux_x(self, u, phi):
        xp = get_namespace(u)
        uf = u[2:-2]  # faces 2..nx-1
        # cells around face m: m-2, m-1 (left), m (right), m+1
        pm2, pm1, p0, pp1 = phi[:-3], phi[1:-2], phi[2:-1], phi[3:]
        flux4 = uf / 12.0 * (7.0 * (p0 + pm1) - (pp1 + pm2))
        return flux4 - xp.abs(uf) / 12.0 * (3.0 * (p0 - pm1) - (pp1 - pm2))

    def flux_y(self, v, phi):
        xp = get_namespace(v)
        vf = v[:, 2:-2]
        pm2, pm1, p0, pp1 = phi[:, :-3], phi[:, 1:-2], phi[:, 2:-1], phi[:, 3:]
        flux4 = vf / 12.0 * (7.0 * (p0 + pm1) - (pp1 + pm2))
        return flux4 - xp.abs(vf) / 12.0 * (3.0 * (p0 - pm1) - (pp1 - pm2))


@factor_register("fifth_order_upwind")
class FifthOrderUpwind(IsentropicMinimalHorizontalFlux):
    """Fifth-order upwind-biased
    (reference ``horizontal_fluxes/fifth_order_upwind.py:128``):
    sixth-order centred flux minus |u|-weighted dissipation."""

    extent = 3
    order = 5

    def flux_x(self, u, phi):
        xp = get_namespace(u)
        uf = u[3:-3]  # faces 3..nx-2
        pm3, pm2, pm1 = phi[:-5], phi[1:-4], phi[2:-3]
        p0, pp1, pp2 = phi[3:-2], phi[4:-1], phi[5:]
        flux6 = uf / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3))
        return flux6 - xp.abs(uf) / 60.0 * (
            10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3)
        )

    def flux_y(self, v, phi):
        xp = get_namespace(v)
        vf = v[:, 3:-3]
        pm3, pm2, pm1 = phi[:, :-5], phi[:, 1:-4], phi[:, 2:-3]
        p0, pp1, pp2 = phi[:, 3:-2], phi[:, 4:-1], phi[:, 5:]
        flux6 = vf / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3))
        return flux6 - xp.abs(vf) / 60.0 * (
            10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3)
        )
