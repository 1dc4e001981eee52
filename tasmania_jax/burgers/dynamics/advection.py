"""Advective fluxes for the 2-D inviscid Burgers equations, orders 1–6.

JAX re-design of reference ``src/tasmania/burgers/dynamics/advection.py:39,121``
and ``burgers/dynamics/subclasses/advection/{first..sixth}_order.py:33-35``.
Odd orders are upwind-biased (centred term + |u|-weighted dissipation), even
orders purely centred; ``extent`` is the halo width each scheme needs
(1/1/2/2/3/3).  Each ``__call__`` consumes a window carrying ``extent`` extra
layers per side and returns the four advection terms on the inner window —
pure jnp slicing that XLA fuses into the surrounding stage stencil.
"""

from __future__ import annotations

from typing import Tuple

from tasmania_jax.framework.registry import factor_register, factorize


class BurgersAdvection:
    """Factory base (reference ``advection.py:39``)."""

    registry = {}
    extent: int = 1

    @staticmethod
    def factory(flux_scheme: str, backend: str = "jax") -> "BurgersAdvection":
        return factorize(flux_scheme, BurgersAdvection, ())

    def __call__(self, dx: float, dy: float, u, v) -> Tuple:
        raise NotImplementedError


@factor_register("first_order")
class FirstOrder(BurgersAdvection):
    """First-order upwind (reference ``first_order.py``)."""

    extent = 1

    def __call__(self, dx, dy, u, v):
        uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
        abs_u, abs_v = abs(uc), abs(vc)
        adv_u_x = uc / (2.0 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1]) - abs_u / (2.0 * dx) * (
            u[2:, 1:-1] - 2.0 * uc + u[:-2, 1:-1]
        )
        adv_u_y = vc / (2.0 * dy) * (u[1:-1, 2:] - u[1:-1, :-2]) - abs_v / (2.0 * dy) * (
            u[1:-1, 2:] - 2.0 * uc + u[1:-1, :-2]
        )
        adv_v_x = uc / (2.0 * dx) * (v[2:, 1:-1] - v[:-2, 1:-1]) - abs_u / (2.0 * dx) * (
            v[2:, 1:-1] - 2.0 * vc + v[:-2, 1:-1]
        )
        adv_v_y = vc / (2.0 * dy) * (v[1:-1, 2:] - v[1:-1, :-2]) - abs_v / (2.0 * dy) * (
            v[1:-1, 2:] - 2.0 * vc + v[1:-1, :-2]
        )
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y


@factor_register("second_order")
class SecondOrder(BurgersAdvection):
    """Second-order centred (reference ``second_order.py``)."""

    extent = 1

    def __call__(self, dx, dy, u, v):
        uc, vc = u[1:-1, 1:-1], v[1:-1, 1:-1]
        adv_u_x = uc / (2.0 * dx) * (u[2:, 1:-1] - u[:-2, 1:-1])
        adv_u_y = vc / (2.0 * dy) * (u[1:-1, 2:] - u[1:-1, :-2])
        adv_v_x = uc / (2.0 * dx) * (v[2:, 1:-1] - v[:-2, 1:-1])
        adv_v_y = vc / (2.0 * dy) * (v[1:-1, 2:] - v[1:-1, :-2])
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y


@factor_register("third_order")
class ThirdOrder(BurgersAdvection):
    """Third-order upwind (reference ``third_order.py``)."""

    extent = 2

    def __call__(self, dx, dy, u, v):
        uc, vc = u[2:-2, 2:-2], v[2:-2, 2:-2]
        abs_u, abs_v = abs(uc), abs(vc)
        adv_u_x = uc / (12.0 * dx) * (
            8.0 * (u[3:-1, 2:-2] - u[1:-3, 2:-2]) - (u[4:, 2:-2] - u[:-4, 2:-2])
        ) + abs_u / (12.0 * dx) * (
            u[4:, 2:-2] + u[:-4, 2:-2] - 4.0 * (u[3:-1, 2:-2] + u[1:-3, 2:-2]) + 6.0 * uc
        )
        adv_u_y = vc / (12.0 * dy) * (
            8.0 * (u[2:-2, 3:-1] - u[2:-2, 1:-3]) - (u[2:-2, 4:] - u[2:-2, :-4])
        ) + abs_v / (12.0 * dy) * (
            u[2:-2, 4:] + u[2:-2, :-4] - 4.0 * (u[2:-2, 3:-1] + u[2:-2, 1:-3]) + 6.0 * uc
        )
        adv_v_x = uc / (12.0 * dx) * (
            8.0 * (v[3:-1, 2:-2] - v[1:-3, 2:-2]) - (v[4:, 2:-2] - v[:-4, 2:-2])
        ) + abs_u / (12.0 * dx) * (
            v[4:, 2:-2] + v[:-4, 2:-2] - 4.0 * (v[3:-1, 2:-2] + v[1:-3, 2:-2]) + 6.0 * vc
        )
        adv_v_y = vc / (12.0 * dy) * (
            8.0 * (v[2:-2, 3:-1] - v[2:-2, 1:-3]) - (v[2:-2, 4:] - v[2:-2, :-4])
        ) + abs_v / (12.0 * dy) * (
            v[2:-2, 4:] + v[2:-2, :-4] - 4.0 * (v[2:-2, 3:-1] + v[2:-2, 1:-3]) + 6.0 * vc
        )
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y


@factor_register("fourth_order")
class FourthOrder(BurgersAdvection):
    """Fourth-order centred (reference ``fourth_order.py``)."""

    extent = 2

    def __call__(self, dx, dy, u, v):
        uc, vc = u[2:-2, 2:-2], v[2:-2, 2:-2]
        adv_u_x = uc / (12.0 * dx) * (
            8.0 * (u[3:-1, 2:-2] - u[1:-3, 2:-2]) - (u[4:, 2:-2] - u[:-4, 2:-2])
        )
        adv_u_y = vc / (12.0 * dy) * (
            8.0 * (u[2:-2, 3:-1] - u[2:-2, 1:-3]) - (u[2:-2, 4:] - u[2:-2, :-4])
        )
        adv_v_x = uc / (12.0 * dx) * (
            8.0 * (v[3:-1, 2:-2] - v[1:-3, 2:-2]) - (v[4:, 2:-2] - v[:-4, 2:-2])
        )
        adv_v_y = vc / (12.0 * dy) * (
            8.0 * (v[2:-2, 3:-1] - v[2:-2, 1:-3]) - (v[2:-2, 4:] - v[2:-2, :-4])
        )
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y


def _fifth_centred(dd, a, ap1, am1, ap2, am2, ap3, am3):
    return (45.0 * (ap1 - am1) - 9.0 * (ap2 - am2) + (ap3 - am3)) / (60.0 * dd)


def _fifth_dissip(dd, a, ap1, am1, ap2, am2, ap3, am3):
    return ((ap3 + am3) - 6.0 * (ap2 + am2) + 15.0 * (ap1 + am1) - 20.0 * a) / (60.0 * dd)


@factor_register("fifth_order")
class FifthOrder(BurgersAdvection):
    """Fifth-order upwind (reference ``fifth_order.py``)."""

    extent = 3

    def __call__(self, dx, dy, u, v):
        c = (slice(3, -3), slice(3, -3))

        def sx(f, off):
            return f[3 + off : f.shape[0] - 3 + off, 3:-3]

        def sy(f, off):
            return f[3:-3, 3 + off : f.shape[1] - 3 + off]

        uc, vc = u[c], v[c]
        abs_u, abs_v = abs(uc), abs(vc)
        adv_u_x = uc * _fifth_centred(
            dx, uc, sx(u, 1), sx(u, -1), sx(u, 2), sx(u, -2), sx(u, 3), sx(u, -3)
        ) - abs_u * _fifth_dissip(
            dx, uc, sx(u, 1), sx(u, -1), sx(u, 2), sx(u, -2), sx(u, 3), sx(u, -3)
        )
        adv_u_y = vc * _fifth_centred(
            dy, uc, sy(u, 1), sy(u, -1), sy(u, 2), sy(u, -2), sy(u, 3), sy(u, -3)
        ) - abs_v * _fifth_dissip(
            dy, uc, sy(u, 1), sy(u, -1), sy(u, 2), sy(u, -2), sy(u, 3), sy(u, -3)
        )
        adv_v_x = uc * _fifth_centred(
            dx, vc, sx(v, 1), sx(v, -1), sx(v, 2), sx(v, -2), sx(v, 3), sx(v, -3)
        ) - abs_u * _fifth_dissip(
            dx, vc, sx(v, 1), sx(v, -1), sx(v, 2), sx(v, -2), sx(v, 3), sx(v, -3)
        )
        adv_v_y = vc * _fifth_centred(
            dy, vc, sy(v, 1), sy(v, -1), sy(v, 2), sy(v, -2), sy(v, 3), sy(v, -3)
        ) - abs_v * _fifth_dissip(
            dy, vc, sy(v, 1), sy(v, -1), sy(v, 2), sy(v, -2), sy(v, 3), sy(v, -3)
        )
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y


@factor_register("sixth_order")
class SixthOrder(BurgersAdvection):
    """Sixth-order centred (reference ``sixth_order.py``)."""

    extent = 3

    def __call__(self, dx, dy, u, v):
        c = (slice(3, -3), slice(3, -3))

        def sx(f, off):
            return f[3 + off : f.shape[0] - 3 + off, 3:-3]

        def sy(f, off):
            return f[3:-3, 3 + off : f.shape[1] - 3 + off]

        uc, vc = u[c], v[c]
        adv_u_x = uc * _fifth_centred(
            dx, uc, sx(u, 1), sx(u, -1), sx(u, 2), sx(u, -2), sx(u, 3), sx(u, -3)
        )
        adv_u_y = vc * _fifth_centred(
            dy, uc, sy(u, 1), sy(u, -1), sy(u, 2), sy(u, -2), sy(u, 3), sy(u, -3)
        )
        adv_v_x = uc * _fifth_centred(
            dx, vc, sx(v, 1), sx(v, -1), sx(v, 2), sx(v, -2), sx(v, 3), sx(v, -3)
        )
        adv_v_y = vc * _fifth_centred(
            dy, vc, sy(v, 1), sy(v, -1), sy(v, 2), sy(v, -2), sy(v, 3), sy(v, -3)
        )
        return adv_u_x, adv_u_y, adv_v_x, adv_v_y
