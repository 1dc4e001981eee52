"""Horizontal hyper-diffusion dwarf: iterated-Laplacian tendencies.

JAX re-design of reference
``src/tasmania/dwarfs/horizontal_hyperdiffusion.py:43`` and
``dwarfs/subclasses/horizontal_hyperdiffusers/{first,second,third}_order.py``:
order-n applies the (dx,dy-scaled) 5-point Laplacian n times on progressively
shrinking windows; XLA fuses the whole chain into one pass per output tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tasmania_jax.dwarfs.horizontal_diffusion import (
    _interior_paste,
    build_damped_coeff,
)
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


def laplacian(dx: float, dy: float, phi):
    """5-point Laplacian shrinking the window by 1 per horizontal axis
    (reference ``horizontal_hyperdiffusion.py:247-252`` ``stage_laplacian``)."""
    return (phi[:-2, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[2:, 1:-1]) / (dx * dx) + (
        phi[1:-1, :-2] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, 2:]
    ) / (dy * dy)


def laplacian_x(dx: float, phi):
    return (phi[:-2] - 2.0 * phi[1:-1] + phi[2:]) / (dx * dx)


def laplacian_y(dy: float, phi):
    return (phi[:, :-2] - 2.0 * phi[:, 1:-1] + phi[:, 2:]) / (dy * dy)


class HorizontalHyperDiffusion(StencilFactory):
    """Factory base (reference ``horizontal_hyperdiffusion.py:43``)."""

    registry = {}

    order: int = 1
    axis: Optional[str] = None  # None (2-D), "x" or "y"

    def __init__(
        self,
        shape: Tuple[int, int, int],
        dx: float,
        dy: float,
        diffusion_coeff: float,
        diffusion_coeff_max: float,
        diffusion_damp_depth: int,
        nb: Optional[int] = None,
        *,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(backend, backend_options, storage_options)
        nb = self.order if (nb is None or nb < self.order) else nb
        self._shape = shape
        self._nb = nb
        self._dx = float(dx)
        self._dy = float(dy)
        self._gamma = build_damped_coeff(
            shape[2],
            diffusion_coeff,
            diffusion_coeff_max,
            diffusion_damp_depth,
            self.storage_options.dtype,
        )

    @property
    def nb(self) -> int:
        return self._nb

    def __call__(self, phi):
        """Return the hyper-diffusion tendency (zeros on the frame)."""
        xp = get_namespace(phi)
        nb, n = self._nb, self.order
        gamma = xp.asarray(self._gamma, dtype=phi.dtype)
        if self.axis == "x":
            win = phi[nb - n : phi.shape[0] - nb + n]
            for _ in range(n):
                win = laplacian_x(self._dx, win)
            return _interior_paste(phi.shape, nb, 0, gamma * win, xp)
        if self.axis == "y":
            win = phi[:, nb - n : phi.shape[1] - nb + n]
            for _ in range(n):
                win = laplacian_y(self._dy, win)
            return _interior_paste(phi.shape, 0, nb, gamma * win, xp)
        win = phi[
            nb - n : phi.shape[0] - nb + n, nb - n : phi.shape[1] - nb + n
        ]
        for _ in range(n):
            win = laplacian(self._dx, self._dy, win)
        return _interior_paste(phi.shape, nb, nb, gamma * win, xp)

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalHyperDiffusion":
        return factorize(name, HorizontalHyperDiffusion, args, kwargs)


@factor_register("first_order")
class FirstOrder(HorizontalHyperDiffusion):
    order = 1


@factor_register("first_order_1dx")
class FirstOrder1DX(HorizontalHyperDiffusion):
    order, axis = 1, "x"


@factor_register("first_order_1dy")
class FirstOrder1DY(HorizontalHyperDiffusion):
    order, axis = 1, "y"


@factor_register("second_order")
class SecondOrder(HorizontalHyperDiffusion):
    order = 2


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalHyperDiffusion):
    order, axis = 2, "x"


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalHyperDiffusion):
    order, axis = 2, "y"


@factor_register("third_order")
class ThirdOrder(HorizontalHyperDiffusion):
    order = 3


@factor_register("third_order_1dx")
class ThirdOrder1DX(HorizontalHyperDiffusion):
    order, axis = 3, "x"


@factor_register("third_order_1dy")
class ThirdOrder1DY(HorizontalHyperDiffusion):
    order, axis = 3, "y"
