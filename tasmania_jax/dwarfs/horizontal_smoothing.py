"""Horizontal smoothing dwarf: Shapiro-type filters with vertically-graded
coefficient.

JAX re-design of reference ``src/tasmania/dwarfs/horizontal_smoothing.py:41``
and ``dwarfs/subclasses/horizontal_smoothers/{first,second,third}_order.py``.
Functional: ``__call__(phi)`` returns the smoothed *field* — interior filtered,
frame passed through unchanged (the reference writes the filtered window into
its out-buffer over ``origin=(nb,nb,0)``).

Filter weights (verified against the reference numpy stencils):

* first  : (1-γ)φ + γ/4 (φ_W + φ_E + φ_S + φ_N)
* second : (1-¾γ)φ + γ/16 (-φ_WW + 4φ_W - φ_EE + 4φ_E - φ_SS + 4φ_S - φ_NN + 4φ_N)
* third  : (1-⅝γ)φ + γ/64 (φ_3W - 6φ_WW + 15φ_W + ... symmetric in 4 directions)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tasmania_jax.dwarfs.horizontal_diffusion import build_damped_coeff
from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


def _paste_into(phi, nb_x, nb_y, interior, xp):
    sl = (
        slice(nb_x, phi.shape[0] - nb_x) if nb_x else slice(None),
        slice(nb_y, phi.shape[1] - nb_y) if nb_y else slice(None),
    )
    if xp is np:
        out = np.array(phi, copy=True)
        out[sl] = interior
        return out
    return phi.at[sl].set(interior)


class HorizontalSmoothing(StencilFactory):
    """Factory base (reference ``horizontal_smoothing.py:41``)."""

    registry = {}

    order: int = 1
    axis: Optional[str] = None

    def __init__(
        self,
        shape: Tuple[int, int, int],
        smooth_coeff: float,
        smooth_coeff_max: float,
        smooth_damp_depth: int,
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
        self._gamma = build_damped_coeff(
            shape[2],
            smooth_coeff,
            smooth_coeff_max,
            smooth_damp_depth,
            self.storage_options.dtype,
        )

    @property
    def nb(self) -> int:
        return self._nb

    def _filter_1d(self, w, g, axis: int):
        """Apply the order-n 1-D Shapiro correction along ``axis`` on a window
        that carries ``order`` extra layers per side along that axis."""
        n = self.order

        def sh(off):
            sl = [slice(None)] * w.ndim
            sl[axis] = slice(n + off, w.shape[axis] - n + off)
            return w[tuple(sl)]

        if n == 1:
            return 0.25 * g * (sh(-1) + sh(+1))
        if n == 2:
            return 0.0625 * g * (-sh(-2) + 4.0 * sh(-1) - sh(+2) + 4.0 * sh(+1))
        return 0.015625 * g * (
            sh(-3) - 6.0 * sh(-2) + 15.0 * sh(-1) + sh(+3) - 6.0 * sh(+2) + 15.0 * sh(+1)
        )

    def __call__(self, phi):
        xp = get_namespace(phi)
        nb, n = self._nb, self.order
        g = xp.asarray(self._gamma, dtype=phi.dtype)
        if self.axis == "x":
            # centre factors: 1-γ/2 (1st), 1-⅜γ (2nd), 1-0.3125γ (3rd)
            cw = {1: 0.5, 2: 0.375, 3: 0.3125}[n]
            w = phi[nb - n : phi.shape[0] - nb + n]
            center = phi[nb : phi.shape[0] - nb]
            interior = (1.0 - cw * g) * center + self._filter_1d(w, g, 0)
            return _paste_into(phi, nb, 0, interior, xp)
        if self.axis == "y":
            cw = {1: 0.5, 2: 0.375, 3: 0.3125}[n]
            w = phi[:, nb - n : phi.shape[1] - nb + n]
            center = phi[:, nb : phi.shape[1] - nb]
            interior = (1.0 - cw * g) * center + self._filter_1d(w, g, 1)
            return _paste_into(phi, 0, nb, interior, xp)
        # 2-D centre factors: 1-γ (1st), 1-¾γ (2nd), 1-⅝γ (3rd)
        cw = {1: 1.0, 2: 0.75, 3: 0.625}[n]
        wx = phi[nb - n : phi.shape[0] - nb + n, nb : phi.shape[1] - nb]
        wy = phi[nb : phi.shape[0] - nb, nb - n : phi.shape[1] - nb + n]
        center = phi[nb : phi.shape[0] - nb, nb : phi.shape[1] - nb]
        interior = (
            (1.0 - cw * g) * center
            + self._filter_1d(wx, g, 0)
            + self._filter_1d(wy, g, 1)
        )
        return _paste_into(phi, nb, nb, interior, xp)

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalSmoothing":
        return factorize(name, HorizontalSmoothing, args, kwargs)


@factor_register("first_order")
class FirstOrder(HorizontalSmoothing):
    order = 1


@factor_register("first_order_1dx")
class FirstOrder1DX(HorizontalSmoothing):
    order, axis = 1, "x"


@factor_register("first_order_1dy")
class FirstOrder1DY(HorizontalSmoothing):
    order, axis = 1, "y"


@factor_register("second_order")
class SecondOrder(HorizontalSmoothing):
    order = 2


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalSmoothing):
    order, axis = 2, "x"


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalSmoothing):
    order, axis = 2, "y"


@factor_register("third_order")
class ThirdOrder(HorizontalSmoothing):
    order = 3


@factor_register("third_order_1dx")
class ThirdOrder1DX(HorizontalSmoothing):
    order, axis = 3, "x"


@factor_register("third_order_1dy")
class ThirdOrder1DY(HorizontalSmoothing):
    order, axis = 3, "y"
