"""Horizontal diffusion dwarf: ∇² tendency with vertically-graded diffusivity.

JAX re-design of reference ``src/tasmania/dwarfs/horizontal_diffusion.py:41``
and ``dwarfs/subclasses/horizontal_diffusers/{second,fourth}_order.py``.
The diffusivity is ramped (sin² over ``diffusion_damp_depth`` top levels,
reference ``horizontal_diffusion.py:90-98``) to mimic a short-wave absorber.
Functional: ``__call__(phi) -> tendency`` with zeros outside the ``nb``-wide
interior window (the reference writes only that window into its out-buffer).
One definition serves numpy + jax via namespace dispatch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import factor_register, factorize
from tasmania_jax.framework.stencil import StencilFactory
from tasmania_jax.utils.array import get_namespace


def build_damped_coeff(
    nz: int, coeff: float, coeff_max: float, damp_depth: int, dtype
) -> np.ndarray:
    """(1, 1, nz) diffusivity profile with sin² ramp over the top ``damp_depth``
    levels (reference ``horizontal_diffusion.py:90-98``)."""
    gamma = coeff * np.ones((1, 1, nz), dtype=dtype)
    n = min(damp_depth, nz)  # shallow grids
    if n > 0:
        pert = np.sin(0.5 * math.pi * (n - np.arange(0, n, dtype=dtype)) / n) ** 2
        gamma[:, :, :n] += (coeff_max - coeff) * pert
    return gamma


def _interior_paste(shape, nb_x, nb_y, interior, xp):
    """Zero array with ``interior`` pasted into the (nb_x, nb_y)-inset window."""
    out = xp.zeros(shape, dtype=interior.dtype)
    sl = (
        slice(nb_x, shape[0] - nb_x) if nb_x else slice(None),
        slice(nb_y, shape[1] - nb_y) if nb_y else slice(None),
    )
    if xp is np:
        out[sl] = interior
        return out
    return out.at[sl].set(interior)


class HorizontalDiffusion(StencilFactory):
    """Factory base (reference ``horizontal_diffusion.py:41``)."""

    registry = {}

    #: interior inset applied along each horizontal axis (set by subclasses)
    min_nb: int = 1
    apply_x: bool = True
    apply_y: bool = True

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
        nb = self.min_nb if (nb is None or nb < self.min_nb) else nb
        lb = 2 * nb + 1
        if self.apply_x:
            assert shape[0] >= lb, f"shape[0]={shape[0]} must be >= {lb}"
        if self.apply_y:
            assert shape[1] >= lb, f"shape[1]={shape[1]} must be >= {lb}"
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

    def _laplacian_interior(self, phi):
        raise NotImplementedError

    def __call__(self, phi):
        """Return the diffusion tendency of ``phi`` (zeros on the frame)."""
        xp = get_namespace(phi)
        gamma = xp.asarray(self._gamma, dtype=phi.dtype)
        lap = self._laplacian_interior(phi)
        interior = gamma * lap
        return _interior_paste(
            phi.shape,
            self._nb if self.apply_x else 0,
            self._nb if self.apply_y else 0,
            interior,
            xp,
        )

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalDiffusion":
        return factorize(name, HorizontalDiffusion, args, kwargs)


def _win(nb, n, off):
    """Interior window [nb+off, n-nb+off) along one axis."""
    return slice(nb + off, n - nb + off)


@factor_register("second_order")
class SecondOrder(HorizontalDiffusion):
    """∇²φ via centred 3-point second differences
    (reference ``second_order.py:32``)."""

    min_nb = 1

    def _laplacian_interior(self, phi):
        nb = self._nb
        nx, ny = phi.shape[0], phi.shape[1]
        dx2, dy2 = self._dx * self._dx, self._dy * self._dy
        i = _win(nb, nx, 0)
        j = _win(nb, ny, 0)
        return (
            (phi[_win(nb, nx, -1), j] - 2.0 * phi[i, j] + phi[_win(nb, nx, +1), j]) / dx2
            + (phi[i, _win(nb, ny, -1)] - 2.0 * phi[i, j] + phi[i, _win(nb, ny, +1)]) / dy2
        )


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalDiffusion):
    min_nb = 1
    apply_y = False

    def _laplacian_interior(self, phi):
        nb, nx = self._nb, phi.shape[0]
        dx2 = self._dx * self._dx
        i = _win(nb, nx, 0)
        return (phi[_win(nb, nx, -1)] - 2.0 * phi[i] + phi[_win(nb, nx, +1)]) / dx2


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalDiffusion):
    min_nb = 1
    apply_x = False

    def _laplacian_interior(self, phi):
        nb, ny = self._nb, phi.shape[1]
        dy2 = self._dy * self._dy
        j = _win(nb, ny, 0)
        return (phi[:, _win(nb, ny, -1)] - 2.0 * phi[:, j] + phi[:, _win(nb, ny, +1)]) / dy2


@factor_register("fourth_order")
class FourthOrder(HorizontalDiffusion):
    """∇²φ via 5-point fourth-order-accurate differences
    (reference ``fourth_order.py:32``)."""

    min_nb = 2

    def _laplacian_interior(self, phi):
        nb = self._nb
        nx, ny = phi.shape[0], phi.shape[1]
        dx2, dy2 = 12.0 * self._dx * self._dx, 12.0 * self._dy * self._dy
        i = _win(nb, nx, 0)
        j = _win(nb, ny, 0)
        return (
            -phi[_win(nb, nx, -2), j]
            + 16.0 * phi[_win(nb, nx, -1), j]
            - 30.0 * phi[i, j]
            + 16.0 * phi[_win(nb, nx, +1), j]
            - phi[_win(nb, nx, +2), j]
        ) / dx2 + (
            -phi[i, _win(nb, ny, -2)]
            + 16.0 * phi[i, _win(nb, ny, -1)]
            - 30.0 * phi[i, j]
            + 16.0 * phi[i, _win(nb, ny, +1)]
            - phi[i, _win(nb, ny, +2)]
        ) / dy2


@factor_register("fourth_order_1dx")
class FourthOrder1DX(HorizontalDiffusion):
    min_nb = 2
    apply_y = False

    def _laplacian_interior(self, phi):
        nb, nx = self._nb, phi.shape[0]
        dx2 = 12.0 * self._dx * self._dx
        i = _win(nb, nx, 0)
        return (
            -phi[_win(nb, nx, -2)]
            + 16.0 * phi[_win(nb, nx, -1)]
            - 30.0 * phi[i]
            + 16.0 * phi[_win(nb, nx, +1)]
            - phi[_win(nb, nx, +2)]
        ) / dx2


@factor_register("fourth_order_1dy")
class FourthOrder1DY(HorizontalDiffusion):
    min_nb = 2
    apply_x = False

    def _laplacian_interior(self, phi):
        nb, ny = self._nb, phi.shape[1]
        dy2 = 12.0 * self._dy * self._dy
        j = _win(nb, ny, 0)
        return (
            -phi[:, _win(nb, ny, -2)]
            + 16.0 * phi[:, _win(nb, ny, -1)]
            - 30.0 * phi[:, j]
            + 16.0 * phi[:, _win(nb, ny, +1)]
            - phi[:, _win(nb, ny, +2)]
        ) / dy2
