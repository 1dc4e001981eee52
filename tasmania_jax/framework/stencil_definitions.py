"""Generic backend-registered stencils: state algebra, relaxation, STS stages,
and the Thomas tridiagonal solver.

JAX re-design of reference
``src/tasmania/framework/subclasses/stencil_definitions/{copy,math,cla,algorithms,
diffusion}.py`` and ``subroutine_definitions/{generics,laplacian,math}.py``.
Key semantic shift: the reference writes into out-buffers over an
``origin/domain`` window; here every op is *functional* (returns a new array) and
window restriction, when needed, is done by the caller with slice-paste — the
idiom XLA fuses best.  One definition serves numpy + jax via namespace dispatch,
mirroring the reference's backend-equivalence testing axis.
"""

from __future__ import annotations

import numpy as np

from tasmania_jax.framework.stencil import stencil_definition, subroutine_definition
from tasmania_jax.utils.array import get_namespace

_ALL = ("jax", "numpy")


# --------------------------------------------------------------------------- #
# copy / elementwise algebra (reference stencil_definitions/{copy,math}.py)    #
# --------------------------------------------------------------------------- #


@stencil_definition("copy", backend=_ALL)
def copy(src):
    xp = get_namespace(src)
    return xp.asarray(src).copy() if xp is np else xp.asarray(src)


@stencil_definition("copychange", backend=_ALL)
def copychange(src):
    return -src


@stencil_definition("abs", backend=_ALL)
def abs_(phi):
    return get_namespace(phi).abs(phi)


@stencil_definition("add", backend=_ALL)
def add(a, b):
    return a + b


@stencil_definition("sub", backend=_ALL)
def sub(a, b):
    return a - b


@stencil_definition("mul", backend=_ALL)
def mul(a, b):
    return a * b


@stencil_definition("scale", backend=_ALL)
def scale(phi, *, f):
    return f * phi


@stencil_definition("addsub", backend=_ALL)
def addsub(a, b, c):
    return a + b - c


@stencil_definition("fma", backend=_ALL)
def fma(a, b, *, f):
    return a + f * b


@stencil_definition("clip", backend=_ALL)
def clip(phi):
    xp = get_namespace(phi)
    return xp.where(phi > 0, phi, xp.zeros_like(phi))


# --------------------------------------------------------------------------- #
# boundary relaxation (reference stencil_definitions/cla.py + algorithms.py)   #
# --------------------------------------------------------------------------- #


@stencil_definition("relax", backend=_ALL)
def relax(gamma, phi, phi_ref):
    """Lehmann/Davies relaxation towards a reference state.

    gamma==0 keeps phi, gamma==1 pins to phi_ref, else blends
    (reference ``stencil_definitions/algorithms.py:46-57``).
    """
    return phi - gamma * (phi - phi_ref)


# --------------------------------------------------------------------------- #
# sequential-tendency-splitting stage combinations                             #
# (reference ``stencil_definitions/algorithms.py:61-71``)                      #
# --------------------------------------------------------------------------- #


@stencil_definition("sts_rk2_0", backend=_ALL)
def sts_rk2_0(field, field_prv, tnd, *, dt):
    return 0.5 * (field + field_prv + dt * tnd)


@stencil_definition("sts_rk3ws_0", backend=_ALL)
def sts_rk3ws_0(field, field_prv, tnd, *, dt):
    return (2.0 * field + field_prv + dt * tnd) / 3.0


# --------------------------------------------------------------------------- #
# Thomas tridiagonal solver (reference stencil_definitions/diffusion.py        #
# "thomas"; per-column solve used by implicit vertical advection)              #
# --------------------------------------------------------------------------- #


@stencil_definition("thomas", backend="numpy")
def thomas_numpy(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis, vectorised over leading axes.

    a: sub-diagonal (a[...,0] unused), b: diagonal, c: super-diagonal
    (c[...,-1] unused), d: rhs.  Standard forward sweep / back substitution.
    """
    n = b.shape[-1]
    cp = np.zeros_like(b)
    dp = np.zeros_like(b)
    cp[..., 0] = c[..., 0] / b[..., 0]
    dp[..., 0] = d[..., 0] / b[..., 0]
    for k in range(1, n):
        denom = b[..., k] - a[..., k] * cp[..., k - 1]
        cp[..., k] = c[..., k] / denom
        dp[..., k] = (d[..., k] - a[..., k] * dp[..., k - 1]) / denom
    x = np.zeros_like(b)
    x[..., n - 1] = dp[..., n - 1]
    for k in range(n - 2, -1, -1):
        x[..., k] = dp[..., k] - cp[..., k] * x[..., k + 1]
    return x


@stencil_definition("thomas", backend="jax")
def thomas_jax(a, b, c, d):
    """Thomas solve along the last axis via two ``lax.scan`` sweeps.

    The k-recurrence is sequential by nature; scanning over k with the full
    (x, y) tile as the carry keeps the device busy — each scan step is one
    fused elementwise plane update.  See SURVEY.md §5.7.
    """
    import jax
    import jax.numpy as jnp

    def fwd(carry, inputs):
        cp_km1, dp_km1 = carry
        a_k, b_k, c_k, d_k = inputs
        denom = b_k - a_k * cp_km1
        cp_k = c_k / denom
        dp_k = (d_k - a_k * dp_km1) / denom
        return (cp_k, dp_k), (cp_k, dp_k)

    amove = jnp.moveaxis(a, -1, 0)
    bmove = jnp.moveaxis(b, -1, 0)
    cmove = jnp.moveaxis(c, -1, 0)
    dmove = jnp.moveaxis(d, -1, 0)
    zeros = jnp.zeros_like(bmove[0])
    _, (cp, dp) = jax.lax.scan(fwd, (zeros, zeros), (amove, bmove, cmove, dmove))

    def bwd(x_kp1, inputs):
        cp_k, dp_k = inputs
        x_k = dp_k - cp_k * x_kp1
        return x_k, x_k

    _, x_rev = jax.lax.scan(bwd, zeros, (cp, dp), reverse=True)
    return jnp.moveaxis(x_rev, 0, -1)


# --------------------------------------------------------------------------- #
# subroutines (reference subroutine_definitions/*)                             #
# --------------------------------------------------------------------------- #


@subroutine_definition("absolute", backend=_ALL)
def absolute(phi):
    return get_namespace(phi).abs(phi)


@subroutine_definition("positive", backend=_ALL)
def positive(phi):
    xp = get_namespace(phi)
    return xp.where(phi > 0, phi, xp.zeros_like(phi))


@subroutine_definition("negative", backend=_ALL)
def negative(phi):
    xp = get_namespace(phi)
    return xp.where(phi < 0, -phi, xp.zeros_like(phi))


@subroutine_definition("laplacian_2d", backend=_ALL)
def laplacian_2d(phi, *, dx, dy):
    """5-point Laplacian on the interior; result is 2 points smaller per
    horizontal axis is avoided — same-shape output with zero boundary ring
    (caller slices the valid window).  phi has shape (nx, ny, nz)."""
    xp = get_namespace(phi)
    lap = xp.zeros_like(phi)
    interior = (
        (phi[:-2, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[2:, 1:-1]) / (dx * dx)
        + (phi[1:-1, :-2] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, 2:]) / (dy * dy)
    )
    if xp is np:
        lap[1:-1, 1:-1] = interior
        return lap
    return lap.at[1:-1, 1:-1].set(interior)
