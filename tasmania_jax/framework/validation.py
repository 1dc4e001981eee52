"""Runtime validation: NaN/bounds checking via ``jax.experimental.checkify``.

JAX equivalent of the reference's correctness gates (``validate_args``,
``enable_checks``; SURVEY.md §5.2): deterministic collectives make data races
structurally absent, so the remaining runtime hazards are NaNs/Infs and
out-of-bounds indexing — exactly what ``checkify`` instruments.  Wrap a jitted
step with :func:`checked` during debugging; production drivers run unwrapped.
"""

from __future__ import annotations

from typing import Callable, Sequence


def checked(fn: Callable, errors=None) -> Callable:
    """Wrap ``fn`` so each call raises on NaN/Inf/OOB instead of propagating.

    Returns a callable with the same signature; the checkify error is thrown
    eagerly via ``err.throw()``.
    """
    from jax.experimental import checkify

    sets = errors if errors is not None else (
        checkify.float_checks | checkify.index_checks
    )
    checked_fn = checkify.checkify(fn, errors=sets)

    def wrapper(*args, **kwargs):
        err, out = checked_fn(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def assert_all_finite(tree, names: Sequence[str] = ()) -> None:
    """Eager host-side finiteness sweep over a pytree of arrays (debug aid)."""
    import jax
    import numpy as np

    leaves, _ = jax.tree_util.tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            label = names[i] if i < len(names) else f"leaf {i}"
            bad = np.size(arr) - np.isfinite(arr).sum()
            raise FloatingPointError(f"{label}: {bad} non-finite values")
