"""Backend-dispatched allocation (reference ``framework/allocators.py:40-118``).

The reference routes ``zeros/ones/empty/as_storage`` through per-backend
allocator subclasses honouring dtype + gt4py ``aligned_index``.  Here the
analogue is: numpy allocation for the oracle backend, ``jax.numpy`` allocation
(optionally placed with a ``NamedSharding``) for device backends.  ``empty``
returns zeros — XLA has no uninitialised storage and determinism is worth more
than the memset.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from tasmania_jax.framework.options import StorageOptions


def _xp(backend: str):
    if backend.startswith("numpy"):
        return np
    import jax.numpy as jnp

    return jnp


def zeros(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    return _xp(backend).zeros(shape, dtype=so.dtype)


def ones(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    return _xp(backend).ones(shape, dtype=so.dtype)


def empty(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    return zeros(backend, shape, storage_options=storage_options)


def as_storage(backend: str, data: Any, *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    return _xp(backend).asarray(data, dtype=so.dtype)
