"""Stencil compilation & dispatch — the backend boundary of the framework.

JAX re-design of reference ``src/tasmania/framework/stencil.py:206``
(``StencilFactory`` with ``compile_stencil``) and
``framework/subclasses/stencil_compilers.py``.  Where the reference resolves a
GT4Py/numpy/numba *definition* and hands it to a per-backend *compiler* that
generates C++/CUDA, here a definition is a pure array function and the compilers
are:

* ``numpy`` — call through on numpy arrays (the plain reference the tests
  and the GPU smoke run compare against);
* ``jax``   — close over externals, optionally ``jax.jit`` (XLA fuses the
  elementwise graph; this is the path that runs on the GPU).

Definitions take arrays positionally plus keyword-only compile-time constants
(externals).  They must be trace-safe (no data-dependent Python control flow).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Mapping, Optional

import jax
import numpy as np

from tasmania_jax.framework.options import BackendOptions, StorageOptions
from tasmania_jax.framework.registry import Registry, make_decorator_registrar

#: global registries: stencil definitions and reusable subroutines
STENCIL_REGISTRY = Registry()
SUBROUTINE_REGISTRY = Registry()

#: decorator: @stencil_definition("diffusion", backend=("jax", "numpy"))
stencil_definition = make_decorator_registrar(STENCIL_REGISTRY)
#: decorator: @subroutine_definition("laplacian", backend="jax")
subroutine_definition = make_decorator_registrar(SUBROUTINE_REGISTRY)

#: the backends a component may be built for
BACKENDS = ("jax", "numpy")


def check_backend(backend: str) -> str:
    """``backend`` if it is one of :data:`BACKENDS`, else ValueError."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def _bind_externals(fn: Callable, externals: Mapping[str, Any]) -> Callable:
    """Partially apply the keyword-only externals that ``fn`` declares."""
    if not externals:
        return fn
    sig = inspect.signature(fn)
    accepted = {
        k: v
        for k, v in externals.items()
        if k in sig.parameters
        and sig.parameters[k].kind
        in (inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    }
    return functools.partial(fn, **accepted) if accepted else fn


def compile_stencil(
    name: str,
    backend: str = "jax",
    backend_options: Optional[BackendOptions] = None,
) -> Callable:
    """Resolve + compile the stencil ``name`` for ``backend``.

    Mirrors reference ``framework/stencil.py:273`` ``compile_stencil``; the
    "compiler" step here is externals binding + (for jax-family backends) jit.
    """
    bo = backend_options or BackendOptions()
    defn = STENCIL_REGISTRY.query(name, backend)
    bound = _bind_externals(defn, bo.externals)
    if backend.startswith("numpy"):
        return bound
    if bo.jit:
        return jax.jit(bound)
    return bound


def compile_subroutine(
    name: str,
    backend: str = "jax",
    backend_options: Optional[BackendOptions] = None,
) -> Callable:
    bo = backend_options or BackendOptions()
    defn = SUBROUTINE_REGISTRY.query(name, backend)
    return _bind_externals(defn, bo.externals)


class StencilFactory:
    """Mixin giving any component backend-aware compile/allocate methods.

    Mirrors reference ``framework/stencil.py:206``; every framework component
    inherits this so its kernels follow the component's configured backend.
    """

    def __init__(
        self,
        backend: str = "jax",
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        self._backend = check_backend(backend or "jax")
        self._backend_options = backend_options or BackendOptions()
        self._storage_options = storage_options or StorageOptions()

    # -- properties --------------------------------------------------------- #
    @property
    def backend(self) -> str:
        return self._backend

    @property
    def backend_options(self) -> BackendOptions:
        return self._backend_options

    @property
    def storage_options(self) -> StorageOptions:
        return self._storage_options

    # -- compile ------------------------------------------------------------ #
    def compile_stencil(self, name: str, backend: Optional[str] = None) -> Callable:
        return compile_stencil(name, backend or self._backend, self._backend_options)

    def compile_subroutine(self, name: str, backend: Optional[str] = None) -> Callable:
        return compile_subroutine(name, backend or self._backend, self._backend_options)

    # -- allocate ----------------------------------------------------------- #
    def _xp(self, backend: Optional[str] = None):
        import jax.numpy as jnp

        b = backend or self._backend
        return np if b.startswith("numpy") else jnp

    def zeros(self, shape, backend: Optional[str] = None, dtype=None):
        return self._xp(backend).zeros(
            shape, dtype=dtype or self._storage_options.dtype
        )

    def ones(self, shape, backend: Optional[str] = None, dtype=None):
        return self._xp(backend).ones(shape, dtype=dtype or self._storage_options.dtype)

    def empty(self, shape, backend: Optional[str] = None, dtype=None):
        # XLA has no uninitialised alloc; zeros keeps semantics deterministic
        return self.zeros(shape, backend, dtype)

    def as_storage(self, data, backend: Optional[str] = None, dtype=None):
        return self._xp(backend).asarray(
            data, dtype=dtype or self._storage_options.dtype
        )
