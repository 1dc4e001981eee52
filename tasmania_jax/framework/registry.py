"""Hierarchical kernel/factory registries.

JAX re-design of the reference's protocol layer
(reference: ``src/tasmania/utils/protocol.py:39`` ``Registry`` with regex/wildcard
lookup, ``framework/register.py:34,60`` ``register``/``factorize``).

Two registries live here:

* ``Registry`` — a two-level mapping ``name -> backend -> payload`` with wildcard
  (``"all"``) and glob-style backend patterns (``"jax*"``), used for stencil
  definitions and their compilers.
* ``factor_register``/``factorize`` — string-keyed subclass factories used across the
  framework (boundaries, topographies, steppers, fluxes, ...), mirroring the
  reference's ``Registry``-backed ``AbstractFactory`` pattern.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Type

from tasmania_jax.utils.exceptions import FactoryRegistryError

WILDCARD = "all"


class Registry:
    """``name -> backend -> payload`` with wildcard and glob backend patterns."""

    def __init__(self) -> None:
        self._store: Dict[str, Dict[str, Any]] = {}

    def register(self, payload: Any, name: str, backend: str = WILDCARD) -> None:
        self._store.setdefault(name, {})[backend] = payload

    def query(self, name: str, backend: str) -> Any:
        """Resolve payload for (name, backend).

        Resolution order: exact backend match; then glob-pattern match (longest
        pattern wins, so ``"jax:gpu*"`` beats ``"jax*"``); then wildcard.
        """
        entry = self._store.get(name)
        if entry is None:
            entry = self._store.get(WILDCARD)
        if entry is None:
            raise FactoryRegistryError(f"no registration for {name!r}")
        if backend in entry:
            return entry[backend]
        candidates = [
            pat for pat in entry if pat != WILDCARD and fnmatch.fnmatchcase(backend, pat)
        ]
        if candidates:
            return entry[max(candidates, key=len)]
        if WILDCARD in entry:
            return entry[WILDCARD]
        raise FactoryRegistryError(
            f"no registration for {name!r} under backend {backend!r}; "
            f"available: {sorted(entry)}"
        )

    def names(self) -> Sequence[str]:
        return tuple(self._store)

    def backends(self, name: str) -> Sequence[str]:
        return tuple(self._store.get(name, ()))

    def __contains__(self, name: str) -> bool:
        return name in self._store


def make_decorator_registrar(registry: Registry) -> Callable:
    """Build a decorator ``@reg(name=..., backend=...)`` filling ``registry``."""

    def registrar(name: str, backend="jax"):
        backends = (backend,) if isinstance(backend, str) else tuple(backend)

        def wrap(fn):
            for b in backends:
                registry.register(fn, name, b)
            return fn

        return wrap

    return registrar


# --------------------------------------------------------------------------- #
# subclass factories                                                          #
# --------------------------------------------------------------------------- #


def factor_register(name: str) -> Callable[[type], type]:
    """Class decorator registering a subclass under ``name`` on its factory base.

    The base class must define a class-level ``registry`` dict (see e.g.
    ``HorizontalBoundary``). Mirrors reference ``framework/register.py:34``.
    """

    def wrap(cls: type) -> type:
        for base in cls.__mro__[1:]:
            reg = base.__dict__.get("registry")
            if isinstance(reg, dict):
                reg[name] = cls
                cls.registry_name = name
                return cls
        raise FactoryRegistryError(
            f"{cls.__name__} has no factory base with a 'registry' dict"
        )

    return wrap


def factorize(
    name: str,
    base: type,
    args: Sequence[Any] = (),
    kwargs: Optional[Mapping[str, Any]] = None,
) -> Any:
    """Instantiate the subclass registered under ``name`` on ``base``.

    Mirrors reference ``framework/register.py:60``.
    """
    reg = base.__dict__.get("registry")
    if not isinstance(reg, dict):
        raise FactoryRegistryError(f"{base.__name__} defines no registry")
    if name not in reg:
        raise FactoryRegistryError(
            f"unknown {base.__name__} flavour {name!r}; registered: {sorted(reg)}"
        )
    return reg[name](*args, **(dict(kwargs) if kwargs else {}))


def registered_names(base: type) -> Sequence[str]:
    reg = base.__dict__.get("registry")
    return tuple(reg) if isinstance(reg, dict) else ()
