"""Backend / storage / time-integration option bundles.

JAX re-design of reference ``src/tasmania/framework/options.py:48,73,84``.
GT4Py-specific knobs (rebuild, numba thread counts, CUDA blocks) are replaced by
JAX/XLA-relevant ones: jit toggling, donation and a device-mesh description.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BackendOptions:
    """Compile-time options for stencil compilation.

    * ``externals``: compile-time constants baked into kernels (the reference
      injects these into function globals, ``subclasses/stencil_compilers.py:92``;
      here they become closure constants / static args).
    * ``jit``: wrap compiled stencils in ``jax.jit`` when used standalone (inside
      an outer jit the wrapper is a no-op cost-wise).
    * ``validate_args``: enable trace-time property/shape validation.
    """

    dtypes: Optional[Mapping[str, Any]] = None
    externals: Dict[str, Any] = dataclasses.field(default_factory=dict)
    jit: bool = True
    donate: bool = False
    validate_args: bool = False
    # collected per-kernel execution info (timings), when enabled
    exec_info: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class StorageOptions:
    """Allocation-time options.

    ``halo`` is the number of ghost layers carried by shard-local blocks in the
    distributed path.
    """

    dtype: Any = np.float64
    halo: Optional[Tuple[int, int, int]] = None


@dataclasses.dataclass
class TimeIntegrationOptions:
    """Bundle of a component + its time-integration scheme (reference
    ``framework/options.py:84``), consumed by the splitting couplers."""

    component: Any = None
    scheme: Optional[str] = None
    enforce_horizontal_boundary: bool = False
    substeps: int = 1
    backend: str = "jax"
    backend_options: Optional[BackendOptions] = None
    storage_options: Optional[StorageOptions] = None
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
