"""The accelerator a run is on: the GPU check, the card's name and power
limit, and where compiled programs are cached.

A measurement that finds no GPU fails here instead of timing XLA's CPU
backend: JAX quietly falls back to the CPU when its CUDA plugin cannot start,
so the platform is checked, never assumed.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import jax

#: root of the checkout (the compile cache lives under it)
REPO_ROOT = Path(__file__).resolve().parents[2]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
NVIDIA_SMI_QUERY = (
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
)


class NoGPUError(RuntimeError):
    """JAX found no GPU to run on."""


def configure_compile_cache(root: Path = REPO_ROOT) -> str:
    """Keep JAX's persistent compilation cache at a fixed path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache is ``<root>/.jax_cache``: the
    path is part of the cache key, so it must not move between runs.
    Returns the directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = str(Path(root) / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices: Optional[Sequence] = None) -> Dict[str, object]:
    """The run's device as JAX reports it; raises :class:`NoGPUError`
    unless the first device is a GPU."""
    devices = list(jax.devices() if devices is None else devices)
    d = devices[0]
    if d.platform != "gpu":
        raise NoGPUError(
            f"this run needs a GPU; JAX found {d.platform!r} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def parse_nvidia_smi(line: str) -> Tuple[str, str]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, power limit)."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    return name.strip(), limit.strip()


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` line from ``nvidia-smi``,
    checked by :func:`parse_nvidia_smi`."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True, timeout=60
    ).stdout
    line = out.strip().splitlines()[0]
    parse_nvidia_smi(line)
    return line
