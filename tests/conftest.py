"""Test configuration.

Tests run on CPU with float64 enabled (the numpy-oracle comparison axis,
mirroring the reference's backend-equivalence strategy, SURVEY.md §4) and with
8 virtual devices for mesh/topology-equivalence tests.  Tests that need the
GPU carry the ``gpu`` marker and skip inside the ``gpu`` fixture here.
"""

import os

# force CPU: the oracle tests compare against numpy at small sizes, and a GPU
# (where one exists) is left to the ``gpu``-marked tests and chip_smoke.py
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# set through jax.config as well, so the choice holds even where the
# environment names another platform
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# the drivers point JAX's persistent compilation cache into the checkout;
# the tests' small programs gain nothing from it
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def gpu_env():
    """This process's environment without the CPU pinning above: the
    environment a ``gpu`` test gives the subprocess that uses the card."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX finds a GPU.  This process is pinned to the CPU, so a
    fresh interpreter without the pinning asks; ``gpu`` tests run their work
    in such a subprocess too."""
    import subprocess
    import sys

    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=gpu_env(), timeout=300,
    )
    platform = probe.stdout.strip().splitlines()[-1:] or ["none"]
    if platform[0] != "gpu":
        pytest.skip(f"needs a GPU; JAX found {platform[0]!r}")
    return gpu_env()
