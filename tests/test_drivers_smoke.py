"""Driver smoke tests: every coupling variant completes a few tiny steps on
CPU with plausible validation numbers."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.mark.parametrize("coupling", ["fc", "lfc", "ps", "sts", "sus", "ssus"])
def test_variant_runs(coupling, monkeypatch):
    import importlib

    import drivers.namelist_sus as nl

    importlib.reload(nl)
    monkeypatch.setattr(nl, "nx", 17)
    monkeypatch.setattr(nl, "ny", 17)
    monkeypatch.setattr(nl, "nz", 8)

    from drivers.driver_isentropic_moist import build_variant
    from tasmania_jax.framework.field import FieldArray

    import jax.numpy as jnp

    domain, state, step_impl = build_variant(nl, coupling)
    hs = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.data),
        dtype=np.float32,
    )
    st = {k: v for k, v in state.items() if k != "time"}
    for _ in range(2):
        st["topography_height"] = FieldArray(0.01 * hs, "m", ("x", "y"))
        st = step_impl(st, 5.0)
    u = np.asarray(st["x_velocity_at_u_locations"].data)
    assert np.isfinite(u).all()
    assert abs(u.max() - 22.5) < 1.0  # small perturbation of the background


@pytest.mark.parametrize("extra", [[], ["--bf16-carry"]])
def test_sus_driver_fused_loop(extra):
    """The fused-loop benchmark path (and its experimental bf16-carry
    variant) completes with finite validation numbers."""
    from drivers.driver_namelist_sus import main

    out = main(
        ["--nx", "17", "--ny", "17", "--nz", "8", "--niter", "3", "--fused-loop"]
        + extra
    )
    assert np.isfinite(out["umax"]) and np.isfinite(out["vmax"])
    assert abs(out["umax"] - 22.5) < 2.0


def test_sus_driver_checkpoint_resume(tmp_path):
    """Kill-and-resume: a run checkpointed at step 4 resumes and reaches the
    same final validation numbers as an uninterrupted run."""
    from drivers.driver_namelist_sus import main

    base = ["--nx", "17", "--ny", "17", "--nz", "8"]
    full = main(base + ["--niter", "6"])

    ck = str(tmp_path / "ck")
    main(base + ["--niter", "4", "--checkpoint-dir", ck, "--checkpoint-every", "2"])
    resumed = main(
        base + ["--niter", "6", "--checkpoint-dir", ck, "--resume"]
    )
    assert abs(resumed["umax"] - full["umax"]) < 1e-4
    assert abs(resumed["vmax"] - full["vmax"]) < 1e-4


def test_nan_guard_detects_blowup(monkeypatch):
    """A CFL-unstable run trips the --nan-guard probe with an actionable
    error instead of checkpointing a poisoned state (SURVEY §5.3)."""
    import importlib
    from datetime import timedelta

    import drivers.namelist_sus as nl

    importlib.reload(nl)
    monkeypatch.setattr(nl, "timestep", timedelta(seconds=600))

    from drivers.driver_namelist_sus import main

    with pytest.raises(RuntimeError, match="non-finite state"):
        main(
            ["--nx", "17", "--ny", "17", "--nz", "8", "--niter", "40",
             "--nan-guard", "--checkpoint-every", "5"]
        )
