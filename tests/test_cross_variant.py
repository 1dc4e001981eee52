"""Cross-variant statistical comparison (TODO validation item): the six
physics-coupling strategies integrate the same moist flow; their trajectories
differ at the splitting-error level O(dt), so after a short run the key
statistics must agree within a narrow band across variants
(reference: the six ``drivers/benchmarking/isentropic_moist`` drivers share
one namelist and validate with the same umax/vmax printout).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = ["fc", "lfc", "ps", "sts", "sus", "ssus"]


@pytest.fixture(scope="module")
def trajectories():
    import drivers.namelist_sus as nl
    import jax.numpy as jnp

    from drivers.driver_isentropic_moist import build_variant
    from tasmania_jax.framework.field import FieldArray

    results = {}
    for coupling in VARIANTS:
        importlib.reload(nl)
        nl.nx = nl.ny = 21
        nl.nz = 10
        domain, state, step_impl = build_variant(nl, coupling)
        hs = jnp.asarray(
            np.asarray(domain.numerical_grid.topography.steady_profile.data),
            dtype=np.float32,
        )
        st = {k: v for k, v in state.items() if k != "time"}
        nt, dt = 15, 5.0
        for i in range(nt):
            fact = min((i + 1) * dt / 1800.0, 1.0)
            st["topography_height"] = FieldArray(fact * hs, "m", ("x", "y"))
            st = step_impl(st, dt)
        u = np.asarray(st["x_velocity_at_u_locations"].data)
        s = np.asarray(st["air_isentropic_density"].data)
        qv = np.asarray(st["mass_fraction_of_water_vapor_in_air"].data)
        results[coupling] = {
            "umax": float(u.max()),
            "umean": float(u.mean()),
            "smean": float(s.mean()),
            "qv_path": float((s * qv).sum()),
        }
    return results


def test_all_variants_finite_and_close(trajectories):
    ref = trajectories["sus"]
    for coupling, stats in trajectories.items():
        for k, v in stats.items():
            assert np.isfinite(v), (coupling, k)
        # splitting strategies agree on the flow statistics to O(dt)
        assert abs(stats["umax"] - ref["umax"]) < 0.05 * abs(ref["umax"]), coupling
        assert abs(stats["umean"] - ref["umean"]) < 0.02 * abs(ref["umean"]), coupling
        assert abs(stats["smean"] - ref["smean"]) < 0.01 * abs(ref["smean"]), coupling


def test_water_mass_consistency(trajectories):
    """Total vapor path must agree across variants (microphysics ordering
    differs, conservation properties must not)."""
    paths = [t["qv_path"] for t in trajectories.values()]
    assert max(paths) - min(paths) < 0.02 * abs(np.mean(paths))
