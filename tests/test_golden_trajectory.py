"""Golden-trajectory regression: the flagship run is frozen on disk.

The committed ``tests/baseline_datasets/isentropic_golden.h5`` (float64, full
SUS chain, 33x33x16, 50 steps — see tests/make_golden.py) plays the role of
the reference's baseline NetCDF dataset (``tests/baseline_datasets/
isentropic.nc``, loaded at reference ``tests/conftest.py:36``): any refactor
that changes the model numerics fails here and must regenerate the golden
deliberately.

Tolerance note: the run recomputes on this machine's XLA build; identical
compilers reproduce bitwise, but a compiler upgrade may legitimately perturb
fusion rounding — hence allclose at 1e-9 relative, far below any physical
change but above compiler jitter.
"""

import numpy as np
import pytest

import make_golden
from tasmania_jax.utils.iox import load_hdf5_dataset

PROGNOSTICS = (
    "air_isentropic_density",
    "x_momentum_isentropic",
    "y_momentum_isentropic",
    "mass_fraction_of_water_vapor_in_air",
    "mass_fraction_of_cloud_liquid_water_in_air",
    "mass_fraction_of_precipitation_water_in_air",
    "x_velocity_at_u_locations",
    "y_velocity_at_v_locations",
)


@pytest.mark.slow
def test_flagship_run_matches_golden():
    if not make_golden.GOLDEN.exists():
        pytest.skip("golden dataset not generated")
    _, _, states = load_hdf5_dataset(str(make_golden.GOLDEN))
    assert len(states) == make_golden.NSTEPS // make_golden.SNAP_EVERY

    _, _, snaps, *_ = make_golden.run(np.float64, make_golden.NSTEPS)
    for idx, istep in enumerate(sorted(snaps)):
        golden = states[idx]
        fresh = snaps[istep]
        for name in PROGNOSTICS:
            g = np.asarray(golden[name].data)
            f = fresh[name]
            scale = np.max(np.abs(g)) or 1.0
            np.testing.assert_allclose(
                f / scale, g / scale, atol=1e-9,
                err_msg=f"{name} at step {istep}",
            )
