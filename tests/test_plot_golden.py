"""Golden-image plot tests (the reference's pytest-mpl apparatus:
``tests/pytest.ini:3`` ``--mpl``, ``tests/baseline_images/``).

Each test renders a drawer through the ``Plot`` monitor at fixed
figsize/dpi on the Agg backend and compares the PNG against a committed
baseline by RMS pixel difference (pytest-mpl's metric).  Regenerate after an
intentional visual change with::

    REGEN_BASELINE_IMAGES=1 python -m pytest tests/test_plot_golden.py
"""

import os
from datetime import datetime
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg
import numpy as np
import pytest

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.plot import Contour, Contourf, LineProfile, Plot, Quiver

BASELINE_DIR = Path(__file__).parent / "baseline_images"
RMS_TOL = 5.0  # on the 0-255 scale; fonts/AA wiggle stays well below


@pytest.fixture(scope="module")
def setup():
    nx, ny, nz = 16, 14, 8
    domain = Domain(
        (0.0, 1e5), nx, (0.0, 1e5), ny,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="identity", nb=1,
    )
    x = np.linspace(0, 2 * np.pi, nx)[:, None, None]
    y = np.linspace(0, 2 * np.pi, ny)[None, :, None]
    z = np.linspace(0, 1, nz)[None, None, :]
    state = {
        "time": datetime(2000, 1, 1),
        "air_isentropic_density": FieldArray(
            50.0 + 10.0 * np.sin(x) * np.cos(y) * (1 + z),
            "kg m^-2 K^-1", ("x", "y", "z"),
        ),
        "x_momentum_isentropic": FieldArray(
            100.0 * np.cos(x) * np.ones_like(y) * np.ones_like(z),
            "kg m^-1 K^-1 s^-1", ("x", "y", "z"),
        ),
        "y_momentum_isentropic": FieldArray(
            100.0 * np.sin(y) * np.ones_like(x) * np.ones_like(z),
            "kg m^-1 K^-1 s^-1", ("x", "y", "z"),
        ),
    }
    return domain.numerical_grid, state


def check_golden(monitor, state, name):
    """Render through the monitor; compare (or regenerate) the baseline."""
    baseline = BASELINE_DIR / f"{name}.png"
    BASELINE_DIR.mkdir(exist_ok=True)
    out = baseline if os.environ.get("REGEN_BASELINE_IMAGES") else (
        baseline.parent / f"{name}.result.png"
    )
    monitor.store(state, save_dest=str(out))
    if out == baseline:
        pytest.skip("baseline regenerated")
    assert baseline.exists(), (
        f"missing baseline {baseline}; run with REGEN_BASELINE_IMAGES=1"
    )
    a = mpimg.imread(str(baseline))
    b = mpimg.imread(str(out))
    assert a.shape == b.shape, f"image size changed: {a.shape} vs {b.shape}"
    rms = float(np.sqrt(np.mean((255.0 * (a - b)) ** 2)))
    os.remove(out)
    assert rms <= RMS_TOL, f"{name}: RMS pixel diff {rms:.2f} > {RMS_TOL}"


def _plot(drawer, **axes_properties):
    return Plot(
        drawer,
        interactive=False,
        figure_properties={"figsize": (6, 4), "dpi": 100},
        axes_properties=axes_properties,
    )


def test_golden_contourf(setup):
    grid, state = setup
    d = Contourf(grid, "air_isentropic_density", "kg m^-2 K^-1", z=slice(5, 6))
    check_golden(
        _plot(d, title="s", x_label="x [m]", y_label="y [m]"),
        state,
        "contourf_density",
    )


def test_golden_contour(setup):
    grid, state = setup
    d = Contour(grid, "air_isentropic_density", "kg m^-2 K^-1", z=slice(0, 1))
    check_golden(_plot(d, title="s (top level)"), state, "contour_density")


def test_golden_quiver(setup):
    grid, state = setup
    d = Quiver(
        grid,
        "x_momentum_isentropic",
        "y_momentum_isentropic",
        "kg m^-1 K^-1 s^-1",
        z=slice(3, 4),
    )
    check_golden(_plot(d, title="momentum"), state, "quiver_momentum")


def test_golden_profile(setup):
    grid, state = setup
    d = LineProfile(
        grid,
        "air_isentropic_density",
        "kg m^-2 K^-1",
        x=slice(5, 6),
        y=slice(5, 6),
        axis="z",
    )
    check_golden(_plot(d, title="column profile"), state, "profile_density")
