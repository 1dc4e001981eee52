"""Plot-package smoke tests (render to Agg buffers, no golden images)."""

import os
import tempfile
from datetime import datetime

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from tasmania_jax.domain import Domain
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.isentropic import get_isentropic_state_from_brunt_vaisala_frequency
from tasmania_jax.plot import (
    CDF,
    Contour,
    Contourf,
    HovmollerDiagram,
    LineProfile,
    Plot,
    PlotComposite,
    Quiver,
    TimeSeries,
)


@pytest.fixture(scope="module")
def setup():
    domain = Domain(
        (0.0, 1e5), 12, (0.0, 1e5), 10,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 6,
        horizontal_boundary_type="identity", nb=1,
    )
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid, datetime(2000, 1, 1),
        FieldArray(np.asarray(10.0), "m s^-1", ()),
        FieldArray(np.asarray(3.0), "m s^-1", ()),
        FieldArray(np.asarray(0.01), "s^-1", ()),
    )
    return domain.numerical_grid, state


def test_contourf_plot(setup):
    grid, state = setup
    drawer = Contourf(grid, "air_isentropic_density", "kg m^-2 K^-1", z=slice(5, 6))
    monitor = Plot(drawer, axes_properties={"title": "s", "x_label": "x"})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.png")
        monitor.store(state, save_dest=path)
        assert os.path.getsize(path) > 1000


def test_contour_and_profile(setup):
    grid, state = setup
    c = Contour(grid, "montgomery_potential", "m^2 s^-2", z=slice(0, 1))
    lp = LineProfile(grid, "air_isentropic_density", "kg m^-2 K^-1",
                     x=slice(5, 6), y=slice(5, 6), axis="z")
    Plot(c).store(state)
    Plot(lp).store(state)


def test_quiver(setup):
    grid, state = setup
    q = Quiver(grid, "x_momentum_isentropic", "y_momentum_isentropic",
               "kg m^-1 K^-1 s^-1", z=slice(3, 4))
    Plot(q).store(state)


def test_trackers_and_composite(setup):
    grid, state = setup
    ts = TimeSeries(grid, "air_isentropic_density", "kg m^-2 K^-1",
                    x=slice(5, 6), y=slice(5, 6), z=slice(5, 6))
    hov = HovmollerDiagram(grid, "air_isentropic_density", "kg m^-2 K^-1",
                           y=slice(5, 6), z=slice(5, 6), axis="x")
    cdf = CDF(grid, "air_isentropic_density", "kg m^-2 K^-1")
    p1, p2, p3 = Plot(ts), Plot(hov), Plot(cdf)
    for _ in range(3):
        comp = PlotComposite(p1, p2, p3, nrows=1, ncols=3)
        comp.store([state, state, state])
