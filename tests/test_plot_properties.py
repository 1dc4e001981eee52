"""Property-engine coverage (plot/properties.py — the reference's
``plot_utils.py:216,378`` keyword surface)."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

from tasmania_jax.plot.properties import (
    set_axes_properties,
    set_figure_properties,
)


@pytest.fixture
def figax():
    fig, ax = plt.subplots()
    yield fig, ax
    plt.close(fig)


def test_titles_labels_limits(figax):
    fig, ax = figax
    set_axes_properties(
        ax,
        {
            "title_left": "L",
            "title_right": "R",
            "x_label": "xx",
            "y_label": "yy",
            "x_lim": (0.0, 2.0),
            "y_lim": (-1.0, 1.0),
            "fontsize": 9,
        },
    )
    assert ax.get_title(loc="left") == "L"
    assert ax.get_title(loc="right") == "R"
    assert ax.get_xlabel() == "xx" and ax.get_ylabel() == "yy"
    assert ax.get_xlim() == (0.0, 2.0)
    assert ax.get_ylim() == (-1.0, 1.0)
    assert ax.xaxis.label.get_fontsize() == 9


def test_scales_ticks_formats(figax):
    fig, ax = figax
    ax.plot([1, 10, 100], [1, 2, 3])
    set_axes_properties(
        ax,
        {
            "x_scale": "log",
            "y_ticks": [1.0, 2.0, 3.0],
            "y_ticklabels": ["a", "b", "c"],
            "y_ticklabels_rotation": 45.0,
            "x_tickformat": "%.2f",
            "invert_yaxis": True,
            "grid_on": True,
            "grid_properties": {"linestyle": ":"},
        },
    )
    assert ax.get_xscale() == "log"
    assert [t.get_text() for t in ax.get_yticklabels()] == ["a", "b", "c"]
    assert ax.get_yticklabels()[0].get_rotation() == 45.0
    lo, hi = ax.get_ylim()
    assert lo > hi  # inverted


def test_axis_visibility_and_colors(figax):
    fig, ax = figax
    set_axes_properties(
        ax,
        {
            "x_label": "x",
            "x_labelcolor": "red",
            "y_ticklabels_color": "blue",
            "yaxis_visible": False,
        },
    )
    assert ax.xaxis.label.get_color() == "red"
    assert not ax.yaxis.get_visible()


def test_legend_and_text(figax):
    fig, ax = figax
    ax.plot([0, 1], [0, 1], label="series")
    set_axes_properties(
        ax,
        {
            "legend_on": True,
            "legend_loc": "upper left",
            "legend_ncol": 2,
            "text": "note",
            "text_loc": "lower right",
        },
    )
    assert ax.get_legend() is not None
    texts = [a for a in ax.artists]
    assert len(texts) == 1


def test_twin_axes(figax):
    fig, ax = figax
    set_axes_properties(
        ax,
        {
            "y2_label": "twin-y",
            "y2_lim": (0.0, 5.0),
            "x2_ticks": [0.0, 0.5, 1.0],
        },
    )
    twins = [a for a in fig.get_axes() if a is not ax]
    assert len(twins) == 2
    labels = {a.get_ylabel() for a in twins}
    assert "twin-y" in labels


def test_figure_properties():
    fig, axes = plt.subplots(1, 2)
    axes[0].plot([0, 1], [0, 1], label="s1")
    set_figure_properties(
        fig,
        {
            "suptitle": "SUP",
            "x_label": "shared-x",
            "tight_layout": True,
            "subplots_adjust_hspace": 0.4,
            "figlegend_on": True,
            "figlegend_loc": "lower center",
        },
    )
    assert fig._suptitle.get_text() == "SUP"
    assert len(fig.legends) == 1
    plt.close(fig)


def test_empty_properties_are_noop(figax):
    fig, ax = figax
    before = (ax.get_title(), ax.get_xlabel(), ax.get_xlim())
    set_axes_properties(ax, None)
    set_figure_properties(fig, {})
    assert (ax.get_title(), ax.get_xlabel(), ax.get_xlim()) == before


def test_unknown_keys_ignored(figax):
    fig, ax = figax
    set_axes_properties(ax, {"no_such_property": 1, "title": "T"})
    assert ax.get_title() == "T"


def test_monitor_routes_properties():
    """Plot.store applies both dicts through the engine."""
    from tasmania_jax.plot.monitors import Plot

    class _Line:
        properties = {}

        def __call__(self, state, fig, ax):
            ax.plot(state["x"], state["y"], label="l")

    mon = Plot(
        _Line(),
        figure_properties={"figsize": (4, 3), "tight_layout": True},
        axes_properties={"title": "T", "x_label": "X", "grid_on": True},
    )
    fig, ax = mon.store({"x": np.arange(4), "y": np.arange(4)})
    assert ax.get_title() == "T" and ax.get_xlabel() == "X"
    plt.close(fig)


# --------------------------------------------------------------------------- #
# drawer flat-property translation (reference make_lineplot/make_contourf      #
# keyword surface)                                                             #
# --------------------------------------------------------------------------- #


def _tiny_grid():
    from tasmania_jax.domain import Domain
    from tasmania_jax.framework.field import FieldArray

    domain = Domain(
        (0.0, 1e4),
        8,
        (0.0, 1e4),
        6,
        FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
        3,
        horizontal_boundary_type="identity",
        nb=1,
    )
    return domain.numerical_grid


def test_lineprofile_flat_keys(figax):
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import LineProfile

    fig, ax = figax
    grid = _tiny_grid()
    state = {
        "phi": FieldArray(
            np.arange(8.0 * 6 * 3).reshape(8, 6, 3), "m", ("x", "y", "z")
        )
    }
    d = LineProfile(
        grid, "phi", "m", y=0, z=0,
        properties={
            "linecolor": "red", "linestyle": "--", "linewidth": 2.0,
            "legend_label": "prof", "field_factor": 2.0, "field_bias": 1.0,
        },
    )
    d(state, fig, ax)
    (line,) = ax.get_lines()
    assert line.get_color() == "red"
    assert line.get_label() == "prof"
    np.testing.assert_allclose(
        line.get_ydata(), 2.0 * np.asarray(state["phi"].data)[:, 0, 0] + 1.0
    )


def test_contourf_flat_keys(figax):
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import Contourf

    fig, ax = figax
    grid = _tiny_grid()
    rng = np.random.default_rng(0)
    state = {
        "phi": FieldArray(rng.uniform(0, 1, (8, 6, 3)), "m", ("x", "y", "z"))
    }
    d = Contourf(
        grid, "phi", "m", z=0,
        properties={
            "cmap_name": "viridis",
            "cbar_levels": 9,
            "cbar_center": 0.5,
            "cbar_half_width": 0.5,
            "cbar_orientation": "horizontal",
            "cbar_title": "phi",
        },
    )
    d(state, fig, ax)
    # a colorbar axes was added
    assert len(fig.get_axes()) == 2


def test_quiver_flat_keys(figax):
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import Quiver

    fig, ax = figax
    grid = _tiny_grid()
    ones = np.ones((8, 6, 3))
    state = {
        "u": FieldArray(ones, "m s^-1", ("x", "y", "z")),
        "v": FieldArray(ones, "m s^-1", ("x", "y", "z")),
    }
    d = Quiver(
        grid, "u", "v", "m s^-1", z=0,
        properties={
            "x_step": 2, "y_step": 2, "arrow_scale": 10.0,
            "quiverkey_on": True, "quiverkey_label": "1 m/s",
        },
    )
    d(state, fig, ax)


def test_quiver_scalar_coloring_and_cbar(figax):
    """Reference make_quiver: optional scalar colors the arrows and drives a
    colorbar (``plot_utils.py`` scalar/scalar_bias/scalar_factor/cbar_*)."""
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import Quiver

    fig, ax = figax
    grid = _tiny_grid()
    ones = np.ones((8, 6, 3))
    rng = np.random.default_rng(1)
    state = {
        "u": FieldArray(ones, "m s^-1", ("x", "y", "z")),
        "v": FieldArray(ones, "m s^-1", ("x", "y", "z")),
        "T": FieldArray(rng.uniform(250, 300, (8, 6, 3)), "K", ("x", "y", "z")),
    }
    d = Quiver(
        grid, "u", "v", "m s^-1", z=0, scalar_field="T", scalar_units="K",
        properties={
            "scalar_factor": 2.0, "cbar_on": True, "cmap_name": "plasma",
            "quiverkey_on": True, "quiverkey_label": "1 m/s",
            "quiverkey_fontproperties": {"size": 8},
        },
    )
    d(state, fig, ax)
    assert len(fig.get_axes()) == 2  # colorbar attached


def test_draw_vertical_levels(figax):
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import Contourf

    fig, ax = figax
    grid = _tiny_grid()
    rng = np.random.default_rng(0)
    state = {
        "phi": FieldArray(rng.uniform(0, 1, (8, 6, 3)), "m", ("x", "y", "z"))
    }
    d = Contourf(
        grid, "phi", "m", y=0, xaxis="x", yaxis="z",
        properties={"cbar_on": False, "draw_vertical_levels": True},
    )
    d(state, fig, ax)
    nzl = len(np.asarray(grid.z_on_interface_levels.data))
    assert len(ax.get_lines()) >= nzl  # one axhline per interface level


def test_patch_flat_keys(figax):
    from tasmania_jax.plot.patches import Circle, Rectangle

    fig, ax = figax
    Circle((0.5, 0.5), 0.2, properties={"edgecolor": "red", "linewidth": 3})(
        {}, fig, ax
    )
    Rectangle((0.0, 0.0), 1.0, 0.5, angle=15.0,
              properties={"facecolor": "blue"})({}, fig, ax)
    pc, pr = ax.patches
    assert pc.get_edgecolor()[0] == 1.0 and pc.get_linewidth() == 3
    assert pr.get_facecolor()[2] == 1.0
    assert pr.angle == 15.0


def test_figure_reference_aliases():
    """xlabel/ylabel and subplots_adjust_vspace spellings from the reference
    ``set_figure_properties`` docstring are honored."""
    fig, _ = plt.subplots()
    try:
        set_figure_properties(
            fig,
            {
                "xlabel": "XX",
                "ylabel": "YY",
                "subplots_adjust_vspace": 0.42,
            },
        )
        assert fig.get_supxlabel() == "XX"
        assert fig.get_supylabel() == "YY"
        assert abs(fig.subplotpars.wspace - 0.42) < 1e-12
    finally:
        plt.close(fig)


def test_cbar_ticks_pos(figax):
    from tasmania_jax.framework.field import FieldArray
    from tasmania_jax.plot.drawers import Contourf

    fig, ax = figax
    grid = _tiny_grid()
    rng = np.random.default_rng(0)
    state = {
        "phi": FieldArray(rng.uniform(0, 1, (8, 6, 3)), "m", ("x", "y", "z"))
    }
    d = Contourf(
        grid, "phi", "m", z=0,
        properties={"cbar_ticks_pos": [0.25, 0.5, 0.75]},
    )
    d(state, fig, ax)
    cax = fig.get_axes()[1]
    ticks = [t for t in cax.get_yticks() if 0 <= t <= 1]
    np.testing.assert_allclose(ticks, [0.25, 0.5, 0.75])
