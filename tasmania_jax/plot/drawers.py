"""Concrete drawers: contour(f), quiver, profiles, time series, Hovmöller, CDF.

JAX re-design of reference ``src/tasmania/plot/{contour,contourf,quiver,
profile,trackers,spectrals,offline}.py`` — host-side matplotlib rendering of
numpy-pulled states, backend-agnostic (SURVEY.md §2.7).

Each drawer's ``properties`` dict accepts BOTH the raw matplotlib passthrough
(``line_kwargs`` / ``contourf_kwargs`` / ``quiver_kwargs`` / …) and the
reference's flat keys (``plot_utils.py make_lineplot/make_contourf/
make_contour/make_quiver`` keyword surface): ``linecolor/linestyle/linewidth/
marker*/legend_label``, ``cmap_name/cbar_*``, ``field_bias/field_factor``,
``x_factor/y_factor``, ``alpha/colors``, ``arrow_*/x_step/y_step/
quiverkey_*``.  Flat keys fill in defaults; explicit ``*_kwargs`` win.
"""

from __future__ import annotations

import numpy as np

from tasmania_jax.plot.drawer import Drawer
from tasmania_jax.plot.retrievers import DataRetriever

#: reference make_lineplot keys -> matplotlib Line2D kwargs
_LINE_KEYS = {
    "linecolor": "color",
    "linestyle": "linestyle",
    "linewidth": "linewidth",
    "marker": "marker",
    "markersize": "markersize",
    "markeredgecolor": "markeredgecolor",
    "markeredgewidth": "markeredgewidth",
    "markerfacecolor": "markerfacecolor",
    "legend_label": "label",
}


def _line_kwargs(props) -> dict:
    kw = dict(props.get("line_kwargs", {}))
    for src, dst in _LINE_KEYS.items():
        if src in props:
            kw.setdefault(dst, props[src])
    return kw


def _field_scaled(props, data, prefix: str = "field"):
    """``factor·data + bias`` (reference field_factor/field_bias)."""
    factor = props.get(f"{prefix}_factor", 1.0)
    bias = props.get(f"{prefix}_bias", 0.0)
    return factor * data + bias if (factor != 1.0 or bias != 0.0) else data


def _axis_scaled(props, which: str, coords):
    factor = props.get(f"{which}_factor", 1.0)
    return factor * coords if factor != 1.0 else coords


def _axis_coords(grid, dims: str, field_name: str = ""):
    if dims == "x":
        src = grid.x_at_u_locations if "at_u_locations" in field_name else grid.x
    elif dims == "y":
        src = grid.y_at_v_locations if "at_v_locations" in field_name else grid.y
    else:
        src = (
            grid.z_on_interface_levels
            if "on_interface_levels" in field_name
            else grid.z
        )
    return np.asarray(src.data)


def _add_colorbar(fig, ax, mappable, props) -> None:
    if not props.get("cbar_on", True):
        return
    kwargs = {
        "ax": props.get("cbar_ax", ax),
        "orientation": props.get("cbar_orientation", "vertical"),
    }
    if "cbar_format" in props:
        kwargs["format"] = props["cbar_format"]
    if "cbar_extendfrac" in props:
        kwargs["extendfrac"] = props["cbar_extendfrac"]
    if "cbar_extendrect" in props:
        kwargs["extendrect"] = props["cbar_extendrect"]
    cb = fig.colorbar(mappable, **kwargs)
    if "cbar_title" in props:
        cb.ax.set_title(props["cbar_title"])
    if "cbar_x_label" in props:
        cb.ax.set_xlabel(props["cbar_x_label"])
    if "cbar_y_label" in props:
        cb.ax.set_ylabel(props["cbar_y_label"])
    step = props.get("cbar_ticks_step", None)
    if step and hasattr(cb, "get_ticks"):
        cb.set_ticks(cb.get_ticks()[::step])
    if props.get("cbar_ticks_pos", None) is not None:
        cb.set_ticks(props["cbar_ticks_pos"])


def _draw_vertical_levels(ax, grid, props, yaxis: str) -> None:
    """Thin lines marking the vertical grid levels on (x, z)/(y, z) sections
    (reference make_contour(f) ``draw_vertical_levels``)."""
    if not props.get("draw_vertical_levels", False) or yaxis != "z":
        return
    zf = props.get("y_factor", 1.0)
    for zl in np.asarray(grid.z_on_interface_levels.data):
        ax.axhline(zf * zl, color="gray", linewidth=0.5, alpha=0.7)


def _fill_levels(props, data) -> dict:
    """cmap/levels kwargs from the reference cbar_levels/cbar_center/
    cbar_half_width keys."""
    kw = {}
    if "cmap_name" in props:
        kw["cmap"] = props["cmap_name"]
    levels = props.get("cbar_levels", None)
    center = props.get("cbar_center", None)
    half = props.get("cbar_half_width", None)
    if center is not None and half is not None:
        n = levels if isinstance(levels, int) else 17
        kw["levels"] = np.linspace(center - half, center + half, n)
    elif levels is not None:
        kw["levels"] = levels
    if "cbar_extend" in props:
        kw["extend"] = props["cbar_extend"]
    return kw


class Contour(Drawer):
    """Contour lines of a 2-D slice (reference ``plot/contour.py:37``)."""

    def __init__(self, grid, field_name, field_units=None, x=None, y=None, z=None, xaxis="x", yaxis="y", properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units, x, y, z)
        self._grid, self._xaxis, self._yaxis = grid, xaxis, yaxis
        self._field_name = field_name

    def __call__(self, state, fig, ax):
        p = self.properties
        data = _field_scaled(p, self._retriever(state))
        xc = _axis_scaled(p, "x", _axis_coords(self._grid, self._xaxis, self._field_name))
        yc = _axis_scaled(p, "y", _axis_coords(self._grid, self._yaxis, self._field_name))
        kw = dict(p.get("contour_kwargs", {}))
        for key in ("colors", "alpha"):
            if key in p:
                kw.setdefault(key, p[key])
        cs = ax.contour(xc, yc, data.T, **kw)
        if p.get("clabel", False):
            ax.clabel(cs)
        _draw_vertical_levels(ax, self._grid, p, self._yaxis)


class Contourf(Drawer):
    """Filled contours (reference ``plot/contourf.py:37``)."""

    def __init__(self, grid, field_name, field_units=None, x=None, y=None, z=None, xaxis="x", yaxis="y", properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units, x, y, z)
        self._grid, self._xaxis, self._yaxis = grid, xaxis, yaxis
        self._field_name = field_name

    def __call__(self, state, fig, ax):
        p = self.properties
        data = _field_scaled(p, self._retriever(state))
        xc = _axis_scaled(p, "x", _axis_coords(self._grid, self._xaxis, self._field_name))
        yc = _axis_scaled(p, "y", _axis_coords(self._grid, self._yaxis, self._field_name))
        kw = {**_fill_levels(p, data), **p.get("contourf_kwargs", {})}
        cf = ax.contourf(xc, yc, data.T, **kw)
        _add_colorbar(fig, ax, cf, p)
        _draw_vertical_levels(ax, self._grid, p, self._yaxis)


class Quiver(Drawer):
    """Vector field arrows (reference ``plot/quiver.py:37``)."""

    def __init__(self, grid, x_field, y_field, field_units=None, x=None, y=None, z=None, scalar_field=None, scalar_units=None, properties=None):
        super().__init__(properties)
        self._rx = DataRetriever(grid, x_field, field_units, x, y, z)
        self._ry = DataRetriever(grid, y_field, field_units, x, y, z)
        self._rs = (
            DataRetriever(grid, scalar_field, scalar_units, x, y, z)
            if scalar_field is not None
            else None
        )
        self._grid = grid

    def __call__(self, state, fig, ax):
        p = self.properties
        u, v = np.asarray(self._rx(state)), np.asarray(self._ry(state))
        xc = _axis_scaled(p, "x", _axis_coords(self._grid, "x"))
        yc = _axis_scaled(p, "y", _axis_coords(self._grid, "y"))
        sx = p.get("x_step", 1)
        sy = p.get("y_step", 1)
        kw = dict(p.get("quiver_kwargs", {}))
        for src, dst in (
            ("arrow_scale", "scale"),
            ("arrow_scale_units", "scale_units"),
            ("arrow_headwidth", "headwidth"),
            ("cmap_name", "cmap"),
        ):
            if src in p:
                kw.setdefault(dst, p[src])
        args = [xc[::sx], yc[::sy], u[::sx, ::sy].T, v[::sx, ::sy].T]
        if self._rs is not None:
            scalar = _field_scaled(p, np.asarray(self._rs(state)), "scalar")
            args.append(scalar[::sx, ::sy].T)
        q = ax.quiver(*args, **kw)
        if self._rs is not None and p.get("cbar_on", False):
            _add_colorbar(fig, ax, q, p)
        if p.get("quiverkey_on", False):
            qk_kwargs = {
                "labelpos": p.get("quiverkey_label_loc", "E"),
                "color": p.get("quiverkey_color", None),
            }
            if "quiverkey_fontproperties" in p:
                qk_kwargs["fontproperties"] = p["quiverkey_fontproperties"]
            ax.quiverkey(
                q,
                *p.get("quiverkey_loc", (0.85, 1.03)),
                p.get("quiverkey_length", 1.0),
                p.get("quiverkey_label", ""),
                **qk_kwargs,
            )


class LineProfile(Drawer):
    """1-D profile along an axis (reference ``plot/profile.py:37``)."""

    def __init__(self, grid, field_name, field_units=None, x=None, y=None, z=None, axis="x", properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units, x, y, z)
        self._grid, self._axis = grid, axis
        self._field_name = field_name

    def __call__(self, state, fig, ax):
        p = self.properties
        data = _field_scaled(p, self._retriever(state))
        coords = _axis_coords(self._grid, self._axis, self._field_name)
        coords = _axis_scaled(p, "x" if self._axis != "z" else "y", coords)
        kw = _line_kwargs(p)
        if self._axis == "z":
            ax.plot(data, coords[: data.shape[0]], **kw)
        else:
            ax.plot(coords[: data.shape[0]], data, **kw)


class TimeSeries(Drawer):
    """Scalar trace over successive states (reference ``plot/trackers.py:38``)."""

    def __init__(self, grid, field_name, field_units=None, x=None, y=None, z=None, properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units, x, y, z)
        self._times, self._values = [], []

    def __call__(self, state, fig, ax):
        p = self.properties
        self._times.append(state.get("time"))
        self._values.append(
            float(np.asarray(_field_scaled(p, self._retriever(state))))
        )
        ax.plot(self._times, self._values, **_line_kwargs(p))


class HovmollerDiagram(Drawer):
    """Space–time diagram accumulated over calls (reference ``plot/trackers.py:142``)."""

    def __init__(self, grid, field_name, field_units=None, x=None, y=None, z=None, axis="x", properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units, x, y, z)
        self._grid, self._axis = grid, axis
        self._field_name = field_name
        self._slices, self._times = [], []

    def __call__(self, state, fig, ax):
        p = self.properties
        self._slices.append(
            np.asarray(_field_scaled(p, self._retriever(state))).ravel()
        )
        self._times.append(state.get("time"))
        data = np.stack(self._slices, axis=1)
        coords = _axis_coords(self._grid, self._axis, self._field_name)
        kw = dict(p.get("pcolormesh_kwargs", {}))
        if "cmap_name" in p:
            kw.setdefault("cmap", p["cmap_name"])
        cf = ax.pcolormesh(
            np.arange(len(self._times)),
            coords[: data.shape[0]],
            data,
            **kw,
        )
        if p.get("cbar_on", False):
            _add_colorbar(fig, ax, cf, p)


class CDF(Drawer):
    """Empirical cumulative distribution of a field
    (reference ``plot/spectrals.py:36``)."""

    def __init__(self, grid, field_name, field_units=None, properties=None):
        super().__init__(properties)
        self._retriever = DataRetriever(grid, field_name, field_units)

    def __call__(self, state, fig, ax):
        p = self.properties
        vals = np.sort(
            np.asarray(_field_scaled(p, self._retriever(state))).ravel()
        )
        cdf = np.arange(1, vals.size + 1) / vals.size
        ax.plot(vals, cdf, **_line_kwargs(p))


class Line(Drawer):
    """Plot precomputed (x, y) data — offline drawer
    (reference ``plot/offline.py:36``)."""

    def __init__(self, x_data, y_data, properties=None):
        super().__init__(properties)
        self._x, self._y = np.asarray(x_data), np.asarray(y_data)

    def __call__(self, state, fig, ax):
        p = self.properties
        ax.plot(
            _axis_scaled(p, "x", self._x),
            _axis_scaled(p, "y", self._y),
            **_line_kwargs(p),
        )
