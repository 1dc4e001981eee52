"""Figure/axes property engine.

Counterpart of reference ``src/tasmania/plot/plot_utils.py:216,378``
(``set_figure_properties`` / ``set_axes_properties``): monitors and drawers
accept plain ``figure_properties`` / ``axes_properties`` dicts whose keys are
applied declaratively here.  The keyword surface mirrors the reference's —
titles, sup/figure titles and legends, per-axis labels/limits/scales/ticks/
tick labels (with colors, rotation, formatters), minor-tick and axis
visibility, axis inversion, grid, legend, free text boxes, and the twin
(``x2``/``y2``) axes — expressed as dispatch tables instead of the
reference's if-chains.

Unknown keys are ignored (same permissive behavior as the reference), so
namelists can carry a superset of properties across drawer types.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional


def _fs(fontsize, delta=0):
    """fontsize kwargs only when explicitly configured — unset keeps
    matplotlib's rcParams defaults (golden-image stability)."""
    return {} if fontsize is None else {"fontsize": fontsize + delta}


def set_figure_properties(fig, props: Optional[Mapping[str, Any]]) -> None:
    """Apply figure-level properties (reference ``plot_utils.py:216``)."""
    p = dict(props or {})
    fontsize = p.get("fontsize", None)

    if "suptitle" in p:
        fig.suptitle(p["suptitle"], **_fs(fontsize, 1))
    # the reference spells these both "xlabel"/"ylabel" (plot_utils.py:216)
    # and "x_label"/"y_label"; accept both
    xl = p.get("x_label", p.get("xlabel", None))
    if xl is not None:
        fig.supxlabel(xl, **_fs(fontsize))
    yl = p.get("y_label", p.get("ylabel", None))
    if yl is not None:
        fig.supylabel(yl, **_fs(fontsize))

    if p.get("tight_layout", False):
        kwargs = {}
        if "tight_layout_rect" in p:
            kwargs["rect"] = p["tight_layout_rect"]
        if "tight_layout_hpad" in p:
            kwargs["h_pad"] = p["tight_layout_hpad"]
        if "tight_layout_wpad" in p:
            kwargs["w_pad"] = p["tight_layout_wpad"]
        fig.tight_layout(**kwargs)

    adjust = {
        key: p[f"subplots_adjust_{key}"]
        for key in ("left", "right", "top", "bottom", "hspace", "wspace")
        if f"subplots_adjust_{key}" in p
    }
    if "subplots_adjust_vspace" in p:  # reference alias for wspace
        adjust.setdefault("wspace", p["subplots_adjust_vspace"])
    if adjust:
        fig.subplots_adjust(**adjust)

    if p.get("figlegend_on", False):
        axes = fig.get_axes()
        if "figlegend_ax" in p and axes:  # reference: take ONE axes' handles
            axes = [axes[min(p["figlegend_ax"], len(axes) - 1)]]
        handles, labels = [], []
        for ax in axes:
            h, l = ax.get_legend_handles_labels()
            handles += h
            labels += l
        fig.legend(
            handles,
            labels,
            loc=p.get("figlegend_loc", "lower center"),
            ncol=p.get("figlegend_ncol", 1),
            framealpha=p.get("figlegend_framealpha", 0.5),
            title=p.get("figlegend_title", None),
        )


def _apply_axis(ax, axis: str, p: Mapping[str, Any], fontsize) -> None:
    """One axis' worth of keys: ``{axis}_label``, ``{axis}_lim``, … for
    axis in {x, y, z} (z only on 3-D axes)."""
    get = lambda k, d=None: p.get(f"{axis}_{k}", d)
    axobj = getattr(ax, f"{axis}axis", None)
    if axobj is None:
        return

    if get("label") is not None:
        getattr(ax, f"set_{axis}label")(
            get("label"),
            color=get("labelcolor", "black"),
            **_fs(fontsize),
        )
    if get("lim") is not None:
        getattr(ax, f"set_{axis}lim")(get("lim"))
    if get("scale") is not None and axis in ("x", "y"):
        getattr(ax, f"set_{axis}scale")(
            get("scale"), **(p.get(f"{axis}_scale_kwargs", None) or {})
        )
    if get("ticks") is not None:
        getattr(ax, f"set_{axis}ticks")(get("ticks"))
    if get("ticklabels") is not None:
        getattr(ax, f"set_{axis}ticklabels")(
            get("ticklabels"), **_fs(fontsize)
        )
    if get("ticklabels_color") is not None:
        ax.tick_params(axis=axis, colors=get("ticklabels_color"))
    if get("ticklabels_rotation") is not None:
        for lbl in getattr(ax, f"get_{axis}ticklabels")():
            lbl.set_rotation(get("ticklabels_rotation"))
    if get("tickformat") is not None:
        import matplotlib.ticker as mticker

        axobj.set_major_formatter(
            mticker.FormatStrFormatter(get("tickformat"))
        )
    if get("tick_length") is not None:
        ax.tick_params(axis=axis, length=get("tick_length"))
    if not p.get(f"{axis}axis_minor_ticks_visible", True):
        axobj.set_tick_params(which="minor", size=0)
    if not p.get(f"{axis}axis_visible", True):
        axobj.set_visible(False)
    if p.get(f"invert_{axis}axis", False):
        getattr(ax, f"invert_{axis}axis")()


def _apply_twin(ax, which: str, p: Mapping[str, Any], fontsize):
    """Twin axes: ``x2_*`` (twiny) / ``y2_*`` (twinx), reference
    ``plot_utils.py`` ax2 handling."""
    keys = [k for k in p if k.startswith(f"{which}2_") or
            k in (f"invert_{which}2axis", f"{which}2axis_visible",
                  f"{which}2axis_minor_ticks_visible")]
    if not keys and not p.get("ax2_on", False):
        return None
    twin = ax.twiny() if which == "x" else ax.twinx()
    q = {}
    for k, v in p.items():
        if k.startswith(f"{which}2_"):
            q[f"{which}_{k[len(which) + 2:]}"] = v
    if f"invert_{which}2axis" in p:
        q[f"invert_{which}axis"] = p[f"invert_{which}2axis"]
    if f"{which}2axis_visible" in p:
        q[f"{which}axis_visible"] = p[f"{which}2axis_visible"]
    _apply_axis(twin, which, q, fontsize)
    return twin


def set_axes_properties(ax, props: Optional[Mapping[str, Any]]) -> None:
    """Apply axes-level properties (reference ``plot_utils.py:378``)."""
    p = dict(props or {})
    fontsize = p.get("fontsize", None)

    # titles (three slots, reference title_center/left/right)
    if "title" in p and "title_center" not in p:
        p["title_center"] = p["title"]
    for loc in ("center", "left", "right"):
        if p.get(f"title_{loc}"):
            ax.set_title(p[f"title_{loc}"], loc=loc, **_fs(fontsize, 1))

    for axis in ("x", "y", "z"):
        _apply_axis(ax, axis, p, fontsize)
    twin = _apply_twin(ax, "x", p, fontsize)
    _apply_twin(ax, "y", p, fontsize)
    if twin is not None:
        for loc in ("center", "left", "right"):
            if p.get(f"ax2_title_{loc}"):
                twin.set_title(p[f"ax2_title_{loc}"], loc=loc,
                               **_fs(fontsize, 1))

    if p.get("grid_on", False):
        ax.grid(True, **(p.get("grid_properties", None) or {}))

    if p.get("legend_on", False):
        kwargs = {
            "loc": p.get("legend_loc", "best"),
            "ncol": p.get("legend_ncol", 1),
            "framealpha": p.get("legend_framealpha", 0.5),
        }
        if p.get("legend_fontsize", fontsize) is not None:
            kwargs["fontsize"] = p.get("legend_fontsize", fontsize)
        if "legend_bbox_to_anchor" in p:
            kwargs["bbox_to_anchor"] = p["legend_bbox_to_anchor"]
        ax.legend(**kwargs)

    if "text" in p:
        import matplotlib.offsetbox as mob

        anchored = mob.AnchoredText(
            p["text"], loc=p.get("text_loc", "upper right"),
            prop=({} if fontsize is None else {"fontsize": fontsize}),
        )
        ax.add_artist(anchored)
