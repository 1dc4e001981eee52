"""Plot monitors: one-axes and composite figures
(reference ``src/tasmania/plot/monitors.py:60,288``).

``figure_properties`` / ``axes_properties`` go through the full property
engine (``plot/properties.py``, the reference's ``plot_utils.py:216,378``
keyword surface)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from tasmania_jax.plot.properties import (
    set_axes_properties,
    set_figure_properties,
)


class Plot:
    """Monitor rendering a list of drawers onto one axes
    (reference ``monitors.py:60``)."""

    def __init__(
        self,
        *drawers,
        interactive: bool = False,
        figure_properties: Optional[Mapping[str, Any]] = None,
        axes_properties: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self._drawers = drawers
        self._interactive = interactive
        self.figure_properties = dict(figure_properties or {})
        self.axes_properties = dict(axes_properties or {})

    @property
    def drawers(self):
        return self._drawers

    def store(self, state, fig=None, ax=None, save_dest: Optional[str] = None, show: bool = False):
        import matplotlib

        if not self._interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if fig is None or ax is None:
            fig, ax = plt.subplots(
                figsize=self.figure_properties.get("figsize", (7, 7))
            )
        for drawer in self._drawers:
            drawer(state, fig, ax)
        set_axes_properties(ax, self.axes_properties)
        set_figure_properties(fig, self.figure_properties)
        if save_dest:
            fig.savefig(save_dest, dpi=self.figure_properties.get("dpi", 100))
        if show and self._interactive:
            plt.show()
        return fig, ax


class PlotComposite:
    """Monitor with a grid of subplots, one Plot each
    (reference ``monitors.py:288``)."""

    def __init__(
        self,
        *artists: Plot,
        nrows: int = 1,
        ncols: int = 1,
        interactive: bool = False,
        figure_properties: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self._artists = artists
        self._nrows, self._ncols = nrows, ncols
        self._interactive = interactive
        self.figure_properties = dict(figure_properties or {})

    @property
    def artists(self):
        return self._artists

    def store(self, states: Sequence, save_dest: Optional[str] = None, show: bool = False):
        import matplotlib

        if not self._interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(
            self._nrows,
            self._ncols,
            figsize=self.figure_properties.get("figsize", (12, 7)),
        )
        axes_flat = getattr(axes, "flat", [axes])
        for artist, ax, state in zip(self._artists, axes_flat, states):
            artist.store(state, fig=fig, ax=ax)
        set_figure_properties(fig, self.figure_properties)
        if save_dest:
            fig.savefig(save_dest, dpi=self.figure_properties.get("dpi", 100))
        if show and self._interactive:
            plt.show()
        return fig, axes
