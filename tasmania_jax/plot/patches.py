"""Annotation patches: circles, rectangles, segments, text
(reference ``src/tasmania/plot/patches.py:37-97``)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from tasmania_jax.plot.drawer import Drawer

#: reference make_circle/make_rectangle flat keys -> matplotlib Patch kwargs
_PATCH_KEYS = ("linewidth", "edgecolor", "facecolor", "alpha")


def _patch_kwargs(props) -> dict:
    kw = dict(props.get("patch_kwargs", {}))
    for key in _PATCH_KEYS:
        if key in props:
            kw.setdefault(key, props[key])
    return kw


class Circle(Drawer):
    def __init__(self, center, radius, properties: Optional[Mapping[str, Any]] = None):
        super().__init__(properties)
        self._center, self._radius = center, radius

    def __call__(self, state, fig, ax):
        import matplotlib.patches as mpatches

        ax.add_patch(
            mpatches.Circle(
                self._center, self._radius, **_patch_kwargs(self.properties)
            )
        )


class Rectangle(Drawer):
    def __init__(self, xy, width, height, angle=0.0,
                 properties: Optional[Mapping[str, Any]] = None):
        super().__init__(properties)
        self._xy, self._w, self._h, self._angle = xy, width, height, angle

    def __call__(self, state, fig, ax):
        import matplotlib.patches as mpatches

        ax.add_patch(
            mpatches.Rectangle(
                self._xy, self._w, self._h, angle=self._angle,
                **_patch_kwargs(self.properties)
            )
        )


class Segment(Drawer):
    def __init__(self, x_data: Sequence, y_data: Sequence, properties=None):
        super().__init__(properties)
        self._x, self._y = x_data, y_data

    def __call__(self, state, fig, ax):
        from tasmania_jax.plot.drawers import _line_kwargs

        ax.plot(self._x, self._y, **_line_kwargs(self.properties))


class Annotation(Drawer):
    def __init__(self, text: str, location, properties=None):
        super().__init__(properties)
        self._text, self._loc = text, location

    def __call__(self, state, fig, ax):
        ax.annotate(self._text, self._loc, **self.properties.get("text_kwargs", {}))
