from tasmania_jax.plot.drawer import Drawer
from tasmania_jax.plot.monitors import Plot, PlotComposite
from tasmania_jax.plot.plot_utils import Animation
from tasmania_jax.plot.patches import Annotation, Circle, Rectangle, Segment
from tasmania_jax.plot.retrievers import DataRetriever, DataRetrieverComposite
from tasmania_jax.plot.drawers import (
    CDF,
    Contour,
    Contourf,
    HovmollerDiagram,
    Line,
    LineProfile,
    Quiver,
    TimeSeries,
)

__all__ = [
    "Drawer",
    "Plot",
    "PlotComposite",
    "Animation",
    "DataRetriever",
    "DataRetrieverComposite",
    "CDF",
    "Contour",
    "Contourf",
    "HovmollerDiagram",
    "Line",
    "LineProfile",
    "Quiver",
    "TimeSeries",
    "Annotation",
    "Circle",
    "Rectangle",
    "Segment",
]
