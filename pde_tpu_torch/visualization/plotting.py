"""Plotting of simulation results: kymographs, magnitudes, panel animations.

The port's own copy of :mod:`pde_tpu.visualization.plotting`. Stored frames
are host arrays already; a field on the card is copied to the host once where
it is drawn. matplotlib and napari are imported where they are used.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..fields.base import FieldBase
from ..fields.collection import FieldCollection
from ..fields.datafield_base import DataFieldBase


class ScalarFieldPlot:
    """Manages a grid of panels plotting (transformed) scalar fields.
    """

    def __init__(self, field: FieldBase, quantities=None, scale="automatic",
                 fig=None, title: str | None = None, tight: bool = False,
                 show: bool = True):
        import matplotlib.pyplot as plt

        self.quantities = self._prepare_quantities(field, quantities)
        self.scale = scale
        self.show = show
        num_rows = len(self.quantities)
        num_cols = max(len(row) for row in self.quantities)
        if fig is None:
            fig, axes = plt.subplots(
                num_rows, num_cols, squeeze=False, figsize=(4 * num_cols, 3.5 * num_rows)
            )
        else:
            axes = np.array(fig.axes).reshape(num_rows, num_cols)
        self.fig = fig
        self.axes = axes
        if title:
            self.fig.suptitle(title)
        self._images = None
        if tight:
            self.fig.tight_layout()

    @staticmethod
    def _prepare_quantities(field, quantities):
        if quantities is None:
            if isinstance(field, FieldCollection):
                return [[{"source": i} for i in range(len(field))]]
            return [[{"source": None}]]
        if isinstance(quantities, dict):
            return [[quantities]]
        if quantities and isinstance(quantities[0], dict):
            return [quantities]
        return quantities

    def _get_field(self, field, source):
        if source is None:
            data_field = field
        elif callable(source):
            data_field = source(field)
        else:
            data_field = field[source]
        return data_field

    def update(self, field: FieldBase, title: str | None = None) -> None:
        """Redraw all panels from the given state."""
        for row, quantity_row in enumerate(self.quantities):
            for col, quantity in enumerate(quantity_row):
                ax = self.axes[row][col]
                ax.clear()
                data_field = self._get_field(field, quantity.get("source"))
                kwargs: dict[str, Any] = {}
                if "vmin" in quantity:
                    kwargs["vmin"] = quantity["vmin"]
                if "vmax" in quantity:
                    kwargs["vmax"] = quantity["vmax"]
                data_field.plot(ax=ax, colorbar=False, **kwargs) if data_field.grid.num_axes > 1 else data_field.plot(ax=ax)
                if quantity.get("title"):
                    ax.set_title(quantity["title"])
        if title:
            self.fig.suptitle(title)
        if self.show:
            import matplotlib.pyplot as plt

            plt.pause(0.001)

    def savefig(self, path: str, **kwargs):
        self.fig.savefig(path, **kwargs)

    def make_movie(self, storage, filename: str, progress: bool = True) -> None:
        from .movies import Movie

        with Movie(filename) as writer:
            for t, field in storage.items():
                self.update(field, title=f"Time: {t:g}")
                writer.add_figure(self.fig)


def extract_field(fields, source=None, check_rank=None):
    """Extract a single field from a state."""
    if source is None:
        field = fields
    elif callable(source):
        field = source(fields)
    else:
        field = fields[source]
    if check_rank is not None and getattr(field, "rank", None) != check_rank:
        raise RuntimeError(f"Field has rank {field.rank}, expected {check_rank}")
    return field


def plot_magnitudes(storage, quantities=None, *, ax=None, **kwargs):
    """Plot the time evolution of field magnitudes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    times = np.asarray(storage.times)
    first = storage[0]
    if isinstance(first, FieldCollection):
        labels = [f.label or f"field {i}" for i, f in enumerate(first)]
        series = {i: [] for i in range(len(first))}
        for _, state in storage.items():
            for i, f in enumerate(state):
                series[i].append(float(f.magnitude))
        lines = []
        for i, label in enumerate(labels):
            (line,) = ax.plot(times, series[i], label=label, **kwargs)
            lines.append(line)
        ax.legend()
    else:
        values = [float(state.magnitude) for state in storage]
        (lines,) = ax.plot(times, values, **kwargs)
    ax.set_xlabel("Time")
    ax.set_ylabel("Magnitude")
    return lines


def plot_kymograph(storage, field_index=None, *, colorbar: bool = True,
                   extract: str = "auto", ax=None, scalar: str = "auto",
                   transpose: bool = False, **kwargs):
    """Plot a single kymograph (space-time plot) from stored 1d fields.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    rows = []
    for _, field in storage.items():
        if field_index is not None:
            field = field[field_index]
        if isinstance(field, DataFieldBase) and field.rank > 0:
            field = field.to_scalar(scalar)
        line_data = field.get_line_data(extract=extract)
        rows.append(np.real(np.asarray(line_data["data_y"])))
    img = np.array(rows)
    times = np.asarray(storage.times)
    xs = np.asarray(line_data["data_x"])
    if transpose:
        img = img.T
        extent = [times[0], times[-1], xs[0], xs[-1]]
        ax.set_xlabel("Time")
        ax.set_ylabel(line_data.get("label_x", "x"))
    else:
        extent = [xs[0], xs[-1], times[0], times[-1]]
        ax.set_xlabel(line_data.get("label_x", "x"))
        ax.set_ylabel("Time")
    kwargs.setdefault("origin", "lower")
    kwargs.setdefault("aspect", "auto")
    im = ax.imshow(img if not transpose else img, extent=extent, **kwargs)
    if colorbar:
        plt.colorbar(im, ax=ax)
    return im


def plot_kymographs(storage, *, colorbar: bool = True, **kwargs):
    """Plot kymographs of all fields in a collection storage.
    """
    import matplotlib.pyplot as plt

    first = storage[0]
    num = len(first) if isinstance(first, FieldCollection) else 1
    fig, axes = plt.subplots(1, num, squeeze=False, figsize=(5 * num, 4))
    images = []
    for i in range(num):
        idx = i if isinstance(first, FieldCollection) else None
        images.append(
            plot_kymograph(storage, idx, colorbar=colorbar, ax=axes[0][i], **kwargs)
        )
        if idx is not None and first[idx].label:
            axes[0][i].set_title(first[idx].label)
    return images


def plot_interactive(storage, *, viewer_args=None, **kwargs):
    """Visualize stored fields interactively using napari (optional dependency).
    """
    try:
        import napari
    except ImportError as err:
        raise ImportError(
            "plot_interactive requires the optional `napari` package"
        ) from err
    viewer_args = viewer_args or {}
    viewer = napari.Viewer(**viewer_args)
    data = np.stack([field.to_numpy() for field in storage])
    viewer.add_image(data, name=storage[0].label or "field")
    napari.run()
    return viewer
