"""Plotting infrastructure: live-updating plots, decorators, and contexts.

The port's own copy of :mod:`pde_tpu.utils.plotting`, after py-pde's
``tools/plotting.py``: :class:`PlotReference` records what a plot method drew
so trackers can update artists in place instead of re-creating figures;
:func:`plot_on_axes` / :func:`plot_on_figure` wrap raw plotting methods with
the standard argument handling (ax/fig creation, title, filename, action);
plotting contexts manage figure reuse and interactive redraws inside loops.
matplotlib, IPython and napari are imported where they are used, so the
package imports without them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any


class PlotReference:
    """Reference to a plotted element, allowing in-place updates.

    Attributes:
        ax: the matplotlib axes the element lives on
        element: the matplotlib artist (Line2D, AxesImage, Quiver, ...)
        parameters: the keyword arguments the plot was created with
    """

    __slots__ = ["ax", "element", "parameters"]

    def __init__(self, ax, element: Any, parameters: dict[str, Any] | None = None):
        self.ax = ax
        self.element = element
        self.parameters = {} if parameters is None else parameters


def plot_on_axes(wrapped=None, update_method: str | None = None):
    """Decorator for plot methods of signature ``method(self, ax, **kwargs)``.

    The wrapped method must return a :class:`PlotReference` (or a raw artist,
    which gets wrapped). The decorated method gains the standard arguments
    ``title``, ``filename``, ``action`` ("create"/"update"), ``ax_style``,
    and ``fig_style``; with ``action="update"`` and a reference passed as
    ``ax``, the named ``update_method`` is invoked instead of redrawing.
    """

    def decorator(method):
        @functools.wraps(method)
        def wrapper(self, *args, title=None, filename=None, action="create",
                    ax_style=None, fig_style=None, ax=None, **kwargs):
            import matplotlib.pyplot as plt

            if action == "update":
                if not isinstance(ax, PlotReference):
                    raise TypeError("action='update' requires a PlotReference")
                if update_method is None:
                    raise NotImplementedError(
                        f"{method.__name__} does not support updates"
                    )
                getattr(self, update_method)(ax)
                return ax
            if ax is None:
                _, ax = plt.subplots()
            reference = method(self, *args, ax=ax, **kwargs)
            if not isinstance(reference, PlotReference):
                reference = PlotReference(ax, reference, kwargs)
            if title:
                reference.ax.set_title(title)
            if ax_style:
                reference.ax.set(**ax_style)
            if fig_style:
                reference.ax.figure.set(**fig_style)
            if filename:
                reference.ax.figure.savefig(filename)
            return reference

        wrapper.mpl_class = "axes"
        return wrapper

    if wrapped is None:
        return decorator
    return decorator(wrapped)


def plot_on_figure(wrapped=None, update_method: str | None = None):
    """Decorator for plot methods of signature ``method(self, fig, **kwargs)``.

    The figure-level analogue of :func:`plot_on_axes` for multi-panel plots.
    """

    def decorator(method):
        @functools.wraps(method)
        def wrapper(self, *args, title=None, filename=None, action="create",
                    fig_style=None, fig=None, **kwargs):
            import matplotlib.pyplot as plt

            if action == "update":
                if not isinstance(fig, PlotReference):
                    raise TypeError("action='update' requires a PlotReference")
                if update_method is None:
                    raise NotImplementedError(
                        f"{method.__name__} does not support updates"
                    )
                getattr(self, update_method)(fig)
                return fig
            if fig is None:
                fig = plt.figure()
            reference = method(self, *args, fig=fig, **kwargs)
            if not isinstance(reference, PlotReference):
                reference = PlotReference(None, reference, kwargs)
            if title:
                fig.suptitle(title)
            if fig_style:
                fig.set(**fig_style)
            if filename:
                fig.savefig(filename)
            return reference

        wrapper.mpl_class = "figure"
        return wrapper

    if wrapped is None:
        return decorator
    return decorator(wrapped)


class PlottingContextBase:
    """Context manager managing a matplotlib figure across repeated plots.

    Entering the context prepares the (reused) figure; exiting triggers the
    environment-appropriate refresh.
    """

    supports_update = True

    def __init__(self, title: str | None = None, show: bool = True):
        self.title = title
        self.show = show
        self.initial_plot = True
        self.fig = None
        self._title_obj = None

    def __enter__(self):
        import matplotlib.pyplot as plt

        if self.fig is not None:
            plt.figure(self.fig.number)  # reactivate the existing figure
        return self

    def __exit__(self, *exc):
        import matplotlib.pyplot as plt

        if self.initial_plot or not self.supports_update:
            self.fig = plt.gcf()
            if self.title is not None:
                self._title_obj = self.fig.suptitle(self.title)
            self.initial_plot = False
        if self.show:
            try:
                self.fig.canvas.draw_idle()
                plt.pause(1e-3)
            except Exception:  # headless backends may not support pause
                pass

    def close(self):
        import matplotlib.pyplot as plt

        if self.fig is not None:
            plt.close(self.fig)
            self.fig = None


class BasicPlottingContext(PlottingContextBase):
    """Plotting context for scripts / interactive python."""


class JupyterPlottingContext(PlottingContextBase):
    """Plotting context for Jupyter notebooks: clears and re-displays the
    output cell per update."""

    supports_update = False

    def __exit__(self, *exc):
        import matplotlib.pyplot as plt

        try:
            from IPython.display import clear_output, display

            clear_output(wait=True)
            self.fig = plt.gcf()
            if self.title is not None:
                self.fig.suptitle(self.title)
            if self.show:
                display(self.fig)
        except ImportError:
            super().__exit__(*exc)

    def close(self):
        super().close()


def in_jupyter_notebook() -> bool:
    """Detect a Jupyter (ZMQ) kernel."""
    try:
        from IPython import get_ipython

        shell = get_ipython()
        return shell is not None and type(shell).__name__ == "ZMQInteractiveShell"
    except ImportError:
        return False


def get_plotting_context(
    context=None, title: str | None = None, show: bool = True
) -> PlottingContextBase:
    """Return a plotting context suitable for the current environment."""
    if isinstance(context, PlottingContextBase):
        context.title = title if title is not None else context.title
        context.show = show
        return context
    if context is not None:
        raise TypeError(f"Unknown plotting context `{context}`")
    if in_jupyter_notebook():
        return JupyterPlottingContext(title=title, show=show)
    return BasicPlottingContext(title=title, show=show)


@contextlib.contextmanager
def napari_viewer(grid, run: bool | None = None, close: bool = False, **kwargs):
    """Context manager yielding a napari viewer set up for `grid` (napari is
    an optional dependency)."""
    try:
        import napari
    except ImportError as err:
        raise ImportError("napari_viewer requires the optional `napari` package") from err

    kwargs.setdefault("axis_labels", list(grid.axes))
    kwargs.setdefault("ndisplay", 3 if grid.num_axes >= 3 else 2)
    viewer = napari.Viewer(**kwargs)
    yield viewer
    if run is None:
        run = not in_jupyter_notebook()
    if run:
        napari.run()
    # `close=True` is accepted for API compatibility; napari closing is
    # unreliable, and py-pde does not close it either.
