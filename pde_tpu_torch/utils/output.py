"""Progress bars and output helpers.

The port's own copy of :mod:`pde_tpu.utils.output`: tqdm and IPython are
imported where they are used, and a plain counter stands in for tqdm where
it is missing.
"""

from __future__ import annotations

import sys
from typing import Any


def in_jupyter_notebook() -> bool:
    """Check whether we are running in a Jupyter notebook."""
    try:
        from IPython import get_ipython

        shell = get_ipython().__class__.__name__
        return shell == "ZMQInteractiveShell"
    except (ImportError, AttributeError, NameError):
        return False


class SimpleProgress:
    """Fallback indicator used when tqdm is unavailable."""

    def __init__(self, iterable=None, total=None, **kwargs):
        self.iterable = iterable
        self.total = total
        self.n = 0

    def __iter__(self):
        yield from self.iterable

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_description(self, msg: str, refresh: bool = True):
        pass

    def update(self, n: int = 1):
        self.n += n

    def refresh(self):
        pass

    def close(self):
        pass


def get_progress_bar_class(fancy: bool = True):
    """Return a class usable as a progress bar."""
    if fancy:
        try:
            from tqdm.auto import tqdm

            return tqdm
        except ImportError:
            pass
    return SimpleProgress


def display_progress(iterator, total=None, enabled: bool = True, **kwargs):
    """Display a progress bar while iterating."""
    if not enabled:
        return iterator
    return get_progress_bar_class()(iterator, total=total, **kwargs)


class BasicOutput:
    """Output handler writing messages to a stream."""

    def __init__(self, stream=sys.stdout):
        self.stream = stream

    def __call__(self, line: str) -> None:
        self.stream.write(line + "\n")

    def show(self) -> None:
        self.stream.flush()


class JupyterOutput:
    """Output handler accumulating lines in a Jupyter output widget."""

    def __init__(self, header: str = "", footer: str = ""):
        self.lines: list[str] = []
        self.header = header
        self.footer = footer

    def __call__(self, line: str) -> None:
        self.lines.append(line)

    def show(self) -> None:
        from IPython.display import clear_output, display_html

        clear_output(wait=True)
        html = "<br>".join([self.header, *self.lines, self.footer])
        display_html(html, raw=True)
