"""Docstring template substitution.

The port's own copy of :mod:`pde_tpu.utils.docstrings`.
"""

from __future__ import annotations

import re
import textwrap
from typing import Callable, TypeVar

DOCSTRING_REPLACEMENTS = {
    "ARG_BOUNDARIES": (
        "Boundary conditions are generally given as a dictionary mapping axes or "
        "sides ('x', 'y-', 'left', '*') to conditions like 'periodic', "
        "{'value': 2}, or {'derivative': 'sin(x)'}; see "
        ":mod:`pde_tpu_torch.grids.boundaries` for the full mini-language."
    ),
    "ARG_TRACKER_INTERRUPT": (
        "Determines when the tracker interrupts the simulation: a number gives "
        "equidistant interrupts in simulation time, a string like '01:00' gives "
        "real-time interrupts, and sequences give explicit time points."
    ),
    "WARNING_EXEC": (
        "This implementation uses :func:`exec`-like expression parsing and "
        "should not be used with untrusted input."
    ),
    "ARG_PLOT_QUANTITIES": (
        "Quantities are specified as a (2d) list of dictionaries, each "
        "defining one panel via the keys 'source' (field index or callable), "
        "'title', 'vmin', and 'vmax'."
    ),
}

TFunc = TypeVar("TFunc", bound=Callable)


def get_text_block(identifier: str) -> str:
    """Return a single text block from the replacement table."""
    return DOCSTRING_REPLACEMENTS[identifier]


def replace_in_docstring(func: TFunc, token: str, value: str, docstring=None) -> TFunc:
    """Replace a token in the docstring of a function."""
    doc = docstring if docstring is not None else func.__doc__ or ""
    func.__doc__ = doc.replace(token, value)
    return func


def fill_in_docstring(func: TFunc) -> TFunc:
    """Replace ``{IDENTIFIER}`` tokens in a docstring by standard text blocks."""
    doc = func.__doc__
    if doc:
        for token, value in DOCSTRING_REPLACEMENTS.items():
            # preserve the indentation of the token's line
            pattern = r"([ \t]*)\{" + token + r"\}"

            def _sub(match, _value=value):
                indent = match.group(1)
                return textwrap.indent(textwrap.fill(_value, 80), indent)

            doc = re.sub(pattern, _sub, doc)
        func.__doc__ = doc
    return func
