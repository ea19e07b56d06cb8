"""Mathematical expressions parsed by sympy and lowered to PyTorch.

Port of the part of :mod:`pde_tpu.utils.expressions` that :class:`~pde_tpu_torch.PDE`
needs: expressions are parsed once on the host with a guarded sympy namespace
and lowered with ``sympy.lambdify`` to functions of ``torch.Tensor`` data.

Warning:
    Expression parsing ultimately uses :func:`eval`-like mechanisms; do not parse
    expressions from untrusted sources.
"""

from __future__ import annotations

import copy
import math
import numbers
from typing import Any, Callable, Sequence

import numpy as np
import sympy
import torch
from sympy.parsing.sympy_parser import parse_expr, standard_transformations

_BLOCKED_NAMES = {"__builtins__", "eval", "exec", "import", "__import__", "open"}


def parse_expr_guarded(
    expression: str, symbols=None, functions=None, *, indexed: bool = False
) -> sympy.Expr:
    """Parse an expression with a guarded sympy namespace."""
    for bad in _BLOCKED_NAMES:
        if bad in expression:
            raise ValueError(f"Forbidden token `{bad}` in expression")
    local_dict: dict[str, Any] = {}
    for sym_list in symbols or []:
        for name in [sym_list] if isinstance(sym_list, str) else sym_list:
            local_dict[name] = sympy.Symbol(name)
    if indexed:
        local_dict["IndexedBase"] = sympy.IndexedBase
    for name in functions or []:
        local_dict[name] = sympy.Function(name)
    return parse_expr(expression, local_dict=local_dict, transformations=standard_transformations)


def _heaviside_torch(x, *args):
    h0 = args[0] if args else 0.5
    x = torch.as_tensor(x)
    return torch.heaviside(x, torch.as_tensor(h0, dtype=x.dtype, device=x.device))


def _on_tensors(fn: Callable) -> Callable:
    """`fn` taking Python numbers too (as float64 scalars, e.g. the time ``t``);
    a 0-d tensor does not change the dtype of the fields it meets."""

    def wrapped(*args):
        return fn(*(a if isinstance(a, torch.Tensor) else torch.as_tensor(a, dtype=torch.float64)
                    for a in args))

    return wrapped


def _get_torch_modules() -> list[dict[str, Callable]]:
    """Translation table for ``sympy.lambdify`` to ``torch`` ops.

    Only dictionaries are given, so lambdify prints plain function names
    (``sqrt(x)``, ``exp(x)``) and resolves each in this table.
    """
    names = (
        "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
        "acosh", "atanh", "exp", "log", "sqrt", "floor", "ceil", "sign", "abs", "atan2",
        "maximum", "minimum",
    )
    table: dict[str, Any] = {name: _on_tensors(getattr(torch, name)) for name in names}
    table.update({
        "Abs": table["abs"],
        "Max": table["maximum"],
        "Min": table["minimum"],
        "Heaviside": _heaviside_torch,
        "DiracDelta": _on_tensors(torch.zeros_like),
        "conjugate": _on_tensors(torch.conj),
        "im": _on_tensors(torch.imag),
        "re": _on_tensors(torch.real),
        "pi": math.pi,
        "E": math.e,
        "I": 1j,
    })
    return [table]


class ScalarExpression:
    """A scalar-valued mathematical expression."""

    shape: tuple[int, ...] = ()

    def __init__(
        self,
        expression: float | str | sympy.Basic | ScalarExpression = 0,
        signature: Sequence[str | Sequence[str]] | None = None,
        *,
        user_funcs: dict[str, Callable] | None = None,
        consts: dict[str, Any] | None = None,
        explicit_symbols=None,
    ):
        if isinstance(expression, ScalarExpression):
            sympy_expr = copy.copy(expression._sympy_expr)
            signature = signature or expression.vars
            user_funcs = {**expression.user_funcs, **(user_funcs or {})}
        elif isinstance(expression, sympy.Basic):
            sympy_expr = expression
        elif callable(expression):
            raise TypeError("Expressions must be strings or numbers, not functions")
        elif isinstance(expression, numbers.Number):
            sympy_expr = sympy.sympify(expression)
        elif isinstance(expression, str):
            sympy_expr = parse_expr_guarded(
                expression,
                symbols=[signature or [], explicit_symbols or [], list(consts or {})],
                functions=set(user_funcs or {}),
            )
        elif isinstance(expression, np.ndarray) and expression.ndim == 0:
            sympy_expr = sympy.sympify(float(expression))
        else:
            raise TypeError(f"Cannot interpret expression of type {type(expression)}")
        self._sympy_expr = sympy_expr
        self.user_funcs = {} if user_funcs is None else user_funcs
        self.consts = {} if consts is None else consts
        self._check_signature(signature)

    def _check_signature(self, signature=None):
        """Validate the signature against the free symbols of the expression."""
        free = {
            str(s) for s in self._sympy_expr.free_symbols if isinstance(s, sympy.Symbol)
        } - set(self.consts)
        if signature is None:
            signature = sorted(free)
        self.vars: list[str] = []
        found: set[str] = set()
        for sig in signature:
            names = [sig] if isinstance(sig, str) else list(sig)
            canonical = names[0]
            self.vars.append(canonical)
            for name in names:
                if name in free:
                    found.add(name)
                    if name != canonical:
                        self._sympy_expr = self._sympy_expr.subs(
                            sympy.Symbol(name), sympy.Symbol(canonical)
                        )
        leftover = free - found - set(self.vars)
        if leftover:
            raise RuntimeError(
                f"Expression contains unexpected variables {sorted(leftover)}; "
                f"expected only {self.vars}"
            )

    @property
    def expression(self) -> str:
        return str(self._sympy_expr)

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}("{self.expression}")'

    @property
    def depends_on(self) -> set[str]:
        return {str(s) for s in self._sympy_expr.free_symbols}

    def depends_on_variable(self, variable: str) -> bool:
        return variable in self.depends_on

    @property
    def complex(self) -> bool:
        """Whether the expression contains the imaginary unit."""
        return sympy.I in self._sympy_expr.atoms()

    def copy(self) -> ScalarExpression:
        return ScalarExpression(
            self, signature=self.vars, user_funcs=self.user_funcs, consts=self.consts
        )
