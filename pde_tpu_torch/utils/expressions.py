"""Mathematical expressions parsed by sympy and lowered to PyTorch.

Port of :mod:`pde_tpu.utils.expressions`: expressions are parsed once on the
host with a guarded sympy namespace and lowered with ``sympy.lambdify`` to
functions of ``torch.Tensor`` data (``backend="torch"``) or of numpy arrays
(``backend="numpy"``, what calling an expression evaluates on the host).

Warning:
    Expression parsing ultimately uses :func:`eval`-like mechanisms; do not parse
    expressions from untrusted sources.
"""

from __future__ import annotations

import copy
import math
import numbers
import re
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


def _heaviside_numpy(x, *args):
    h0 = args[0] if args else 0.5
    return np.heaviside(x, h0)


_NUMPY_MODULES = [
    {"Heaviside": _heaviside_numpy, "DiracDelta": lambda x: np.zeros_like(x)},
    "numpy",
]


def _modules(backend: str, user_funcs: dict) -> list:
    """``sympy.lambdify``'s modules for `backend`, the user functions first so
    that they shadow same-named library functions."""
    if backend == "torch":
        return [user_funcs, *_get_torch_modules()]
    if backend in ("numpy", "numba"):
        return [user_funcs, *_NUMPY_MODULES]
    raise ValueError(f"Unknown backend `{backend}`")


class ExpressionBase:
    """Abstract base class for handling expressions."""

    def __init__(
        self,
        expression: sympy.Basic,
        signature: Sequence[str | Sequence[str]] | None = None,
        *,
        user_funcs: dict[str, Callable] | None = None,
        consts: dict[str, Any] | None = None,
    ):
        self._sympy_expr = expression
        self.user_funcs = {} if user_funcs is None else user_funcs
        self.consts = {} if consts is None else consts
        self._check_signature(signature)

    def _check_signature(self, signature=None):
        """Validate the signature against the free symbols of the expression
        (indexed atoms such as ``name[0]`` take no part in it)."""
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

    def __eq__(self, other):
        if not isinstance(other, ExpressionBase):
            return NotImplemented
        return self._sympy_expr == other._sympy_expr and self.vars == other.vars

    def __hash__(self):
        return hash((str(self._sympy_expr), tuple(self.vars)))

    @property
    def constant(self) -> bool:
        """Whether the expression is a constant."""
        return len(self._sympy_expr.free_symbols - set(map(sympy.Symbol, self.consts))) == 0

    @property
    def depends_on(self) -> set[str]:
        return {str(s) for s in self._sympy_expr.free_symbols}

    def depends_on_variable(self, variable: str) -> bool:
        return variable in self.depends_on

    @property
    def complex(self) -> bool:
        """Whether the expression contains the imaginary unit."""
        return sympy.I in self._sympy_expr.atoms()

    @property
    def rank(self) -> int:
        return 0

    def _get_function(self, single_arg: bool = False, backend: str = "torch") -> Callable:
        """Lambdify the expression for `backend`: ``"torch"`` (functions of
        tensors; Python numbers become float64 tensors) or ``"numpy"``."""
        modules = _modules(backend, self.user_funcs)
        expr = self._sympy_expr
        # consts referenced as `name[idx]` (IndexedBase) cannot be substituted
        # into the sympy tree; they are bound as extra lambdify arguments
        indexed_names = {str(a.base.label) for a in expr.atoms(sympy.Indexed)} & set(self.consts)
        if self.consts:
            expr = expr.subs(
                {sympy.Symbol(k): v for k, v in self.consts.items() if k not in indexed_names}
            )
        variables = [sympy.Symbol(v) for v in self.vars]
        extra_args = [sympy.IndexedBase(name) for name in sorted(indexed_names)]
        extra_vals = [self.consts[name] for name in sorted(indexed_names)]
        func = sympy.lambdify(variables + extra_args, expr, modules=modules)
        if extra_vals:
            inner = func
            func = lambda *args: inner(*args, *extra_vals)  # noqa: E731
        if single_arg:
            return lambda arr: func(*arr)
        return func

    def get_compiled(self, single_arg: bool = False) -> Callable:
        """The expression as a function of tensors (``pde_tpu``'s jitted
        function; torch runs it eagerly)."""
        return self._get_function(single_arg=single_arg, backend="torch")

    def __call__(self, *args, **kwargs):
        """Evaluate the expression on host (numpy) data."""
        return self._get_function(backend="numpy")(*args, **kwargs)


class ScalarExpression(ExpressionBase):
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
        allow_indexed: bool = False,
    ):
        self.allow_indexed = allow_indexed
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
            if allow_indexed:
                # `name[idx]` indexes a (constant) array
                expression = re.sub(r"\b(\w+)\s*(\[\w+\])", r"IndexedBase(\1)\2", expression)
            sympy_expr = parse_expr_guarded(
                expression,
                symbols=[signature or [], explicit_symbols or [], list(consts or {})],
                functions=set(user_funcs or {}),
                indexed=allow_indexed,
            )
        elif isinstance(expression, np.ndarray) and expression.ndim == 0:
            sympy_expr = sympy.sympify(float(expression))
        else:
            raise TypeError(f"Cannot interpret expression of type {type(expression)}")
        super().__init__(sympy_expr, signature, user_funcs=user_funcs, consts=consts)

    def copy(self) -> ScalarExpression:
        return ScalarExpression(
            self, signature=self.vars, user_funcs=self.user_funcs, consts=self.consts
        )

    @property
    def value(self) -> float:
        """The value of a constant expression."""
        if not self.constant:
            raise TypeError("Only constant expressions have a value")
        value = self._sympy_expr.subs({sympy.Symbol(k): v for k, v in self.consts.items()})
        return complex(value) if self.complex else float(value)

    @property
    def is_zero(self) -> bool:
        return self.constant and self.value == 0

    def __bool__(self) -> bool:
        return not self.is_zero

    def differentiate(self, var: str) -> ScalarExpression:
        """The derivative with respect to `var`."""
        if self.constant:
            return ScalarExpression(0, signature=self.vars)
        return ScalarExpression(
            self._sympy_expr.diff(sympy.Symbol(var)),
            signature=self.vars,
            user_funcs=self.user_funcs,
            consts=self.consts,
        )

    @property
    def derivatives(self) -> TensorExpression:
        """The gradient with respect to all variables."""
        if self.constant:
            derivs = sympy.Array([0] * len(self.vars))
        else:
            derivs = sympy.Array([self._sympy_expr.diff(sympy.Symbol(v)) for v in self.vars])
        return TensorExpression(derivs, signature=self.vars, user_funcs=self.user_funcs)


class TensorExpression(ExpressionBase):
    """A tensor-valued mathematical expression."""

    def __init__(self, expression, signature=None, *, user_funcs=None, consts=None):
        if isinstance(expression, TensorExpression):
            sympy_expr = expression._sympy_expr
            signature = signature or expression.vars
            user_funcs = {**expression.user_funcs, **(user_funcs or {})}
        elif isinstance(expression, sympy.Array):
            sympy_expr = expression
        elif isinstance(expression, str):
            # strings like "[x, 2*x]" are parsed elementwise
            parsed = parse_expr_guarded(
                expression,
                symbols=[signature or [], list(consts or {})],
                functions=set(user_funcs or {}),
            )
            sympy_expr = sympy.Array(parsed)
        else:
            # a nested sequence of expressions and numbers
            def build(obj):
                if isinstance(obj, (list, tuple)):
                    return [build(o) for o in obj]
                if isinstance(obj, str):
                    return parse_expr_guarded(
                        obj,
                        symbols=[signature or [], list(consts or {})],
                        functions=set(user_funcs or {}),
                    )
                return sympy.sympify(obj)

            sympy_expr = sympy.Array(build(expression))
        super().__init__(sympy_expr, signature, user_funcs=user_funcs, consts=consts)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._sympy_expr.shape)

    @property
    def rank(self) -> int:
        return len(self.shape)

    def __getitem__(self, index):
        expr = self._sympy_expr[index]
        if isinstance(expr, sympy.Array):
            return TensorExpression(expr, signature=self.vars, user_funcs=self.user_funcs)
        return ScalarExpression(expr, signature=self.vars, user_funcs=self.user_funcs)

    @property
    def constant(self) -> bool:
        return all(len(e.free_symbols) == 0 for e in np.asarray(self._sympy_expr).flat)

    @property
    def value(self):
        if not self.constant:
            raise TypeError("Only constant expressions have a value")
        return np.array(self._sympy_expr, dtype=float)

    def differentiate(self, var: str) -> TensorExpression:
        return TensorExpression(
            self._sympy_expr.diff(sympy.Symbol(var)),
            signature=self.vars,
            user_funcs=self.user_funcs,
        )

    @property
    def derivatives(self) -> TensorExpression:
        derivs = sympy.derive_by_array(self._sympy_expr, [sympy.Symbol(v) for v in self.vars])
        return TensorExpression(derivs, signature=self.vars, user_funcs=self.user_funcs)

    def _get_function(self, single_arg: bool = False, backend: str = "torch") -> Callable:
        """Lambdify every entry; the function returns them stacked, broadcast
        to one shape (a tensor, or with ``backend="numpy"`` an array)."""
        modules = _modules(backend, self.user_funcs)
        variables = [sympy.Symbol(v) for v in self.vars]
        exprs = np.asarray(self._sympy_expr)
        shape = exprs.shape
        funcs = [sympy.lambdify(variables, e, modules=modules) for e in exprs.flat]

        def func(*args):
            values = [f(*args) for f in funcs]
            if backend == "torch":
                tensors = [v if isinstance(v, torch.Tensor)
                           else torch.as_tensor(v, dtype=torch.float64) for v in values]
                devices = {t.device for t in tensors if t.dim()}
                if devices:
                    tensors = [t.to(next(iter(devices))) for t in tensors]
                tensors = torch.broadcast_tensors(*tensors)
                return torch.stack(tensors).reshape(shape + tensors[0].shape)
            arrays = np.broadcast_arrays(*[np.asarray(v) for v in values])
            return np.stack(arrays).reshape(shape + arrays[0].shape)

        if single_arg:
            return lambda arr: func(*arr)
        return func
