"""Evaluate expressions of fields and differential operators.

Port of :mod:`pde_tpu.utils.expressions_eval`: the expression is parsed once
by sympy, its operators resolve through the grid's operator registry (as
``field.laplace`` does) with per-operator boundary conditions, and it is
evaluated as torch operations on the fields' device. On the card, an
operator that the ``cuda`` registry serves with a kernel (``laplace``
through kernel #1, the six stencil operators through ``stencil_op_2d``) runs
that kernel, as :func:`evaluate`'s `backend` says.
"""

from __future__ import annotations

import numbers
import re
from typing import Any, Callable

import numpy as np
import sympy
import torch

from ..fields.datafield_base import DataFieldBase
from ..fields.scalar import ScalarField
from ..fields.tensorial import Tensor2Field
from ..fields.vectorial import VectorField, vector_dot, vector_outer


def _make_operator(grid, name: str, bc, like: torch.Tensor, backend: str) -> Callable:
    """``op(data, t, args)``: the ``cuda`` registry's kernel where `backend`
    asks for it (``"cuda"``: required; ``"auto"``: on a CUDA tensor where one
    is registered and takes the configuration), else the plain operator."""
    from ..backends import CudaBackend
    from ..ops.cuda_cartesian import KernelUnsupportedError

    if backend in ("cuda", "pallas"):
        return CudaBackend().make_operator(grid, name, bc)
    if backend != "auto" and backend not in ("torch", "numpy"):
        raise ValueError(f"Unknown backend `{backend}` (expected 'auto', 'cuda' or 'torch')")
    if (backend == "auto" and like.device.type == "cuda"
            and CudaBackend.get_registered_factory(grid, name) is not None):
        try:
            return CudaBackend().make_operator(grid, name, bc)
        except KernelUnsupportedError:
            pass  # the configuration takes the plain operator, as backend="torch" does
    return grid.make_operator(name, bc=bc)


def evaluate(
    expression: str,
    fields: dict[str, DataFieldBase],
    *,
    bc="auto_periodic_neumann",
    bc_ops: dict[str, Any] | None = None,
    user_funcs: dict[str, Callable] | None = None,
    consts: dict[str, Any] | None = None,
    label: str | None = None,
    backend: str = "auto",
) -> DataFieldBase:
    """Evaluate an expression of fields with differential operators, e.g.
    ``evaluate("laplace(a * b)", {"a": a, "b": b})``.

    `bc` applies to every operator, `bc_ops` per operator name. The result
    is a scalar, vector or tensor field by its shape. `backend` picks the
    operators: ``"auto"`` (default) takes the ``cuda`` registry's kernels for
    CUDA tensors where they take the configuration and the plain operators
    otherwise, ``"cuda"`` requires the kernels (raising
    :class:`~pde_tpu_torch.ops.KernelUnsupportedError` where there is none),
    ``"torch"`` takes the plain operators.
    """
    from sympy.core.function import AppliedUndef

    from ..models.pde import _EXPRESSION_REPLACEMENT, _cell_coords
    from .expressions import ScalarExpression, _get_torch_modules

    if not fields:
        raise ValueError("Need at least one field to evaluate an expression")
    grids = {f.grid for f in fields.values()}
    if len(grids) > 1:
        raise ValueError("All fields must be defined on the same grid")
    grid = next(iter(grids))
    like = next(iter(fields.values())).data
    user_funcs = dict(user_funcs or {})
    consts = dict(consts or {})

    for search, repl in _EXPRESSION_REPLACEMENT.items():
        expression = re.sub(search, repl, expression)
    expr = ScalarExpression(expression, signature=None, user_funcs=user_funcs,
                            consts=dict.fromkeys(consts, 0),
                            explicit_symbols=list(fields) + list(grid.axes) + ["t"])
    operators = {func.__class__.__name__ for func in expr._sympy_expr.atoms(AppliedUndef)
                 if func.__class__.__name__ not in user_funcs}

    ops: dict[str, Callable] = {}
    bc_ops = dict(bc_ops or {})
    for func in operators:
        if func in ("dot", "inner"):
            ops["dot"] = ops["inner"] = vector_dot
        elif func == "outer":
            ops["outer"] = vector_outer
        elif func == "integral":
            ops["integral"] = grid.integrate
        else:
            op = _make_operator(grid, func, bc_ops.get(func, bc), like, backend)
            ops[func] = (lambda _op: lambda arr: _op(arr, 0.0, None))(op)

    signature = list(fields) + list(grid.axes)
    scalar_consts, const_names, const_args = {}, [], []
    for name, value in consts.items():
        if isinstance(value, DataFieldBase):
            const_names.append(name)
            const_args.append(value.data)
        elif np.isscalar(value) or isinstance(value, numbers.Number):
            scalar_consts[name] = value
        else:
            const_names.append(name)
            const_args.append(torch.as_tensor(value, device=like.device))
    signature += const_names

    sympy_expr = expr._sympy_expr
    if scalar_consts:
        sympy_expr = sympy_expr.subs({sympy.Symbol(k): v for k, v in scalar_consts.items()})
    free = {str(s) for s in sympy_expr.free_symbols}
    unknown = free - set(signature)
    if unknown:
        raise RuntimeError(f"Undefined variables in expression: {sorted(unknown)}")

    func = sympy.lambdify([sympy.Symbol(v) for v in signature], sympy_expr,
                          modules=[ops, user_funcs, *_get_torch_modules()])
    # the coordinates are made on the device only where the expression reads them
    coords = (_cell_coords(grid, like) if free & set(grid.axes)
              else [None] * grid.num_axes)
    args = [f.data for f in fields.values()]
    result = func(*args, *coords, *const_args)
    if not isinstance(result, torch.Tensor):
        result = torch.as_tensor(result, dtype=like.dtype, device=like.device)

    shape = tuple(result.shape)
    if shape == tuple(grid.shape) or result.dim() == 0:
        cls: type[DataFieldBase] = ScalarField
        result = torch.broadcast_to(result, tuple(grid.shape))
    elif shape == (grid.dim,) + tuple(grid.shape):
        cls = VectorField
    elif shape == (grid.dim, grid.dim) + tuple(grid.shape):
        cls = Tensor2Field
    else:
        raise RuntimeError(f"Cannot interpret result shape {shape}")
    return cls(grid, data=result, label=label)
