"""Temporally blocked 2D affine Laplacian: CUDA kernel, plain version, block
emulation, march replay, ladder.

Port of the single-device 2D path of :mod:`pde_tpu.ops.pallas_cartesian`:
``make_affine_laplace_2d`` computes ``f -> (a*I + b*lap)^k f`` in one pass
over device memory, and ``make_fused_euler_window_2d`` splits a step count
over a binary ladder of such kernels (k = :data:`TOP_STEPS`, its halves, ..., 1).

Four implementations of the same function live here:

- the CUDA kernel, the hand-written row march ``csrc/affine_march_2d.cuh``
  (one thread per window column, each level of its column in registers)
  instantiated for every k it takes and both dtypes at the plan
  :func:`affine_row_plan` picks, one library per periodicity of the two axes
  (the entry points are generated here, so the plan lives in one place),
  built with ``nvcc`` for ``sm_90a`` at first use into
  ``pde_tpu_torch/_build/`` and called through a plain C interface with
  ``ctypes``; past each mode's register top, the deep march
  ``csrc/affine_deep_2d.cuh`` (each level's rows in shared memory, k at run
  time, :func:`affine_deep_plan`);
- :func:`affine_laplace_2d_plain`, k plain PyTorch steps, the oracle that the
  kernel is held against and what the wrapper runs for tensors on the CPU;
- :func:`affine_laplace_2d_tiled`, a pure-torch emulation of the values the
  kernel's blocks compute (each block's strip and chunk with k-deep halos,
  wraps, zeros outside non-periodic sides and ghosts);
- :func:`affine_laplace_2d_marched`, a pure-torch replay of the kernel's
  schedule: the two shared-memory rows of each level, each thread's three
  registers a level, where each ghost is formed, the chunk and strip borders
  (the deep march's three shared rows a level and its copy of the factors:
  :func:`affine_deep_block`).

:func:`affine_laplace_2d` is the wrapper: for a CPU tensor it returns the
plain version; for a CUDA tensor it launches the kernel or raises.

On a ``CylindricalSymGrid`` (rows r, columns z) the same four compute the
cylindrical Laplacian's radial mode, as ``pde_tpu``'s kernel does with its
per-row coefficients (``_radial_row_coeffs``): the ``(1/r) d/dr`` term folds
into the factors of the row above and below,
``cu*up + cd*down + b*sy*(left + right) + (a - 2b*sx - 2b*sy)*centre`` with
``cu, cd = b*sx -+ (b / (2 dr)) / r`` at the row's centre radius. The factors
are one table per grid and dtype (:func:`radial_rows`), which the kernel and
every torch version read.

Supported (decided from the configuration alone, before any build): a 2D
``CartesianGrid`` or a ``CylindricalSymGrid`` (with its conditions given),
float32 or float64 data, each axis periodic or carrying affine BCs with at
least 2 cells, and ``1 <= k <=`` :data:`DEEP_MAX_STEPS` (``pde_tpu``'s
geometry gate) in every 5-point mode: the register march takes each mode up
to its top (:func:`register_top`: 16 Cartesian, :data:`RADIAL_TOP_STEPS`
radial, :data:`SIDES_TOP_STEPS` with side inputs,
:data:`RADIAL_SIDES_TOP_STEPS` with both), and the deep march
(``csrc/affine_deep_2d.cuh``, libraries of its own,
:data:`DEEP_LIBRARIES`) every deeper pass, k at run time and the levels'
rows in shared memory; bfloat16 data (bf16 storage, B1(f))
where the columns are periodic, as ``pde_tpu``'s kernel takes it: libraries
of their own (:func:`emit_source` with ``bf16``) whose passes load bf16,
step in float32 and round every level to bf16 (:func:`round_level`, which
the torch versions apply too), at the float32 plan. A side's const may vary
along it or in time (B1(c): the side inputs of :class:`AffineSides`, a kernel of its own;
on a cylinder the radial mode's kernel with side inputs, which reads the
radial table and the side tables together). Under the config
key ``operators.cartesian.laplacian_2d_corner_weight`` (B1(e)) the stencil
is ``pde_tpu``'s 9-point one, on fully periodic Cartesian grids without
conditions and ``1 <= k <=`` :data:`CORNER_TOP_STEPS` only (its gate; a
kernel of its own, whose march also keeps ``left + right`` of each level's
rows, :func:`corner_row_block`); the key does not alter the cylindrical
stencil. Everything else raises :class:`KernelUnsupportedError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..grids.cartesian import CartesianGrid
from ..grids.cylindrical import CylindricalSymGrid

#: deepest pass of the register march's libraries in the 5-point Cartesian modes
#: (``kAffineMaxSteps`` of ``csrc/affine_march_2d.cuh``); deeper passes take the
#: deep march
MAX_STEPS = 16
#: deepest temporal block one pass of kernel #1 takes: ``pde_tpu``'s geometry
#: gate (``_fused_geometry_ok``, ``4 * _HALO``, pde_tpu/ops/pallas_cartesian.py:190)
#: in every 5-point mode; the deep march (``csrc/affine_deep_2d.cuh``, its own
#: libraries) takes every k past the register march's top in each mode
DEEP_MAX_STEPS = 32
#: deepest pass of kernel #12 in the port, the top of its register libraries in
#: the Cartesian modes (``pde_tpu``'s hardware path takes k <= 8,
#: ``supports_affine_laplace_ext``, pde_tpu/ops/pallas_cartesian.py:5746-5770)
EXT_MAX_STEPS = 16
#: steps per pass at the top of the radial mode's ladder (cylindrical grids), and
#: the deepest pass its register library holds: at k = 12 the bounded r axis and the
#: factors' loads push the fp32 march past its 56 registers (156 bytes of spills)
#: and fp64 far past its 96 (824 bytes); k = 8 took 0.0280 against 0.0309 ms a
#: step in fp32 and 0.0499 against 0.0874 in fp64 on the H100
#: (``scripts/torch_radial_sweep.py``, PERF.md)
RADIAL_TOP_STEPS = 8
#: the library of the radial mode's entry points (its own kernel)
RADIAL_LIBRARY = "affine_laplace_radial_2d"
#: the library of the ext kernel's radial mode (TPU kernel #12's; its own kernel)
RADIAL_EXT_LIBRARY = "affine_laplace_radial_ext_2d"
#: rows of the radial table (:func:`radial_rows`) before grid row 0, and after
#: the last: a register pass of k steps reads window rows up to 2k before its
#: chunk and k after it (``kRadialPad`` of ``csrc/affine_march_2d.cuh``), a
#: deep pass k on either side (``kDeepPad`` of ``csrc/affine_deep_2d.cuh``)
RADIAL_PAD = 32
#: the library of kernel #1's passes with side inputs (B1(c): per-point consts
#: and a per-step table of time-dependent ones; a kernel of its own)
SIDES_LIBRARY = "affine_laplace_sides_2d"
#: steps per pass at the top of the side-input ladder, and the deepest pass its
#: register library holds: on the H100 its k = 6 pass took the least time a step of k =
#: 1-6 at 4096² fp32 (``scripts/torch_sides_sweep.py``), and deeper passes took
#: more than it, their march spilling (PERF.md)
SIDES_TOP_STEPS = 6
#: rows of a column side's per-point table before grid row 0, and after the last
#: (``kDeepPad`` of ``csrc/affine_deep_2d.cuh``): a pass of k steps reads
#: window rows up to k past either end of the grid; the ext kernel's row sides
#: are padded by as many columns
SIDE_PAD = 32
#: the side tables' pad the register march is compiled with (``kSidePad`` of
#: ``csrc/affine_march_2d.cuh``): its passes get the tables from their row (an
#: ext row side's column) ``SIDE_PAD - REGISTER_SIDE_PAD`` on
#: (:func:`side_pointers`), and its ext passes take a halo of at most this
REGISTER_SIDE_PAD = 16
#: the library of kernel #12's passes with side inputs (A9.3: each block reads
#: the global grid's tables at its origin; a kernel of its own)
SIDES_EXT_LIBRARY = "affine_laplace_sides_ext_2d"
#: the libraries of the radial modes of kernels #1 and #12 with side inputs
#: (B1(c) on a cylinder: the radial table and the side tables together; kernels
#: of their own)
RADIAL_SIDES_LIBRARY = "affine_laplace_radial_sides_2d"
RADIAL_SIDES_EXT_LIBRARY = "affine_laplace_radial_sides_ext_2d"
#: steps per pass at the top of the radial side-input ladder, and the deepest
#: pass its register libraries hold: on the H100 at 4096² its fp32 k = 5 pass took the
#: least time a step of k = 1-6 on both cylinders of
#: ``scripts/torch_radial_sweep.py --sides`` (0.02951 against 0.03038 ms at
#: k = 6 with z periodic, 0.04125 against 0.04174 with z bounded; fp64 was
#: 2-6 % faster a step at k = 6), and k = 6 spills 32 bytes (PERF.md)
RADIAL_SIDES_TOP_STEPS = 5
#: steps per pass at the top of the diffusion windows' ladders, serial and
#: decomposed: the k of the least time per step on the H100 in fp32 and fp64
#: (``scripts/torch_affine2d_sweep.py``, PERF.md); bf16 storage tops here too
#: (``scripts/torch_affine2d_sweep.py --dtype bf16``: 0.01660 ms a step at
#: k = 12 at 4096², 0.01656 at 13, 0.01664 at 14, 0.01649 at 15 and 0.01789 at
#: 16, k = 12-15 within 1 % of one another; fp32 0.01393 at k = 12)
TOP_STEPS = 12
#: steps per pass at the top of the 9-point corner-weight mode's ladder, and the
#: deepest pass its libraries hold: ``pde_tpu``'s cap (``_HALO``,
#: ``pde_tpu/ops/pallas_cartesian.py:850-860``), kept so that the ladders match
CORNER_TOP_STEPS = 8
#: the libraries of the 9-point corner-weight mode of kernels #1 and #12 (their
#: own kernels)
CORNER_LIBRARY = "affine_laplace_corner_2d"
CORNER_EXT_LIBRARY = "affine_laplace_corner_ext_2d"
#: blocks per SM the 9-point march's launch bounds ask for, by itemsize, and
#: the level-0 rows its top pass keeps in flight: at 4096² on the H100, fp32
#: k = 8 took 0.1496 ms a pass at four blocks and one row (56 registers, 52
#: bytes of spills) against 0.1763 at three blocks and three rows (72
#: registers), fp64 k = 8 0.3058 against 0.3493 at two blocks with one row
#: against three; below the top, three rows ran faster
#: (``scripts/torch_corner_sweep.py``, PERF.md)
CORNER_MIN_BLOCKS = {4: 4, 8: 2}
CORNER_TOP_PREFETCH = 1
#: shared-memory rows a level keeps in the row march (``AffineRowShape::kSlots``)
ROW_SLOTS = 2
#: rows the march's loop is unrolled by: the least common multiple of the
#: slots and a level's three registers (``AffineRowShape::kPeriod``)
ROW_PERIOD = 6
#: level-0 rows each thread of the march keeps in flight (a divisor of the period)
ROW_PREFETCH = 3
#: blocks per SM the march's launch bounds ask ptxas to fit, by itemsize: four
#: blocks of 288 threads hold 56 registers a thread, two hold 112
ROW_MIN_BLOCKS = {4: 4, 8: 2}
#: the deep march (``csrc/affine_deep_2d.cuh``): threads a block
#: (``kDeepThreads``), window columns a thread at most (``kDeepCols``), shared
#: rows a level (``kDeepSlots``), the strips it may take, widest first, and the
#: shared memory a block may take on the H100 (227 KB)
DEEP_THREADS = 256
DEEP_COLS = 2
DEEP_SLOTS = 3
DEEP_TX = tuple(range(448, 0, -32))
DEEP_SMEM = 232448

_PACKAGE = Path(__file__).resolve().parent.parent
_BUILD_DIR = _PACKAGE / "_build"
_CSRC = _PACKAGE / "csrc"
#: the row march both 2D affine kernels instantiate, and the window geometry it includes
_TEMPLATE = _CSRC / "affine_march_2d.cuh"
_MARCH = _CSRC / "march_2d.cuh"
#: the deep march of both 2D affine kernels (k at run time, the levels in shared memory)
_DEEP_TEMPLATE = _CSRC / "affine_deep_2d.cuh"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: the kernels' dtypes: C type, entry-point suffix, itemsize
_DTYPES = {torch.float32: ("float", "f32", 4), torch.float64: ("double", "f64", 8)}
#: bf16 storage (ROADMAP B1(f)), in kernels #1 and #12 and the ext kernel #8
#: alone: the storage type's C type and entry-point suffix; a bf16 pass loads
#: bfloat16, computes each step in float32 with the float32 kernel's
#: coefficients, rounds every level to bfloat16 (as ``pde_tpu``'s kernels hold
#: a bf16 band) and stores bfloat16, at the float32 plan
BF16 = ("__nv_bfloat16", "bf16")


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a pass on data of `dtype` computes in: float32 for bf16
    storage, else the data's own."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def round_level(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A level computed in :func:`compute_dtype` rounded to the storage
    `dtype` and back (bf16 storage), or `values` as they are."""
    if dtype == torch.bfloat16:
        return values.to(dtype).to(torch.float32)
    return values


def rounded_table(values, dtype: torch.dtype) -> torch.Tensor:
    """Side or time tables of a pass on `dtype` data: bf16-rounded values in
    float32 for bf16 storage (as ``pde_tpu`` casts its tables to the data's
    dtype; the kernels read them in the working type), else `dtype`'s."""
    values = torch.as_tensor(values)
    return round_level(values.to(dtype), dtype)


def bf16_refusal(what: str, line: str) -> KernelUnsupportedError:
    """The refusal of bf16 data by a kernel that ``pde_tpu`` keeps float32-only
    (or by a mode of one), naming ``pde_tpu``'s gate (`line`, under
    ``pde_tpu/``)."""
    return KernelUnsupportedError(
        f"The kernel takes float32 or float64 data here: bf16 storage (ROADMAP B1(f)) is not "
        f"taken by {what}, as pde_tpu's gate (pde_tpu/{line}); the torch engine runs it on the "
        "plain loop")


class KernelUnsupportedError(NotImplementedError):
    """The configuration cannot be lowered to the fused CUDA kernel."""


def _corner_weight() -> float:
    from ..utils.config import config

    return float(config["operators.cartesian.laplacian_2d_corner_weight"])


# -- boundary conditions as affine ghost formulas -------------------------------------------
class BCSideSpec:
    """Affine ghost-point data of one axis side, in ``pde_tpu``'s general
    form ``ghost = const_static + const_t(t) + f1*edge + f2*next_inward``, or
    ``ghost = const_xt(t) + f1*edge + f2*next_inward`` where the const varies
    in space and time.

    ``const_static`` is a scalar or a per-point array along the side;
    ``const_t`` a function of time (a time-dependent expression condition):
    a float of a float (on the host), or float64 values of a float64 tensor
    of times (on its device); ``const_xt`` a function ``(ts, device) ->
    (len(ts), n)`` tensor of float64 on `device`, the side's values at the
    times `ts` (a float64 tensor on that device), evaluated with torch;
    ``f1``/``f2`` scalars or per-point arrays (Robin with a gamma varying
    along the side); ``f1_t`` a function of time like ``const_t``, a
    time-dependent ``f1`` (then ``f1`` holds its value at t = 0)."""

    __slots__ = ("f1", "f2", "const_static", "const_t", "const_xt", "f1_t")

    def __init__(self, f1, f2, const_static, const_t=None, const_xt=None, f1_t=None):
        self.f1 = float(f1) if np.ndim(f1) == 0 else np.asarray(f1, dtype=float)
        self.f2 = float(f2) if np.ndim(f2) == 0 else np.asarray(f2, dtype=float)
        self.const_static = (float(const_static) if np.ndim(const_static) == 0
                             else np.asarray(const_static, dtype=float))
        self.const_t = const_t
        self.const_xt = const_xt
        self.f1_t = f1_t

    @property
    def is_scalar(self) -> bool:
        return (np.ndim(self.const_static) == 0 and np.ndim(self.f1) == 0
                and np.ndim(self.f2) == 0 and self.const_t is None and self.const_xt is None
                and self.f1_t is None)

    def scalar_triplet(self) -> tuple[float, float, float]:
        """(const, f1, f2), the order of ``pde_tpu``'s ``scalar_triplet``;
        raises :class:`KernelUnsupportedError` for per-point or time-dependent
        parts."""
        if not self.is_scalar:
            raise KernelUnsupportedError(
                "Per-point array and time-dependent BC values are not taken by this kernel: "
                "#2, #3 and #11 take scalar values, as pde_tpu's do (3D diffusion with such "
                "faces takes the expression window, #5 or #6 on a mesh; kernel #1 takes them "
                "as its side inputs, ROADMAP B1(c))")
        return self.const_static, self.f1, self.f2


def _uniform_scalar(value):
    """Collapse a uniform array to a float; None where it truly varies."""
    arr = np.asarray(value, dtype=float)
    if arr.ndim == 0:
        return float(arr)
    flat = arr.reshape(-1)
    if flat.size and np.all(flat == flat[0]):
        return float(flat[0])
    return None


def _expression_bc_spec(bc) -> BCSideSpec:
    """Lower an expression condition (any target) to the affine form: ``f1``
    is the derivative of its ghost expression by the adjacent value (``dx``
    substituted), a number, a per-point array (a coefficient varying along
    the side) or a host function of t; the const is the ghost at adjacent
    value 0: a number or an array of the side's coordinates, a host function
    of t, or (varying in both) a torch function of the side's coordinates
    and t. Refused, as in ``pde_tpu``: expressions nonlinear in the adjacent
    value, a coefficient varying in time and space, complex values, callables
    and ``value_cell``."""
    import sympy

    if bc.value_cell is not None:
        raise KernelUnsupportedError("value_cell expression BCs are not supported by the kernels")
    expr = bc._expr
    if expr is None:  # a callable: its dependence is unknowable
        raise KernelUnsupportedError("Callable expression BCs are not supported by the kernels")
    value_sym, t_sym = sympy.Symbol("value"), sympy.Symbol("t")
    axis_syms = {sympy.Symbol(ax) for ax in bc.grid.axes}
    dx = float(bc.grid.discretization[bc.axis])
    coords = bc.boundary_coordinates()
    sexpr = expr._sympy_expr.subs(sympy.Symbol("dx"), sympy.Float(dx))
    dcoeff = sympy.diff(sexpr, value_sym)
    if dcoeff.free_symbols:
        dcoeff = sympy.simplify(dcoeff)
    f1_t = None
    if dcoeff.free_symbols == {t_sym}:
        if sympy.simplify(sympy.im(dcoeff.subs(t_sym, sympy.Symbol("t", real=True)))) != 0:
            raise KernelUnsupportedError(
                "Complex adjacent-value coefficients are not supported by the kernels")
        from ..utils.expressions import _get_torch_modules

        f1 = float(sympy.lambdify(t_sym, dcoeff, modules="numpy")(0.0))
        f1_t = _time_function(sympy.lambdify(t_sym, dcoeff, modules="numpy"),
                              sympy.lambdify(t_sym, dcoeff, modules=_get_torch_modules()))

    elif dcoeff.free_symbols and dcoeff.free_symbols <= axis_syms:
        # a coefficient varying along the side: a per-point array
        syms = [sympy.Symbol(ax) for ax in bc.grid.axes]
        arr = np.asarray(sympy.lambdify(syms, dcoeff, modules="numpy")(*coords))
        if np.iscomplexobj(arr):
            if np.any(np.imag(arr)):
                raise KernelUnsupportedError(
                    "Complex adjacent-value coefficients are not supported by the kernels")
            arr = np.real(arr)
        arr = np.broadcast_to(arr.astype(float), coords[0].shape).reshape(-1)
        uniform = _uniform_scalar(arr)
        f1 = uniform if uniform is not None else arr
    elif dcoeff.free_symbols or not sympy.im(dcoeff).is_zero:
        raise KernelUnsupportedError(
            "Expression BCs whose adjacent-value coefficient varies in time and space (or is "
            "complex) are not supported by the kernels")
    else:
        f1 = float(dcoeff)
    const_expr = sympy.expand(sexpr - dcoeff * value_sym)
    if value_sym in const_expr.free_symbols:
        const_expr = sympy.simplify(const_expr)
    if value_sym in const_expr.free_symbols:
        raise KernelUnsupportedError(
            "Expression BCs nonlinear in the adjacent value are not supported by the kernels")
    if const_expr.has(sympy.I):
        raise KernelUnsupportedError("Complex BC values are not supported by the kernels")
    free = {str(sym) for sym in const_expr.free_symbols}
    has_t, has_coords = "t" in free, bool(free & set(bc.grid.axes))
    func = bc._func
    if has_t and has_coords:
        shape = coords[0].shape

        def const_xt(ts, device, _coords=coords, _shape=shape):
            """The side's consts at the times `ts`: ``(len(ts), n)`` float64."""
            flat = [torch.as_tensor(c, dtype=torch.float64, device=device).reshape(1, -1)
                    for c in _coords]
            zero = torch.zeros((), dtype=torch.float64, device=device)
            values = torch.as_tensor(func(zero, dx, *flat, ts.reshape(-1, 1)),
                                     dtype=torch.float64, device=device)
            return torch.broadcast_to(values, (ts.numel(), int(np.prod(_shape)))).contiguous()

        return BCSideSpec(f1, 0.0, 0.0, const_xt=const_xt, f1_t=f1_t)
    host = expr._get_function(backend="numpy")  # the ghost of adjacent value 0 is the const
    if has_t:
        zeros = [0.0] * bc.grid.num_axes
        const_t = _time_function(lambda t: host(0.0, dx, *zeros, t),
                                 lambda t: func(torch.zeros_like(t), dx, *zeros, t))
        return BCSideSpec(f1, 0.0, 0.0, const_t, f1_t=f1_t)
    const = np.asarray(host(0.0, dx, *coords, 0.0), dtype=float)
    uniform = _uniform_scalar(const)
    return BCSideSpec(f1, 0.0, uniform if uniform is not None else const.reshape(-1), f1_t=f1_t)


def _time_function(host: Callable, device: Callable) -> Callable:
    """A function of time: `host` on a float (a float), `device` on a float64
    tensor of times (float64 values of its shape, on its device)."""

    def of_time(t):
        if isinstance(t, torch.Tensor):
            values = torch.as_tensor(device(t), dtype=torch.float64, device=t.device)
            return torch.broadcast_to(values, t.shape)
        return float(host(t))

    return of_time


def affine_bc_specs(grid, bcs):
    """Per-axis affine ghost specs: ``None`` for a periodic axis, else a
    (low, high) pair of :class:`BCSideSpec`, whose consts may be per-point
    arrays or depend on time (expression conditions; ``pde_tpu``'s
    ``affine_bc_specs``). Returns ``None`` when fully periodic; raises
    :class:`KernelUnsupportedError` for conditions with no affine form. Each
    kernel takes the parts it can (scalars everywhere; see
    :func:`affine_laplace_spec` and the generated kernels' gates)."""
    from ..grids.boundaries.local import ConstBC1stOrderBase, ConstBC2ndOrderBase, ExpressionBC

    params = []
    for ax, pair in enumerate(bcs):
        if pair.periodic:
            if pair.low.flip_sign:
                raise KernelUnsupportedError("Anti-periodic BCs are not supported by the kernel")
            params.append(None)
            continue
        edge_lo, edge_hi = 0, grid.shape[ax] - 1
        sides = []
        for bc in (pair.low, pair.high):
            if bc.normal:
                raise KernelUnsupportedError(
                    "Normal boundary conditions act on one component; the kernels apply "
                    "one condition to every plane"
                )
            edge = edge_hi if bc.upper else edge_lo
            inward = -1 if bc.upper else 1
            if isinstance(bc, ExpressionBC):
                sides.append(_expression_bc_spec(bc))
                continue
            if isinstance(bc, ConstBC1stOrderBase):
                const, f1, idx = bc.get_virtual_point_data()
                f2, idx2 = 0.0, edge + inward
            elif isinstance(bc, ConstBC2ndOrderBase):
                const, f1, idx, f2, idx2 = bc.get_virtual_point_data()
            else:
                raise KernelUnsupportedError(
                    f"BC type {type(bc).__name__} is not supported by the kernel"
                )
            if idx != edge or idx2 != edge + inward:
                raise KernelUnsupportedError("Unexpected virtual-point layout")
            parts = []
            for value in (f1, f2, const):
                uniform = _uniform_scalar(value)
                parts.append(uniform if uniform is not None
                             else np.asarray(value, dtype=float).reshape(-1))
            sides.append(BCSideSpec(*parts))
        params.append(tuple(sides))
    if all(p is None for p in params):
        return None
    return tuple(params)


def collect_bc_side_inputs(bc_table):
    """The array-valued and time-dependent parts of a table of per-axis
    :func:`affine_bc_specs` tuples (2D: axis 0 rows, axis 1 columns), as
    ``pde_tpu``'s ``collect_bc_side_inputs``: None where every part is a
    scalar, else ``{"arrays": [(kind, spec), ...], "t": [(spec, "const_t" |
    "f1_t"), ...], "xt": [(kind, spec), ...], "factors": [(kind, spec, "f1" |
    "f2"), ...]}`` with kind ``"row"`` (a side of the rows' axis, its values
    along the columns) or ``"col"``, each distinct spec once."""
    arrays: list = []
    t_slots: list = []
    xt: list = []
    factors: list = []
    seen: set = set()
    for specs in bc_table.values():
        if specs is None:
            continue
        for ax, pair in enumerate(specs):
            if pair is None:
                continue
            for spec in pair:
                if id(spec) in seen:
                    continue
                seen.add(id(spec))
                kind = "row" if ax == 0 else "col"
                for attr in ("f1", "f2"):
                    if np.ndim(getattr(spec, attr)) != 0:
                        factors.append((kind, spec, attr))
                if spec.f1_t is not None:
                    t_slots.append((spec, "f1_t"))
                if spec.const_xt is not None:
                    xt.append((kind, spec))
                    continue
                if np.ndim(spec.const_static) != 0:
                    arrays.append((kind, spec))
                if spec.const_t is not None:
                    t_slots.append((spec, "const_t"))
    if not arrays and not t_slots and not xt and not factors:
        return None
    return {"arrays": arrays, "t": t_slots, "xt": xt, "factors": factors}


def collect_bc_side_inputs_3d(bc_table):
    """The 3D counterpart of :func:`collect_bc_side_inputs`, as ``pde_tpu``'s
    ``collect_bc_side_inputs_3d``: None where every part is a scalar, else
    ``{"arrays": [(axis, spec, "const_static" | "f1" | "f2"), ...], "t":
    [(spec, "const_t" | "f1_t"), ...], "xt": [(axis, spec), ...]}``, the
    per-face values and the per-face ghost factors in one list (they are
    staged alike), each distinct spec once, in ``pde_tpu``'s order."""
    arrays: list = []
    t_slots: list = []
    xt: list = []
    seen: set = set()
    for specs in bc_table.values():
        if specs is None:
            continue
        for ax, pair in enumerate(specs):
            if pair is None:
                continue
            for spec in pair:
                if id(spec) in seen:
                    continue
                seen.add(id(spec))
                for attr in ("f1", "f2"):
                    if np.ndim(getattr(spec, attr)) != 0:
                        arrays.append((ax, spec, attr))
                if spec.f1_t is not None:
                    t_slots.append((spec, "f1_t"))
                if spec.const_xt is not None:
                    xt.append((ax, spec))
                    continue
                if np.ndim(spec.const_static) != 0:
                    arrays.append((ax, spec, "const_static"))
                if spec.const_t is not None:
                    t_slots.append((spec, "const_t"))
    if not arrays and not t_slots and not xt:
        return None
    return {"arrays": arrays, "t": t_slots, "xt": xt}


# -- the march's plan -------------------------------------------------------------------------
def affine_row_smem(k: int, tx: int, threads: int, itemsize: int) -> int:
    """Shared-memory bytes of a march block (``AffineRowShape::kSmem``):
    :data:`ROW_SLOTS` rows a level, each of every thread's columns plus a pad
    cell on each side."""
    cols = -(-(tx + 2 * k) // threads)
    return k * ROW_SLOTS * (threads * cols + 2) * itemsize


def affine_row_plan(k: int, itemsize: int) -> tuple[int, int, int, int]:
    """The row march's plan ``(tx, threads, prefetch, min_blocks)`` at k steps
    and this itemsize: the widest strip of
    :data:`.cuda_stencil_2d.ROW_TX` whose shared rows fit the budget of
    :data:`.cuda_stencil_2d.SMEM_BUDGET`, one thread per column of its window
    row (:func:`.cuda_stencil_2d.row_threads`), :data:`ROW_PREFETCH` rows in
    flight and the blocks per SM of :data:`ROW_MIN_BLOCKS` for the itemsize."""
    from .cuda_stencil_2d import ROW_TX, SMEM_BUDGET, row_threads

    for tx in ROW_TX:
        threads = row_threads(tx + 2 * k)
        if affine_row_smem(k, tx, threads, itemsize) <= SMEM_BUDGET:
            return tx, threads, ROW_PREFETCH, ROW_MIN_BLOCKS[itemsize]
    raise KernelUnsupportedError(f"No row-march plan fits k = {k} at {itemsize} bytes a cell")


def corner_row_plan(k: int, itemsize: int) -> tuple[int, int, int, int]:
    """The 9-point march's plan: :func:`affine_row_plan`'s strip and threads
    (its shared rows are the same), :data:`CORNER_TOP_PREFETCH` rows in
    flight at the top k (else the 5-point plan's) and the blocks per SM of
    :data:`CORNER_MIN_BLOCKS`."""
    tx, threads, prefetch, _ = affine_row_plan(k, itemsize)
    if k == CORNER_TOP_STEPS:
        prefetch = CORNER_TOP_PREFETCH
    return tx, threads, prefetch, CORNER_MIN_BLOCKS[itemsize]


def affine_deep_smem(k: int, tx: int, itemsize: int, rows: int = 0, sides: bool = False) -> int:
    """Shared-memory bytes of a deep march block (``deep_smem_bytes``): the
    rings, :data:`DEEP_SLOTS` rows a level of ``tx + 2k`` cells and a pad cell
    on each side, rounded up to 16 bytes, then the radial mode's factors of
    its `rows` window rows, then with `sides` the t-table (four values for each
    of :data:`DEEP_MAX_STEPS` steps)."""
    ring = -(-(k * DEEP_SLOTS * (tx + 2 * k + 2) * itemsize) // 16) * 16
    return ring + rows * 2 * itemsize + (4 * DEEP_MAX_STEPS * itemsize if sides else 0)


def affine_deep_plan(k: int, itemsize: int, radial: bool = False, sides: bool = False,
                     budget: int = DEEP_SMEM) -> tuple[int, int, int, int]:
    """The deep march's plan ``(tx, threads, prefetch, min_blocks)`` at k steps
    and this itemsize: the widest strip of :data:`DEEP_TX` whose window row
    the block's :data:`DEEP_THREADS` threads cover, :data:`DEEP_COLS` columns
    each, and whose shared memory (in the radial mode with the factors of the
    longest chunk's window rows, with side inputs the t-table) fits `budget`
    bytes; one row in flight, one block an SM asked of ptxas."""
    from .cuda_stencil_2d import CHUNK_ROWS

    rows = CHUNK_ROWS[0] + 2 * k if radial else 0
    for tx in DEEP_TX:
        if (tx + 2 * k <= DEEP_THREADS * DEEP_COLS
                and affine_deep_smem(k, tx, itemsize, rows, sides) <= budget):
            return tx, DEEP_THREADS, 1, 1
    raise KernelUnsupportedError(f"No deep-march plan fits k = {k} at {itemsize} bytes a cell")


def register_top(radial: bool, sides: bool, corner: bool = False) -> int:
    """The deepest pass of the register march's library in a mode; deeper
    passes (up to :data:`DEEP_MAX_STEPS`) take the deep march, but in the
    9-point mode, which stops there."""
    if corner:
        return CORNER_TOP_STEPS
    if radial:
        return RADIAL_SIDES_TOP_STEPS if sides else RADIAL_TOP_STEPS
    return SIDES_TOP_STEPS if sides else MAX_STEPS


# -- the gate ---------------------------------------------------------------------------------
@dataclass(frozen=True)
class AffineLaplaceSpec:
    """Everything one kernel pass needs, decided from the configuration."""

    shape: tuple[int, int]
    k: int
    a: float
    b: float
    sx: float  # 1/dx² along rows (axis 0)
    sy: float  # 1/dy² along columns (axis 1)
    periodic: tuple[bool, bool]
    #: (const, f1, f2) of the row-low, row-high, column-low, column-high sides
    sides: tuple[tuple[float, float, float], ...]
    dtype: torch.dtype
    #: the kernel's plan at this k and dtype (:func:`affine_row_plan`)
    tile: tuple[int, int, int, int]
    #: (r of the inner edge, dr) on a cylindrical grid (the radial mode), else None
    radial: tuple[float, float] | None
    #: per side (row-low, row-high, column-low, column-high): whether its const
    #: is a per-point array, and whether a time-dependent const adds to it
    #: (the side inputs of B1(c); the pass then takes an :class:`AffineSides`)
    side_arrays: tuple[bool, bool, bool, bool] = (False,) * 4
    side_t: tuple[bool, bool, bool, bool] = (False,) * 4
    #: the corner weight w of the 9-point Laplacian (0: the 5-point stencil)
    corner: float = 0.0
    #: whether the pass takes the deep march (k past the register march's top
    #: in its mode, :func:`register_top`)
    deep: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the pass computes in (float32 for bf16 storage)."""
        return compute_dtype(self.dtype)

    @property
    def has_sides(self) -> bool:
        """Whether the pass takes side inputs (:class:`AffineSides`)."""
        return any(self.side_arrays) or any(self.side_t)

    def table_rows(self) -> int:
        """Rows of the grid whose radial table (:func:`radial_rows`) and
        column sides' tables the passes read: the grid's own."""
        return self.shape[0]

    def table_cols(self) -> int:
        """Columns of the grid whose row sides' tables the passes read."""
        return self.shape[1]


def _has_side_inputs(grid, bcs) -> bool:
    """Whether some side's const varies along it or in time."""
    specs = None if bcs is None else affine_bc_specs(grid, bcs)
    return specs is not None and collect_bc_side_inputs({0: specs}) is not None


def affine_laplace_spec(grid, *, a: float, b: float, k: int, dtype, bcs=None,
                        ext_cols: bool | None = None) -> AffineLaplaceSpec:
    """Check that the kernel supports a configuration and describe it.

    bf16 data (B1(f)) goes where ``pde_tpu``'s kernels take it: kernel #1
    (`ext_cols` None) where the columns are periodic, on Cartesian and
    cylindrical grids; the ext kernel #12 (`ext_cols`: whether the mesh cuts
    the columns) where the mesh cuts them; never in the 9-point mode.
    Raises :class:`KernelUnsupportedError` exactly where the configuration
    is not supported; nothing here builds or touches a device.
    """
    cylindrical = isinstance(grid, CylindricalSymGrid)
    if not (cylindrical or isinstance(grid, CartesianGrid)) or grid.num_axes != 2:
        raise KernelUnsupportedError("The kernel requires a 2D CartesianGrid or a "
                                     "CylindricalSymGrid")
    if dtype not in _DTYPES and dtype != torch.bfloat16:
        raise KernelUnsupportedError(
            f"The kernel takes float32 or float64 data (bfloat16 where pde_tpu's gates take "
            f"it), not {dtype}")
    # the corner-weight key alters the 2D Cartesian stencil only (pde_tpu's
    # radial mode ignores it, pde_tpu/ops/pallas_cartesian.py:837-840)
    corner = 0.0 if cylindrical else _corner_weight()
    if dtype == torch.bfloat16:
        if corner != 0.0:
            raise bf16_refusal("the 9-point corner-weight mode",
                               "ops/pallas_cartesian.py:841-849, 5847-5855")
        if ext_cols is False:
            raise bf16_refusal("kernel #12 where the mesh does not cut the columns",
                               "ops/pallas_cartesian.py:5764-5767, parallel/fused.py:152-158")
        if ext_cols is None and not (bcs is None or bcs[1].periodic):
            raise bf16_refusal(
                "kernel #1 where the columns (z) are bounded",
                "ops/pallas_cartesian.py:5455-5467" if cylindrical else
                "ops/pallas_cartesian.py:775-790, 889-899")
    if corner != 0.0:
        if bcs is not None or not all(grid.periodic):
            raise KernelUnsupportedError(
                "The fused 9-point corner-weight Laplacian requires a fully periodic 2D "
                "Cartesian grid, as pde_tpu's gate (pde_tpu/ops/pallas_cartesian.py:841-849)")
        if k > CORNER_TOP_STEPS:
            raise KernelUnsupportedError(
                f"The fused 9-point corner-weight Laplacian caps the temporal block at "
                f"k={CORNER_TOP_STEPS}, as pde_tpu's gate (pde_tpu/ops/pallas_cartesian.py:"
                "850-860)")
    if not 1 <= k <= DEEP_MAX_STEPS:
        raise KernelUnsupportedError(
            f"The kernel takes 1 <= k <= {DEEP_MAX_STEPS} steps, not {k}, as pde_tpu's geometry "
            "gate (pde_tpu/ops/pallas_cartesian.py:190)")
    if cylindrical and bcs is None:
        raise KernelUnsupportedError("Cylindrical grids require explicit boundary conditions")
    if bcs is None and not all(grid.periodic):
        raise KernelUnsupportedError("Non-periodic grids require explicit boundary conditions")
    specs = None if bcs is None else affine_bc_specs(grid, bcs)
    sides = []
    periodic = []
    side_arrays, side_t = [], []
    for ax in range(2):
        axis_specs = None if specs is None else specs[ax]
        periodic.append(axis_specs is None)
        if axis_specs is None:
            sides += [(0.0, 0.0, 0.0)] * 2
            side_arrays += [False] * 2
            side_t += [False] * 2
            continue
        if grid.shape[ax] < 2:
            raise KernelUnsupportedError(
                "A non-periodic axis needs at least 2 cells for the kernel"
            )
        for side in axis_specs:
            if side.const_xt is not None or np.ndim(side.f1) or np.ndim(side.f2) or side.f1_t:
                raise KernelUnsupportedError(
                    "Consts varying in space and time, per-point factors and time-dependent "
                    "factors are not taken by kernel #1; the expression window (kernel #7) "
                    "takes them, as in pde_tpu (ROADMAP B1(c))")
            array = np.ndim(side.const_static) > 0
            sides.append((0.0 if array else side.const_static, side.f1, side.f2))
            side_arrays.append(array)
            side_t.append(side.const_t is not None)
    sx, sy = (1.0 / grid.discretization**2).tolist()
    radial = None
    if cylindrical:
        radial = (float(grid.axes_bounds[0][0]), float(grid.discretization[0]))
    itemsize = _DTYPES[compute_dtype(dtype)][2]
    has_sides = any(side_arrays) or any(side_t)
    deep = k > register_top(cylindrical, has_sides, bool(corner))
    if corner:
        tile = corner_row_plan(k, itemsize)
    elif deep:
        tile = affine_deep_plan(k, itemsize, cylindrical, has_sides)
    else:
        tile = affine_row_plan(k, itemsize)
    return AffineLaplaceSpec(
        shape=tuple(grid.shape), k=int(k), a=float(a), b=float(b), sx=sx, sy=sy,
        periodic=tuple(periodic), sides=tuple(sides), dtype=dtype, tile=tile,
        radial=radial, side_arrays=tuple(side_arrays), side_t=tuple(side_t), corner=corner,
        deep=deep,
    )


# -- the side inputs of B1(c) -------------------------------------------------------------------
@dataclass(frozen=True)
class AffineSides:
    """The side inputs of one pass: per side (row-low, row-high, column-low,
    column-high) its per-point consts, a tensor of the pass's compute dtype
    on the data's device or None (a row side's along the columns, grid
    column j at ``j + row_pad``; a column side's along the rows, padded by
    :data:`SIDE_PAD` rows at either end: grid row i at ``i + SIDE_PAD``;
    padding wraps on a periodic axis and repeats the edge values otherwise),
    and the pass's t-table, the time-dependent consts at each of its k
    steps, ``(k, 4)`` host floats (0 where a side has none) or None. For bf16
    data both hold bf16-rounded values (in float32), as ``pde_tpu`` casts its
    tables to the data's dtype. The serial kernel's row sides are not padded
    (``row_pad`` 0); the ext kernel's are, by :data:`SIDE_PAD` columns. The
    deep march reads the tables as they are; the register march, from the
    pad's row (column) ``SIDE_PAD - REGISTER_SIDE_PAD`` on
    (:func:`side_pointers`)."""

    arrays: tuple
    t: tuple | None = None
    row_pad: int = 0


class AffineSideInputs:
    """Where kernel #1's side inputs come from: the per-point consts and the
    time-dependent consts of each side, from :func:`affine_bc_specs`. Made
    once per window; :meth:`for_pass` gives each pass its
    :class:`AffineSides`."""

    def __init__(self, grid, bcs):
        specs = affine_bc_specs(grid, bcs)
        flat = [None] * 4 if specs is None else [
            side for pair in specs for side in (pair if pair is not None else (None, None))]
        self.shape = tuple(grid.shape)
        self.periodic = tuple(bool(p) for p in grid.periodic)
        #: per side its per-point consts (numpy float64) or None
        self.arrays = [None if s is None or np.ndim(s.const_static) == 0
                       else np.asarray(s.const_static, dtype=float).reshape(-1) for s in flat]
        #: per side its time-dependent const ``t -> float`` or None
        self.t_funcs = [None if s is None else s.const_t for s in flat]
        self._tensors: dict = {}

    @property
    def needs_t(self) -> bool:
        return any(fn is not None for fn in self.t_funcs)

    def tensors(self, dtype, device, row_pad: int = 0) -> tuple:
        """The per-point consts as the kernel reads them on `dtype` data (see
        :class:`AffineSides`; `row_pad`: the row sides' padding), made once
        per dtype, device and padding."""
        key = (dtype, torch.device(device), row_pad)
        if key not in self._tensors:
            out = []
            for i, arr in enumerate(self.arrays):
                if arr is None:
                    out.append(None)
                    continue
                axis = 0 if i >= 2 else 1  # the axis a side's values run along
                pad = SIDE_PAD if i >= 2 else row_pad
                if pad:
                    n = self.shape[axis]
                    cells = np.arange(-pad, n + pad)
                    arr = arr[cells % n if self.periodic[axis] else cells.clip(0, n - 1)]
                out.append(rounded_table(arr, dtype).to(device).contiguous())
            self._tensors[key] = tuple(out)
        return self._tensors[key]

    def t_table(self, times, dtype=torch.float64) -> tuple | None:
        """The t-table of a pass on `dtype` data whose steps start at `times`
        (host floats; bf16-rounded for bf16 data)."""
        if not self.needs_t:
            return None
        table = [[0.0 if fn is None else fn(t) for fn in self.t_funcs] for t in times]
        if dtype == torch.bfloat16:
            table = rounded_table(torch.tensor(table, dtype=torch.float64), dtype).tolist()
        return tuple(tuple(row) for row in table)

    def for_pass(self, dtype, device, times=(), row_pad: int = 0) -> AffineSides:
        """The :class:`AffineSides` of a pass on `dtype` data whose steps start
        at `times` (the ext kernel's: ``row_pad=SIDE_PAD``)."""
        return AffineSides(self.tensors(dtype, device, row_pad), self.t_table(times, dtype),
                           row_pad)


def side_pointers(spec, sides: AffineSides) -> ctypes.Array:
    """The 4 device pointers of a pass's side tables as its kernel reads them
    (0 where a side has none): the deep march's as they are, the register
    march's (compiled with ``kSidePad`` = :data:`REGISTER_SIDE_PAD`) past the
    first ``SIDE_PAD - REGISTER_SIDE_PAD`` entries of each pad."""
    skip = 0 if spec.deep else SIDE_PAD - REGISTER_SIDE_PAD
    pointers = []
    for i, arr in enumerate(sides.arrays):
        padded = i >= 2 or sides.row_pad  # a column side's, or an ext row side's
        pointers.append(None if arr is None else
                        arr.data_ptr() + (skip * arr.element_size() if padded else 0))
    return (ctypes.c_void_p * 4)(*pointers)


def side_index(g, n: int, periodic: bool):
    """The index into a column side's padded table (:class:`AffineSides`) of
    grid rows `g` (a tensor; rows past the pad read its last entries)."""
    g = g % n if periodic else g.clamp(-SIDE_PAD, n - 1 + SIDE_PAD)
    return g + SIDE_PAD


def side_const(spec, sides, i: int, s: int, pos=None):
    """The additive ghost const of side `i` (row-low, row-high, column-low,
    column-high) at step `s` of a pass: its scalar, or its per-point consts
    at `pos` (an index tensor into the side's array of :class:`AffineSides`;
    None: the whole grid side, shaped to broadcast along it), plus its
    t-table entry in the data's dtype, as the kernel adds them."""
    c = spec.sides[i][0]
    if sides is None:
        return c
    arr = sides.arrays[i]
    if arr is not None:
        if pos is None:
            n, m = spec.shape
            arr = (arr[SIDE_PAD:SIDE_PAD + n, None] if i >= 2
                   else arr[None, sides.row_pad:sides.row_pad + m])
        c = arr if pos is None else arr[pos]
    if spec.side_t[i]:
        c = c + torch.tensor(sides.t[s][i], dtype=spec.compute_dtype)
    return c


def _sided(spec, sides, i: int, s: int, pos=None) -> tuple:
    """Side `i`'s ghost formula ``(const, f1, f2)`` at step `s`."""
    _, f1, f2 = spec.sides[i]
    return side_const(spec, sides, i, s, pos), f1, f2


# -- the radial mode's row factors ----------------------------------------------------------------
def radial_constants(spec) -> tuple[float, float]:
    """``(a - 2b*sx - 2b*sy, b*sy)``: the centre's and the column
    neighbours' factors of the radial mode, in ``pde_tpu``'s order."""
    return spec.a - 2.0 * spec.b * spec.sx - 2.0 * spec.b * spec.sy, spec.b * spec.sy


def radial_rows(spec, device) -> torch.Tensor:
    """The radial mode's row factors ``(cu, cd)`` of grid rows
    ``-RADIAL_PAD .. n_rows + RADIAL_PAD - 1`` (row i at index
    ``i + RADIAL_PAD``; n_rows the grid's, ``spec.table_rows()``, also for the
    blocks of a decomposed grid), an ``(n_rows + 2*RADIAL_PAD, 2)`` tensor of the
    spec's dtype on `device`: ``r = (row + 0.5)*dr + r_lo``,
    ``fac = (b / (2 dr)) / r``, ``cu = b*sx - fac``, ``cd = b*sx + fac``, in
    that dtype, as ``pde_tpu``'s ``_radial_row_coeffs`` computes them. A row
    beyond an edge gets finite factors (r is never 0 at a cell centre or a
    ghost row within the pad of a grid whose inner edge is at r >= 0) that
    the ghosts make irrelevant. Made once per grid, b, dtype and device."""
    return _radial_table(spec.table_rows(), *spec.radial, spec.b, spec.sx, spec.compute_dtype,
                         torch.device(device))


@functools.cache
def _radial_table(n_rows: int, r_lo: float, dr: float, b: float, sx: float, dtype, device):
    rows = torch.arange(-RADIAL_PAD, n_rows + RADIAL_PAD, dtype=dtype)
    fac = (b / (2.0 * dr)) / ((rows + 0.5) * dr + r_lo)
    return torch.stack([b * sx - fac, b * sx + fac], dim=1).contiguous().to(device)


def radial_row_factors(spec, rows, device=None):
    """``(cu, cd)`` of the grid rows `rows` (an int or an index tensor; a
    tensor gives columns that broadcast along the rows of a plane)."""
    table = radial_rows(spec, "cpu" if device is None else device)
    if isinstance(rows, int):
        return table[rows + RADIAL_PAD, 0], table[rows + RADIAL_PAD, 1]
    # rows past the pad lie outside the domain, where no factor matters
    index = torch.as_tensor(rows, device=table.device).clamp(
        -RADIAL_PAD, spec.table_rows() + RADIAL_PAD - 1) + RADIAL_PAD
    return table[index, 0:1], table[index, 1:2]


# -- plain version ------------------------------------------------------------------------
def _ghost(side, edge, inward):
    """``c + f1*edge (+ f2*inward)``, in the order of the kernel."""
    const, f1, f2 = side
    ghost = const + f1 * edge
    if isinstance(f2, torch.Tensor) or f2:  # a per-point factor is always added
        ghost = ghost + f2 * inward
    return ghost


def _neighbours(f, axis: int, periodic: bool, lo, hi):
    """(previous, next) neighbour arrays of `f` along `axis`."""
    if periodic:
        return torch.roll(f, 1, axis), torch.roll(f, -1, axis)
    n = f.shape[axis]
    ghost_lo = _ghost(lo, f.narrow(axis, 0, 1), f.narrow(axis, 1, 1))
    ghost_hi = _ghost(hi, f.narrow(axis, n - 1, 1), f.narrow(axis, n - 2, 1))
    prev = torch.cat([ghost_lo, f.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([f.narrow(axis, 1, n - 1), ghost_hi], axis)
    return prev, nxt


def corner_factors(spec) -> tuple[float, float, float, float]:
    """The 9-point Laplacian's factors of the row neighbours, the column
    neighbours, the diagonals and the centre, ``(1-w)*sx``, ``(1-w)*sy``,
    ``w/4*(sx+sy)`` and ``(w-2)*(sx+sy)``, in double as ``pde_tpu`` forms them
    (``pde_tpu/ops/pallas_cartesian.py:1096-1108``)."""
    w = spec.corner
    dm2 = spec.sx + spec.sy
    return (1.0 - w) * spec.sx, (1.0 - w) * spec.sy, 0.25 * w * dm2, (w - 2.0) * dm2


def corner_update(spec, center, up, down, h, hu, hd):
    """One 9-point step from the centre, its row neighbours, ``h = left +
    right`` of its row and ``hu``, ``hd``, those of the rows above and below,
    in the order of the kernel's ``corner_update_2d``."""
    cud, clr, cdg, cc = corner_factors(spec)
    lap9 = cud * (up + down) + clr * h + cdg * (hu + hd) + cc * center
    return spec.a * center + spec.b * lap9


def _update(spec: AffineLaplaceSpec, center, up, down, left, right, rows=None):
    """One 5-point step of ``a*f + b*lap(f)`` from the five stencil values; in
    the radial mode `rows` holds the row factors ``(cu, cd)`` of the centres'
    rows (:func:`radial_row_factors`)."""
    if spec.radial is not None:
        cu, cd = rows
        cc, bsy = radial_constants(spec)
        return cu * up + cd * down + bsy * (left + right) + cc * center
    if spec.sx == spec.sy:
        lap4 = up + down + left + right - 4.0 * center
        return spec.a * center + (spec.b * spec.sx) * lap4
    lap = (up + down - 2.0 * center) * spec.sx + (left + right - 2.0 * center) * spec.sy
    return spec.a * center + spec.b * lap


def affine_laplace_2d_plain(data: torch.Tensor, spec: AffineLaplaceSpec,
                            sides: AffineSides | None = None) -> torch.Tensor:
    """k plain PyTorch steps of ``f <- a*f + b*lap(f)`` (rolls for periodic
    axes, the ghost formula for affine sides, with the pass's side inputs
    `sides` where the spec has them; in the radial mode the cylindrical
    Laplacian with the row factors of :func:`radial_rows`). bf16 data steps
    in float32, every level rounded to bf16 (:func:`round_level`)."""
    rows = None
    if spec.radial is not None:
        rows = radial_row_factors(spec, torch.arange(spec.shape[0]), data.device)
    f = data.to(spec.compute_dtype)
    for s in range(spec.k):
        row_lo, row_hi, col_lo, col_hi = (_sided(spec, sides, i, s) for i in range(4))
        up, down = _neighbours(f, 0, spec.periodic[0], row_lo, row_hi)
        left, right = _neighbours(f, 1, spec.periodic[1], col_lo, col_hi)
        if spec.corner:  # fully periodic
            h = left + right
            f = corner_update(spec, f, up, down, h, torch.roll(h, 1, 0), torch.roll(h, -1, 0))
        else:
            f = round_level(_update(spec, f, up, down, left, right, rows), spec.dtype)
    return f.to(spec.dtype)


# -- emulation of the kernel's blocks ----------------------------------------------------------
def window_steps_2d(cur: torch.Tensor, spec, edges, gr0: int, gc0: int,
                    row0: int = 0, sides: AffineSides | None = None,
                    col0: int = 0) -> torch.Tensor:
    """k steps on a window whose cell (0, 0) is cell (gr0, gc0) of the grid (of
    the block, in the ext kernel), as a kernel's block computes them; returns
    the window's centre (k cells in from every side). In the radial mode the
    factors of window row i are those of grid row ``row0 + gr0 + i`` (`row0`:
    the block's first row in the grid).

    ``edges`` (row low, row high, column low, column high) says which sides of
    ``spec.shape`` have ghosts: beyond them the cells are held at zero, and at
    every step the ghost row or column is rewritten from the current level's
    edge and next-inward cells over the valid region (with the side inputs
    `sides` of the pass, where it has them, read at the cells' places in the
    grid: the block's first row and column there are `row0` and `col0`).
    Elsewhere the window's cells are trusted. bf16 data steps in float32,
    every level rounded to bf16; the centre comes back in the data's dtype."""
    k = spec.k
    n_rows, n_cols = spec.shape
    e_rlo, e_rhi, e_clo, e_chi = edges
    cur = cur.to(spec.compute_dtype)
    w_rows, w_cols = cur.shape
    gr = torch.arange(gr0, gr0 + w_rows, device=cur.device)
    gc = torch.arange(gc0, gc0 + w_cols, device=cur.device)
    row_in = ((gr >= 0) | (not e_rlo)) & ((gr < n_rows) | (not e_rhi))
    col_in = ((gc >= 0) | (not e_clo)) & ((gc < n_cols) | (not e_chi))
    inside = row_in[:, None] & col_in[None, :]
    zero = torch.zeros((), dtype=cur.dtype)
    cur = torch.where(inside, cur, zero)
    g_row_lo, g_row_hi = -1 - gr0, n_rows - gr0
    g_col_lo, g_col_hi = -1 - gc0, n_cols - gc0
    # the side inputs' positions: a row side's along the window's columns, a
    # column side's along its rows, at their places in the grid
    grid_cols = spec.table_cols()
    col_pos = gc + col0
    col_pos = col_pos % grid_cols if spec.periodic[1] else col_pos.clamp(0, grid_cols - 1)
    if sides is not None:
        col_pos = col_pos + sides.row_pad
    row_pos = side_index(gr + row0, spec.table_rows(), spec.periodic[0])
    for s in range(k):
        rows, cols = slice(s, w_rows - s), slice(s, w_cols - s)
        row_lo, row_hi = (_sided(spec, sides, i, s, col_pos[cols]) for i in (0, 1))
        col_lo, col_hi = (_sided(spec, sides, i, s, row_pos[rows]) for i in (2, 3))
        lo_r, hi_r, lo_c, hi_c = s, w_rows - s, s, w_cols - s
        keep = col_in[cols]
        if e_rlo and lo_r <= g_row_lo and g_row_lo + 2 < hi_r:
            g = g_row_lo
            new = _ghost(row_lo, cur[g + 1, cols], cur[g + 2, cols])
            cur[g, cols] = torch.where(keep, new, cur[g, cols])
        if e_rhi and lo_r <= g_row_hi - 2 and g_row_hi < hi_r:
            g = g_row_hi
            new = _ghost(row_hi, cur[g - 1, cols], cur[g - 2, cols])
            cur[g, cols] = torch.where(keep, new, cur[g, cols])
        keep = row_in[rows]
        if e_clo and lo_c <= g_col_lo and g_col_lo + 2 < hi_c:
            g = g_col_lo
            new = _ghost(col_lo, cur[rows, g + 1], cur[rows, g + 2])
            cur[rows, g] = torch.where(keep, new, cur[rows, g])
        if e_chi and lo_c <= g_col_hi - 2 and g_col_hi < hi_c:
            g = g_col_hi
            new = _ghost(col_hi, cur[rows, g - 1], cur[rows, g - 2])
            cur[rows, g] = torch.where(keep, new, cur[rows, g])
        inner_r, inner_c = slice(lo_r + 1, hi_r - 1), slice(lo_c + 1, hi_c - 1)
        rows = None
        if spec.radial is not None:
            rows = radial_row_factors(spec, gr[inner_r] + row0, cur.device)
        if spec.corner:  # left + right of every row: a row's own and its diagonals' sums
            h = cur[lo_r:hi_r, lo_c : hi_c - 2] + cur[lo_r:hi_r, lo_c + 2 : hi_c]
            value = corner_update(spec, cur[inner_r, inner_c], cur[lo_r : hi_r - 2, inner_c],
                                  cur[lo_r + 2 : hi_r, inner_c], h[1:-1], h[:-2], h[2:])
        else:
            value = _update(
                spec,
                cur[inner_r, inner_c],
                cur[lo_r : hi_r - 2, inner_c],
                cur[lo_r + 2 : hi_r, inner_c],
                cur[inner_r, lo_c : hi_c - 2],
                cur[inner_r, lo_c + 2 : hi_c],
                rows,
            )
        nxt = cur.clone()
        nxt[inner_r, inner_c] = torch.where(inside[inner_r, inner_c],
                                            round_level(value, spec.dtype), zero)
        cur = nxt
    return cur[k : w_rows - k, k : w_cols - k].to(spec.dtype)


def block_plan(spec, tile=None) -> tuple[int, int]:
    """The strip width and chunk length ``(tx, chunk)`` of a 2D affine
    kernel's blocks: `tile` as a pair, an int for both, or None for the
    kernel's strip and the chunk a launch over one grid or block picks
    (:func:`.cuda_stencil_2d.chunk_rows`)."""
    if tile is None:
        from .cuda_stencil_2d import chunk_rows

        tx = spec.tile[0]
        return tx, chunk_rows(spec.shape[0], -(-spec.shape[1] // tx))
    if isinstance(tile, int):
        return tile, tile
    tx, chunk = tile
    return int(tx), int(chunk)


def affine_laplace_2d_tiled(
    data: torch.Tensor, spec: AffineLaplaceSpec, tile=None, sides: AffineSides | None = None
) -> torch.Tensor:
    """Pure-torch emulation of the values the kernel's blocks compute, block
    by block (`tile`: see :func:`block_plan`).

    Each block of `tx` columns and `chunk` rows takes a window with k-deep
    halos on all four sides (periodic halos wrapped, so blocks smaller than
    the halo wrap more than once; zeros outside non-periodic sides), runs the
    k steps of :func:`window_steps_2d` and keeps its centre.
    """
    tx, chunk = block_plan(spec, tile)
    n_rows, n_cols = spec.shape
    k = spec.k
    rows_periodic, cols_periodic = spec.periodic
    edges = (not rows_periodic,) * 2 + (not cols_periodic,) * 2
    out = torch.empty_like(data)
    for row0 in range(0, n_rows, chunk):
        for col0 in range(0, n_cols, tx):
            gr = torch.arange(row0 - k, row0 + chunk + k)
            gc = torch.arange(col0 - k, col0 + tx + k)
            r = gr % n_rows if rows_periodic else gr.clamp(0, n_rows - 1)
            c = gc % n_cols if cols_periodic else gc.clamp(0, n_cols - 1)
            centre = window_steps_2d(data[r][:, c], spec, edges, row0 - k, col0 - k,
                                     sides=sides)
            n_r, n_c = min(chunk, n_rows - row0), min(tx, n_cols - col0)
            out[row0 : row0 + n_r, col0 : col0 + n_c] = centre[:n_r, :n_c]
    return out


# -- replay of the kernel's march --------------------------------------------------------------
def affine_row_block(win, spec, rows: int, store, sides: AffineSides | None = None) -> None:
    """One block's march as the kernel schedules it (``AffineRowMarch`` of
    ``csrc/affine_march_2d.cuh``) on the :class:`.cuda_march.MarchWindow`
    `win`, over `rows` window rows.

    Iteration t brings level 0 of window row t into its thread's registers
    and its level's shared row; then, for s = 0 .. k - 1, level s + 1 of row
    w = t - s - 1 is computed on every window column from the thread's three
    registers of level s (rows w - 1, w, w + 1; register y % 3 holds row y)
    and the column neighbours in level s's shared row of w (slot w % 2), and
    goes into level s + 1's register and shared row of w; level k of row w
    goes to ``store(w, [values], mask)`` once w >= k. Registers and shared
    rows start as NaN (a shared row also has a NaN pad cell on each side), so
    a read of a value the schedule has not written yet, or has overwritten,
    poisons the result unless no written cell depends on it; between two
    barriers the threads race, so a read of other threads' cells from a
    shared row that any thread stores to in the same iteration reads NaN too.
    Ghosts are formed where they are read: a row's flags from
    ``win.plane(w)``, a column's from ``win.edges``; in the radial mode each
    level reads the factors of its row's grid row ``win.row(w)`` from the
    table. Registers and shared rows hold the compute dtype; a bf16 pass
    rounds every level it keeps to bf16, as the kernel does."""
    k = spec.k
    wx = win.load.shape[0]
    work = spec.compute_dtype
    nan = torch.full((wx,), float("nan"), dtype=work)
    padded = torch.full((wx + 2,), float("nan"), dtype=work)
    zero = torch.zeros((), dtype=work)
    regs = {(s, j): nan for s in range(k) for j in range(3)}
    smem = {(s, r): padded.clone() for s in range(k) for r in range(ROW_SLOTS)}
    col_lo, col_hi = win.edges
    for t in range(rows):
        written = {(0, t % ROW_SLOTS)} | {(s + 1, (t - s - 1) % ROW_SLOTS) for s in range(k - 1)}
        new = torch.where(win.load & win.plane(t)[0], win.read(t)[0].to(work), zero)
        regs[(0, t % 3)] = new
        smem[(0, t % ROW_SLOTS)][1 : wx + 1] = new
        for s in range(k):
            w = t - s - 1
            center, up, down = regs[(s, w % 3)], regs[(s, (w - 1) % 3)], regs[(s, (w + 1) % 3)]
            key = (s, w % ROW_SLOTS)
            shared = padded if key in written else smem[key]
            left, right = shared[:wx], shared[2:]
            if not spec.periodic[0]:
                _, _, lo, hi = win.plane(w)
                if lo:
                    up = _ghost(_sided(spec, sides, 0, s, win.cols), center, down)
                if hi:
                    down = _ghost(_sided(spec, sides, 1, s, win.cols), center, up)
            if not spec.periodic[1]:
                row = None
                if sides is not None:
                    row = side_index(torch.tensor(win.row(w)), spec.table_rows(),
                                     spec.periodic[0])
                left = torch.where(col_lo, _ghost(_sided(spec, sides, 2, s, row), center, right),
                                   left)
                right = torch.where(col_hi, _ghost(_sided(spec, sides, 3, s, row), center, left),
                                    right)
            rows = None if spec.radial is None else radial_row_factors(spec, win.row(w))
            value = round_level(_update(spec, center, up, down, left, right, rows), spec.dtype)
            if s + 1 < k:
                regs[(s + 1, w % 3)] = value
                smem[(s + 1, w % ROW_SLOTS)][1 : wx + 1] = value
            elif t >= 2 * k:
                store(w, [value], win.out)


def corner_row_block(win, spec, rows: int, store) -> None:
    """One block's 9-point march as the kernel schedules it (``CornerRowMarch``
    of ``csrc/affine_march_2d.cuh``) on the fully periodic window `win`, over
    `rows` window rows, as :func:`affine_row_block` replays the 5-point one.

    Iteration t (of ``rows + k``) runs the levels from the top down: level s
    computes level s + 1 of window row w = t - 2s - 2 on every window column
    from the thread's registers of level s (its column of rows w - 1, w, w + 1,
    register y % 3 for row y, and ``left + right`` of rows w - 1 and w, kept
    from earlier iterations) and ``left + right`` of row w + 1, read from level
    s's shared row of w + 1 (slot (w + 1) % 2) and kept; the value goes into
    level s + 1's register and shared row of w. Then level 0 of window row t
    enters its register and shared row. Level k of row w goes to ``store(w,
    [values], mask)`` once w >= k. Registers and shared rows start as NaN, and
    a shared row that any level stores to in an iteration reads as NaN in it,
    so a read the schedule does not order poisons the result."""
    k = spec.k
    wx = win.load.shape[0]
    nan = torch.full((wx,), float("nan"), dtype=spec.dtype)
    padded = torch.full((wx + 2,), float("nan"), dtype=spec.dtype)
    zero = torch.zeros((), dtype=spec.dtype)
    regs = {(s, j): nan for s in range(k) for j in range(3)}
    sums = {(s, j): nan for s in range(k) for j in range(3)}
    smem = {(s, r): padded.clone() for s in range(k) for r in range(ROW_SLOTS)}
    for t in range(rows + k):
        written = {(0, t % ROW_SLOTS)} | {(s + 1, (t - 2 * s - 2) % ROW_SLOTS)
                                          for s in range(k - 1)}
        for s in reversed(range(k)):
            w = t - 2 * s - 2
            key = (s, (w + 1) % ROW_SLOTS)
            shared = padded if key in written else smem[key]
            hd = shared[:wx] + shared[2:]
            sums[(s, (w + 1) % 3)] = hd
            value = corner_update(spec, regs[(s, w % 3)], regs[(s, (w - 1) % 3)],
                                  regs[(s, (w + 1) % 3)], sums[(s, w % 3)],
                                  sums[(s, (w - 1) % 3)], hd)
            if s + 1 < k:
                regs[(s + 1, w % 3)] = value
                smem[(s + 1, w % ROW_SLOTS)][1 : wx + 1] = value
            elif w >= k:
                store(w, [value], win.out)
        new = torch.where(win.load & win.plane(t)[0], win.read(t)[0], zero) if t < rows else nan
        regs[(0, t % 3)] = new
        smem[(0, t % ROW_SLOTS)][1 : wx + 1] = new


def affine_deep_block(win, spec, rows: int, store, sides: AffineSides | None = None) -> None:
    """One block's deep march as the kernel schedules it (``AffineDeepMarch``
    of ``csrc/affine_deep_2d.cuh``) on the :class:`.cuda_march.MarchWindow`
    `win`, over `rows` window rows, k a number like any other.

    Each level keeps :data:`DEEP_SLOTS` shared rows, level s of window row y
    in slot y % 3, a pad cell on each side. Iteration t writes level 0 of
    window row t; then, for s = 0 .. min(t, k) - 1, level s + 1 of row
    w = t - s - 1 is computed on every window column from level s's rows
    w - 1, w and w + 1 (each thread's own column) and the column neighbours in
    row w, and goes into level s + 1's slot of w; level k of row w goes to
    ``store(w, [values], mask)`` once w >= k. The rows start as NaN (the
    kernel zeroes them), so a read of a value the schedule has not written
    poisons the result unless no written cell depends on it; a read of other
    threads' cells from a slot written in the same iteration reads NaN too
    (between two barriers the threads race). The radial mode reads its
    factors from the block's copy of the window rows' slice of the radial
    table, a column side's const at its table's entry of the row's grid row,
    unwrapped and unclamped, as the kernel indexes them: a slice or an entry
    past a table raises."""
    k = spec.k
    wx = win.load.shape[0]
    work = spec.compute_dtype
    ring = torch.full((k, DEEP_SLOTS, wx + 2), float("nan"), dtype=work)
    unwritten = torch.full((wx + 2,), float("nan"), dtype=work)
    zero = torch.zeros((), dtype=work)
    factors = None
    if spec.radial is not None:  # the block's copy of its window rows' factors
        table = radial_rows(spec, "cpu")
        first = win.row(0) + RADIAL_PAD
        if first < 0 or first + rows > table.shape[0]:
            raise IndexError(f"Window rows {first}..{first + rows - 1} past the radial table")
        factors = table[first:first + rows]
    col_lo, col_hi = win.edges
    for t in range(rows):
        ring[0, t % DEEP_SLOTS, 1:wx + 1] = torch.where(win.load & win.plane(t)[0],
                                                         win.read(t)[0].to(work), zero)
        written = {(0, t % DEEP_SLOTS)}
        for s in range(min(t, k)):
            w = t - s - 1
            level = ring[s]
            center = level[w % DEEP_SLOTS, 1:wx + 1]
            up, down = level[(w - 1) % DEEP_SLOTS, 1:wx + 1], level[(w + 1) % DEEP_SLOTS, 1:wx + 1]
            shared = unwritten if (s, w % DEEP_SLOTS) in written else level[w % DEEP_SLOTS]
            left, right = shared[:wx], shared[2:]
            if not spec.periodic[0]:
                _, _, lo, hi = win.plane(w)
                if lo:
                    up = _ghost(_sided(spec, sides, 0, s, win.cols), center, down)
                if hi:
                    down = _ghost(_sided(spec, sides, 1, s, win.cols), center, up)
            if not spec.periodic[1]:
                entry = win.row(w) + SIDE_PAD  # the kernel's side_base + w
                if sides is not None and not 0 <= entry < spec.table_rows() + 2 * SIDE_PAD:
                    raise IndexError(f"Window row {w}'s entry {entry} lies past the side tables")
                left = torch.where(col_lo, _ghost(_sided(spec, sides, 2, s, entry), center, right),
                                   left)
                right = torch.where(col_hi, _ghost(_sided(spec, sides, 3, s, entry), center, left),
                                    right)
            rows_f = None if factors is None else (factors[w, 0], factors[w, 1])
            value = round_level(_update(spec, center, up, down, left, right, rows_f), spec.dtype)
            if s + 1 < k:
                ring[s + 1, w % DEEP_SLOTS, 1:wx + 1] = value
                written.add((s + 1, w % DEEP_SLOTS))
            elif t >= 2 * k:
                store(w, [value], win.out)


def affine_laplace_2d_marched(
    data: torch.Tensor, spec: AffineLaplaceSpec, plan=None, sides: AffineSides | None = None
) -> torch.Tensor:
    """Pure-torch replay of the CUDA kernel's row march, block by block: see
    :func:`affine_row_block`. `plan` is ``(tx, chunk)`` (or one int for
    both): the strip width and the chunk length; by default the kernel's
    strip and the chunk its launch picks. Cells no block writes stay NaN."""
    from .cuda_stencil_2d import grid_row_window, row_blocks

    tx, chunk = block_plan(spec, plan)
    (out,) = row_blocks(
        spec.shape, spec.k, (tx, chunk),
        lambda origin, halo: grid_row_window([data], spec.shape, spec.periodic, origin, tx, halo),
        lambda win, rows, store: march_block(win, spec, rows, store, sides), 1, data.dtype)
    return out


def march_block(win, spec, rows: int, store, sides: AffineSides | None = None) -> None:
    """One block's march of the kernel that takes `spec`: the 9-point mode's
    (:func:`corner_row_block`), the deep march (:func:`affine_deep_block`) or
    the 5-point register march (:func:`affine_row_block`)."""
    if spec.corner:
        corner_row_block(win, spec, rows, store)
    elif spec.deep:
        affine_deep_block(win, spec, rows, store, sides)
    else:
        affine_row_block(win, spec, rows, store, sides)


# -- the CUDA build ----------------------------------------------------------------------------
def _nvcc() -> str:
    """Path of ``nvcc``: ``$PDE_TPU_TORCH_NVCC`` when set, else on PATH, else
    under PyTorch's detected CUDA home."""
    chosen = os.environ.get("PDE_TPU_TORCH_NVCC")
    if chosen:
        if not os.path.exists(chosen):
            raise RuntimeError(f"nvcc was not found at {chosen}: the CUDA kernels cannot be built")
        return chosen
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")


#: what each generated library exports: its entry points' parameters before
#: `ints`, and the launcher they call
_ENTRY = {
    "affine_laplace_2d": ("const void* in, void* out", "launch_affine_2d", "in, out"),
    "affine_laplace_ext_2d": (
        "const void* const* ins, void* const* outs, const int* edges, int n_blocks",
        "launch_affine_ext_2d", "ins, outs, edges, n_blocks"),
    RADIAL_LIBRARY: ("const void* in, void* out, const void* rows", "launch_affine_radial_2d",
                     "in, out, rows"),
    RADIAL_EXT_LIBRARY: (
        "const void* const* ins, void* const* outs, const int* edges, int n_blocks, "
        "const void* rows", "launch_affine_radial_ext_2d", "ins, outs, edges, n_blocks, rows"),
    SIDES_LIBRARY: ("const void* in, void* out, const void* const* arrays",
                    "launch_affine_sides_2d", "in, out, arrays"),
    SIDES_EXT_LIBRARY: (
        "const void* const* ins, void* const* outs, const int* edges, int n_blocks, "
        "const void* const* arrays", "launch_affine_sides_ext_2d",
        "ins, outs, edges, n_blocks, arrays"),
    RADIAL_SIDES_LIBRARY: (
        "const void* in, void* out, const void* rows, const void* const* arrays",
        "launch_affine_radial_sides_2d", "in, out, rows, arrays"),
    RADIAL_SIDES_EXT_LIBRARY: (
        "const void* const* ins, void* const* outs, const int* edges, int n_blocks, "
        "const void* rows, const void* const* arrays", "launch_affine_radial_sides_ext_2d",
        "ins, outs, edges, n_blocks, rows, arrays"),
    CORNER_LIBRARY: ("const void* in, void* out", "launch_affine_corner_2d", "in, out"),
    CORNER_EXT_LIBRARY: (
        "const void* const* ins, void* const* outs, const int* edges, int n_blocks",
        "launch_affine_corner_ext_2d", "ins, outs, edges, n_blocks"),
}
#: the ext libraries, whose entry points take a table of blocks
_EXT_LIBRARIES = ("affine_laplace_ext_2d", RADIAL_EXT_LIBRARY, CORNER_EXT_LIBRARY,
                   SIDES_EXT_LIBRARY, RADIAL_SIDES_EXT_LIBRARY)
#: the side-input libraries: k up to SIDES_TOP_STEPS (RADIAL_SIDES_TOP_STEPS in
#: the radial mode)
_SIDES_LIBRARIES = (SIDES_LIBRARY, SIDES_EXT_LIBRARY, RADIAL_SIDES_LIBRARY,
                    RADIAL_SIDES_EXT_LIBRARY)
#: the 9-point corner-weight libraries: fully periodic, k up to CORNER_TOP_STEPS
_CORNER_LIBRARIES = (CORNER_LIBRARY, CORNER_EXT_LIBRARY)
#: the radial libraries: their rows are never periodic, k up to RADIAL_TOP_STEPS
#: (with side inputs RADIAL_SIDES_TOP_STEPS)
_RADIAL_LIBRARIES = (RADIAL_LIBRARY, RADIAL_EXT_LIBRARY, RADIAL_SIDES_LIBRARY,
                     RADIAL_SIDES_EXT_LIBRARY)


def deep_library(library: str) -> str:
    """The deep march's library that takes a register library's modes past
    its top (``affine_laplace_radial_2d`` -> ``affine_laplace_deep_radial_2d``)."""
    return "affine_laplace_deep_" + library[len("affine_laplace_"):]


#: the deep march's libraries (``csrc/affine_deep_2d.cuh``), by the register
#: library whose modes they take past its top (:func:`register_top`): k at run
#: time, one entry point per dtype (or the bf16 storage type) for one
#: periodicity, with the register library's parameters. Kernel #12's Cartesian
#: passes stop at the register top (:data:`EXT_MAX_STEPS`), so it has none.
DEEP_LIBRARIES = {deep_library(name): name for name in (
    "affine_laplace_2d", RADIAL_LIBRARY, SIDES_LIBRARY, RADIAL_SIDES_LIBRARY,
    RADIAL_EXT_LIBRARY, SIDES_EXT_LIBRARY, RADIAL_SIDES_EXT_LIBRARY)}
_ENTRY.update({deep: _ENTRY[name] for deep, name in DEEP_LIBRARIES.items()})


def emit_source(library: str, periodic: tuple[bool, bool], bf16: bool = False) -> str:
    """The generated entry points of one 2D affine library
    (``affine_laplace_2d``, ``affine_laplace_ext_2d``, the radial modes of
    kernels #1 and #12, ``affine_laplace_radial_2d`` and
    ``affine_laplace_radial_ext_2d``, or the passes with side inputs of #1
    and #12, ``affine_laplace_sides_2d`` and ``affine_laplace_sides_ext_2d``,
    and of their radial modes, ``affine_laplace_radial_sides_2d`` and
    ``affine_laplace_radial_sides_ext_2d``, or the 9-point corner-weight mode
    of #1 and #12, ``affine_laplace_corner_2d`` and
    ``affine_laplace_corner_ext_2d``): the row march instantiated for every k
    and dtype at the plan :func:`affine_row_plan` picks for them (the radial
    modes: k up to :data:`RADIAL_TOP_STEPS`; the side inputs' up to
    :data:`SIDES_TOP_STEPS`; both together up to
    :data:`RADIAL_SIDES_TOP_STEPS`; the 9-point mode's up to
    :data:`CORNER_TOP_STEPS` at
    :func:`corner_row_plan`), for one periodicity of the two axes (the
    radial modes' rows are never periodic; the 9-point mode's axes always
    are). With `bf16` the library holds the bf16 storage entry points
    (``<library>_bf16``: the float32 march at its plan, loading and storing
    ``__nv_bfloat16``) instead of the float32 and float64 ones, so that those
    build as before."""
    params, launcher, args = _ENTRY[library]
    radial = library in _RADIAL_LIBRARIES
    corner = library in _CORNER_LIBRARIES
    if corner and not all(periodic):
        raise KernelUnsupportedError("The 9-point corner-weight mode takes fully periodic grids")
    if corner and bf16:
        raise KernelUnsupportedError("The 9-point corner-weight mode refuses bf16 storage")
    flags = ", ".join(str(bool(p)).lower() for p in periodic)
    what = f"periodic axes ({flags})" + (", the radial mode" if radial else "") + (
        ", with side inputs" if library in _SIDES_LIBRARIES else "") + (
        ", the 9-point corner-weight mode" if corner else "") + (
        ", bf16 storage" if bf16 else "")
    if radial:  # its template takes the columns' periodicity only
        flags = str(bool(periodic[1])).lower()
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_cartesian.py: one instantiation per",
        f"// (k, dtype) at its plan, for {what}; the kernel is the",
        "// template in pde_tpu_torch/csrc/affine_march_2d.cuh.",
        '#include "affine_march_2d.cuh"',
        "",
    ]
    # (C type, entry-point suffix, plan's itemsize, storage type's template argument)
    kinds = [("float", BF16[1], 4, f", {BF16[0]}")] if bf16 else [
        (ctype, suffix, itemsize, "") for ctype, suffix, itemsize in _DTYPES.values()]
    for ctype, suffix, itemsize, storage in kinds:
        lines += [
            f'extern "C" int {library}_{suffix}({params}, const int* ints,',
            "    const double* doubles, void* stream) {",
            f"  switch (ints[{5 if library in _EXT_LIBRARIES else 3}]) {{",
        ]
        for k in range(1, register_top(radial, library in _SIDES_LIBRARIES, corner) + 1):
            plan = ", ".join(map(str, (corner_row_plan if corner else affine_row_plan)(
                k, itemsize)))
            lines.append(
                f"    case {k}: return pde_tpu_torch::{launcher}<{ctype}, {k}, {plan}, {flags}"
                f"{storage}>({args}, ints, doubles, stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


def emit_deep_source(library: str, periodic: tuple[bool, bool], bf16: bool = False) -> str:
    """The generated entry points of one deep library (:data:`DEEP_LIBRARIES`):
    the deep march of ``csrc/affine_deep_2d.cuh`` in its register library's
    mode, one instantiation per dtype (with `bf16`, the bf16 storage entry
    point alone, as :func:`emit_source`), for one periodicity of the two axes;
    k, the strip and the chunk come at run time."""
    register = DEEP_LIBRARIES[library]
    params = _ENTRY[register][0]
    ext = register in _EXT_LIBRARIES
    radial = register in _RADIAL_LIBRARIES
    sides = register in _SIDES_LIBRARIES
    if radial and periodic[0]:
        raise KernelUnsupportedError("The radial mode's rows (r) are never periodic")
    launcher = "launch_affine_deep_ext_2d" if ext else "launch_affine_deep_2d"
    args = ", ".join(["ins, outs, edges, n_blocks" if ext else "in, out",
                      "rows" if radial else "nullptr", "arrays" if sides else "nullptr"])
    axes = ", ".join(str(bool(p)).lower() for p in periodic)
    flags = f"{str(radial).lower()}, {str(sides).lower()}, {axes}"
    what = (f"{'kernel #12' if ext else 'kernel #1'}, periodic axes ({axes})"
            + (", the radial mode" if radial else "") + (", with side inputs" if sides else "")
            + (", bf16 storage" if bf16 else ""))
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_cartesian.py: the deep march of",
        f"// {what}, one instantiation per dtype, k at run time; the kernel is the",
        "// template in pde_tpu_torch/csrc/affine_deep_2d.cuh.",
        '#include "affine_deep_2d.cuh"',
        "",
    ]
    # (C type, entry-point suffix, storage type)
    kinds = [("float", BF16[1], BF16[0])] if bf16 else [
        (ctype, suffix, ctype) for ctype, suffix, _ in _DTYPES.values()]
    for ctype, suffix, storage in kinds:
        lines += [
            f'extern "C" int {library}_{suffix}({params}, const int* ints,',
            "    const double* doubles, void* stream) {",
            f"  return pde_tpu_torch::{launcher}<{ctype}, {flags}, {storage}>({args}, ints,",
            "      doubles, stream);",
            "}",
            "",
        ]
    return "\n".join(lines)


class _KernelSource:
    """One 2D affine library's generated source for one periodicity (and its
    bf16 storage entry points alone, with `bf16`), as a build unit of
    :func:`.cuda_stencil_2d.build_programs`: the register march's, or the deep
    march's (a library of :data:`DEEP_LIBRARIES`)."""

    def __init__(self, library: str, periodic: tuple[bool, bool], bf16: bool = False):
        self.library = library
        self.periodic = periodic
        self.deep = library in DEEP_LIBRARIES
        self.radial = DEEP_LIBRARIES.get(library, library) in _RADIAL_LIBRARIES
        self.suffixes = (BF16[1],) if bf16 else ("f32", "f64")
        if self.deep:
            self.source = emit_deep_source(library, periodic, bf16)
            templates = (_DEEP_TEMPLATE, _TEMPLATE, _MARCH)
        else:
            self.source = emit_source(library, periodic, bf16)
            templates = (_TEMPLATE, _MARCH)
        text = self.source + "".join(t.read_text() for t in templates) + " ".join(_NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    def load(self, path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        # the parameters before `ints`: pointers, and an ext library's n_blocks
        params = [ctypes.c_int if p.endswith("n_blocks") else ctypes.c_void_p
                  for p in _ENTRY[self.library][0].split(", ")]
        for suffix in self.suffixes:
            fn = getattr(lib, f"{self.library}_{suffix}")
            fn.argtypes = [
                *params,
                ctypes.c_void_p,  # ints
                ctypes.c_void_p,  # doubles (step_doubles)
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib


def kernel_source(periodic: tuple[bool, bool], library: str = "affine_laplace_2d",
                  bf16: bool = False) -> _KernelSource:
    """The build unit of kernel #1 (or, with ``library="affine_laplace_ext_2d"``,
    of #12; with :data:`RADIAL_LIBRARY` and :data:`RADIAL_EXT_LIBRARY`, of
    the radial modes of #1 and #12; with :data:`RADIAL_SIDES_LIBRARY` and
    :data:`RADIAL_SIDES_EXT_LIBRARY`, of their side-input modes; and so on
    for every library of :func:`emit_source`) for axes of this periodicity,
    its bf16 storage entry points with `bf16`
    (``build_programs([kernel_source(spec.periodic, library_of(spec),
    spec.dtype == torch.bfloat16)])`` builds it), one per configuration."""
    return _kernel_source(tuple(bool(p) for p in periodic), library, bool(bf16))


@functools.cache
def _kernel_source(periodic: tuple[bool, bool], library: str, bf16: bool) -> _KernelSource:
    return _KernelSource(library, periodic, bf16)


def library_of(spec) -> str:
    """The library of kernel #1 that takes `spec`: the radial mode's on a
    cylindrical grid, the side inputs' where the spec has them, and the
    radial side-input mode's where both hold; past the register march's top
    (``spec.deep``) the deep library of that mode (:func:`deep_library`)."""
    if spec.radial is not None:
        library = RADIAL_SIDES_LIBRARY if spec.has_sides else RADIAL_LIBRARY
    elif spec.corner:
        return CORNER_LIBRARY
    else:
        library = SIDES_LIBRARY if spec.has_sides else "affine_laplace_2d"
    return deep_library(library) if spec.deep else library


def step_doubles(spec, sides: AffineSides | None = None) -> ctypes.Array:
    """The host doubles of a 2D affine pass, in this order: a, b, 1/dx²,
    1/dy², the four sides' (c, f1, f2) (``make_affine_row_step``: 16); then
    in the 9-point mode its :func:`corner_factors` (20); in the radial mode
    its :func:`radial_constants` (18); then, with side inputs, the pass's
    t-table, k rows of four (``AffineSides`` of the template; zeros where a
    side has no time-dependent const), after the radial constants in the
    radial side-input mode (from double 18, else from 16)."""
    values = [spec.a, spec.b, spec.sx, spec.sy, *[v for side in spec.sides for v in side]]
    if spec.corner:
        values += corner_factors(spec)
    if spec.radial is not None:
        values += radial_constants(spec)
    if spec.has_sides:
        table = sides.t if sides is not None and sides.t is not None else ((0.0,) * 4,) * spec.k
        values += [float(v) for row in table for v in row]
    return (ctypes.c_double * len(values))(*values)


# -- the wrapper ------------------------------------------------------------------------------
def affine_laplace_2d(
    data: torch.Tensor, spec: AffineLaplaceSpec, out: torch.Tensor | None = None,
    sides: AffineSides | None = None,
) -> torch.Tensor:
    """``(a*I + b*lap)^k data`` as described by `spec`, with the pass's side
    inputs `sides` (:class:`AffineSides`; required where the spec has them).

    A CPU tensor gets the plain version. A CUDA tensor goes through the CUDA
    kernel, which writes `out` (allocated when not given; it must not be
    `data`, since blocks read their neighbours' cells); any failure raises.
    ``affine_laplace_2d.launches`` counts kernel launches of every mode,
    ``affine_laplace_2d.corner_launches`` those of the 9-point mode,
    ``affine_laplace_2d.radial_sides_launches`` those of the register
    march's radial mode with side inputs, ``affine_laplace_2d.bf16_launches``
    those on bf16 data, ``affine_laplace_2d.deep_launches`` those of the deep
    march (``spec.deep``).
    """
    if tuple(data.shape) != spec.shape or data.dtype != spec.dtype:
        raise ValueError(
            f"Expected a {spec.shape} {spec.dtype} tensor, got {tuple(data.shape)} {data.dtype}"
        )
    if spec.has_sides:
        if sides is None:
            raise ValueError("The pass has side inputs: give them (AffineSides)")
        if any(spec.side_t) and (sides.t is None or len(sides.t) != spec.k):
            raise ValueError(f"The pass needs a t-table of {spec.k} steps")
        for i, arr in enumerate(sides.arrays):
            if (arr is not None) != spec.side_arrays[i] or (arr is not None and (
                    arr.dtype != spec.compute_dtype or arr.device != data.device)):
                raise ValueError("The side inputs do not match the pass")
    if data.device.type == "cpu":
        result = affine_laplace_2d_plain(data, spec, sides)
        if out is None:
            return result
        return out.copy_(result)
    if data.device.type != "cuda":
        raise RuntimeError(f"No affine Laplacian kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("The kernel needs a contiguous tensor")
    if out is None:
        out = torch.empty_like(data)
    elif (
        out.shape != data.shape or out.dtype != data.dtype or out.device != data.device
        or not out.is_contiguous() or out.data_ptr() == data.data_ptr()
    ):
        raise ValueError("`out` must be a distinct contiguous tensor like `data`")
    from .cuda_stencil_2d import _library

    library = library_of(spec)
    lib = _library(kernel_source(spec.periodic, library, spec.dtype == torch.bfloat16))
    launch = getattr(lib, f"{library}_{dtype_suffix(spec.dtype)}")
    tx, threads, prefetch, _ = spec.tile
    ints = (ctypes.c_int * 9)(*spec.shape, block_plan(spec)[1], spec.k, tx, threads, prefetch,
                              *map(int, spec.periodic))
    doubles = step_doubles(spec, sides)
    # after in and out: the radial mode's row table, then the side inputs' arrays
    extra = []
    if spec.radial is not None:
        extra.append(radial_rows(spec, data.device).data_ptr())
    if spec.has_sides:
        arrays = side_pointers(spec, sides)
        extra.append(ctypes.addressof(arrays))
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = launch(data.data_ptr(), out.data_ptr(), *extra, ctypes.addressof(ints),
                     ctypes.addressof(doubles), stream)
    if err != 0:
        raise RuntimeError(f"affine_laplace_2d kernel launch failed with CUDA error {err}")
    affine_laplace_2d.launches += 1
    if spec.corner:
        affine_laplace_2d.corner_launches += 1
    if library == RADIAL_SIDES_LIBRARY:
        affine_laplace_2d.radial_sides_launches += 1
    if spec.dtype == torch.bfloat16:
        affine_laplace_2d.bf16_launches += 1
    if spec.deep:
        affine_laplace_2d.deep_launches += 1
    return out


affine_laplace_2d.launches = 0
affine_laplace_2d.corner_launches = 0
affine_laplace_2d.radial_sides_launches = 0
affine_laplace_2d.bf16_launches = 0
affine_laplace_2d.deep_launches = 0


def dtype_suffix(dtype: torch.dtype) -> str:
    """The entry-point suffix of a pass on `dtype` data: ``f32``, ``f64`` or
    ``bf16``."""
    return BF16[1] if dtype == torch.bfloat16 else _DTYPES[dtype][1]


def make_affine_laplace_2d(
    grid, *, a: float = 0.0, b: float = 1.0, k: int = 1, dtype=torch.float32, bcs=None,
) -> Callable:
    """Return ``f -> (a*I + b*lap)^k f`` as one kernel pass.

    Without ``bcs`` the grid must be fully periodic; with ``bcs``, axes may
    carry constant affine BCs (Dirichlet/Neumann/Robin/curvature, and the
    expression conditions whose ghost is affine in the adjacent value),
    whose ghost cells the kernel rewrites at every intermediate step; their
    consts may vary along a side or, as a table of k steps, in time (B1(c),
    as ``pde_tpu``'s ``t_tab``). On a ``CylindricalSymGrid`` (``bcs``
    required) the pass is the radial mode, whose sides take the same side
    inputs (the radial table and the side tables together, as ``pde_tpu``'s
    ``radial=`` with ``bcs=``). Every 5-point mode takes
    ``1 <= k <=`` :data:`DEEP_MAX_STEPS`, its passes past the register
    march's top in the mode (:func:`register_top`) through the deep march;
    the 9-point mode ``1 <= k <=`` :data:`CORNER_TOP_STEPS`. The
    returned callable takes
    ``(data, out=None, times=None)``: `times`, the k times of the pass's
    steps, where its consts depend on time (``affine_laplace.t_slots``).
    """
    spec = affine_laplace_spec(grid, a=a, b=b, k=k, dtype=dtype, bcs=bcs)
    inputs = AffineSideInputs(grid, bcs) if spec.has_sides else None

    def affine_laplace(data, out=None, times=None):
        sides = None
        if inputs is not None:
            if inputs.needs_t and (times is None or len(times) != spec.k):
                raise ValueError(f"The pass's consts depend on time: give its {spec.k} times")
            sides = inputs.for_pass(data.dtype, data.device, () if times is None else times)
        return affine_laplace_2d(data, spec, out=out, sides=sides)

    affine_laplace.t_slots = None if inputs is None or not inputs.needs_t else tuple(
        inputs.t_funcs)
    affine_laplace.k = spec.k
    return affine_laplace


def make_fused_euler_window_2d(
    grid, *, diffusivity: float, dt: float, dtype=torch.float32, k: int | None = None, bcs=None,
) -> Callable:
    """Return ``window(data, steps) -> data`` advancing `steps` Euler steps of
    diffusion, k steps per kernel pass (by default :data:`TOP_STEPS`, and
    :data:`RADIAL_TOP_STEPS` on cylindrical grids). An explicit `k` is
    honoured as ``pde_tpu``'s window honours it, up to
    :data:`DEEP_MAX_STEPS` in every 5-point mode (the passes past the
    register march's top take the deep march), halved only where the mode
    refuses it: past :data:`CORNER_TOP_STEPS` in the 9-point mode, past
    :data:`DEEP_MAX_STEPS` in any.

    The step count is split over a binary ladder of kernels (k, k/2, ..., 1),
    so a remainder costs O(log k) passes. Passes alternate between two
    buffers; the input is never written. On a ``CylindricalSymGrid`` the
    passes take the radial mode (``bcs`` required: the r axis is never
    periodic). With side inputs (consts varying along a side or in time)
    the ladder tops at :data:`SIDES_TOP_STEPS`, on a cylinder at
    :data:`RADIAL_SIDES_TOP_STEPS` (the radial side-input mode); where a
    side's const depends on time the window is ``window(data, t0, steps)``
    (``window.needs_t``): inner step s of the window reads the consts at
    ``t0 + s*dt``, as ``pde_tpu``'s does. bf16 data (where the columns are
    periodic) tops where float32 does.
    """
    cylindrical = isinstance(grid, CylindricalSymGrid)
    corner = not cylindrical and _corner_weight() != 0
    if k is None:
        k = RADIAL_TOP_STEPS if cylindrical else TOP_STEPS
        if _has_side_inputs(grid, bcs):
            k = RADIAL_SIDES_TOP_STEPS if cylindrical else SIDES_TOP_STEPS
        if corner:
            k = CORNER_TOP_STEPS
    # the ladder halves from the top until the mode takes k, as pde_tpu's
    # window does (pde_tpu/ops/pallas_cartesian.py:5377-5379, 5396-5397)
    while k > (CORNER_TOP_STEPS if corner else DEEP_MAX_STEPS):
        k //= 2
    specs = []
    while k >= 1:
        specs.append(
            affine_laplace_spec(grid, a=1.0, b=dt * diffusivity, k=k, dtype=dtype, bcs=bcs)
        )
        k //= 2
    inputs = AffineSideInputs(grid, bcs) if specs[0].has_sides else None
    return affine_window(specs, affine_laplace_2d, inputs, dt)


def make_fused_euler_window_cyl(
    grid, *, diffusivity: float, dt: float, bcs, dtype=torch.float32, k: int = 16,
) -> Callable:
    """Euler diffusion window on a ``CylindricalSymGrid`` (rows r, columns z):
    ``pde_tpu``'s named alias of :func:`make_fused_euler_window_2d`
    (pde_tpu/ops/pallas_cartesian.py:5470-5485), with its default k = 16
    (``2 * _HALO``): the ladder 16, 8, 4, 2, 1, whose 16-step passes take the
    deep march of the radial mode (with side inputs where a side's const
    varies along it or in time, the 8-step ones too)."""
    if not isinstance(grid, CylindricalSymGrid):
        raise KernelUnsupportedError("CylindricalSymGrid required")
    return make_fused_euler_window_2d(grid, diffusivity=diffusivity, dt=dt, dtype=dtype, k=k,
                                      bcs=bcs)


def affine_window(specs, run: Callable, inputs: AffineSideInputs | None = None,
                  dt: float | None = None) -> Callable:
    """``window(data, steps) -> data`` splitting `steps` over the passes of
    `specs` (largest k first), each ``run(data, spec, out=...)``, alternating
    between two buffers; the input is never written. With side `inputs`
    each pass also gets ``sides=`` (:class:`AffineSides`), and where they
    depend on time the window is ``window(data, t0, steps)``
    (``window.needs_t``), the t-table of a pass whose first step is inner
    step i at ``t0 + (i + s)*dt``. The window carries its ``specs``."""
    needs_t = inputs is not None and inputs.needs_t
    if needs_t and dt is None:
        raise ValueError("A window whose consts depend on time needs its dt")

    def window(data, *args):
        t0, steps = args if needs_t else (0.0, *args)
        buffers = None
        passes = 0
        index = 0
        remaining = int(steps)
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                if buffers is None:
                    buffers = (torch.empty_like(data), torch.empty_like(data))
                kwargs = {}
                if inputs is not None:
                    times = [t0 + (index + s) * dt for s in range(spec.k)] if needs_t else ()
                    kwargs["sides"] = inputs.for_pass(data.dtype, data.device, times)
                data = run(data, spec, out=buffers[passes % 2], **kwargs)
                passes += 1
                index += spec.k
        return data

    window.specs = specs
    window.needs_t = needs_t
    return window
