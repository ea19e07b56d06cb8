"""Standalone first-order stencil operators on 2D grids: CUDA kernel, plain
version, tile emulation.

Port of :func:`pde_tpu.ops.pallas_cartesian.make_stencil_op_pallas`, the
kernel behind the ``cuda`` engine's operator registry beyond ``laplace``: one
pass applies ``gradient_squared``, ``gradient``, ``divergence``,
``vector_laplace``, ``vector_gradient`` or ``tensor_divergence`` to the
component planes of a field and writes the planes of the result.

Three implementations of the same function live here:

- the CUDA kernel (``csrc/stencil_op_2d.cu``, templated on the operator, the
  type and each axis's periodicity), built with ``nvcc`` for ``sm_90a`` at
  first use into ``pde_tpu_torch/_build/`` through
  :func:`.cuda_stencil_2d.build_programs` and called through a plain C
  interface with ctypes;
- :func:`stencil_op_2d_plain`, the whole planes in plain PyTorch (rolls on
  periodic axes, the ghost formula of :func:`.cuda_cartesian._ghost` on
  affine sides), the oracle the kernel is held against and what the wrapper
  runs for tensors on the CPU;
- :func:`stencil_op_2d_tiled`, a pure-torch emulation of the kernel's tiling
  (the same neighbour wrap and edge substitution per output tile), so the
  CPU tests reach index maths that only the card runs otherwise.

:func:`stencil_op_2d` is the wrapper, :func:`make_stencil_op_2d` the
registry's operator factory. Supported (decided from the configuration
alone): a 2D ``CartesianGrid``, float32 or float64 data, each axis periodic
or carrying scalar constant affine conditions with at least 2 cells, and
for ``vector_laplace`` the 5-point stencil. One set of scalar side triplets
applies to every component plane, as in the TPU kernel. Everything else
raises :class:`KernelUnsupportedError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from dataclasses import dataclass
from typing import Callable

import torch

from ..grids.cartesian import CartesianGrid
from .cuda_cartesian import (
    _NVCC_FLAGS,
    _PACKAGE,
    KernelUnsupportedError,
    _corner_weight,
    _ghost,
    _neighbours,
    affine_bc_specs,
    bf16_refusal,
)
from .cuda_stencil_2d import _library

_SOURCE = _PACKAGE / "csrc" / "stencil_op_2d.cu"

#: operator -> (input planes, output planes); the order is the kernel's ``Op`` enum
OPERATORS: dict[str, tuple[int, int]] = {
    "gradient_squared": (1, 1),
    "gradient": (1, 2),
    "divergence": (2, 1),
    "vector_laplace": (2, 2),
    "vector_gradient": (2, 4),
    "tensor_divergence": (4, 2),
}
#: tensor axes of each operator's input and output planes (row-major)
_RANKS = {
    "gradient_squared": (0, 0), "gradient": (0, 1), "divergence": (1, 0),
    "vector_laplace": (1, 1), "vector_gradient": (1, 2), "tensor_divergence": (2, 1),
}
#: rows and columns one block of the kernel writes (``kBlockY * kRows`` by
#: ``kBlockX`` in the .cu source); the tile emulation defaults to it
TILE = (64, 32)
#: rows the kernel's grid can cover (65535 blocks of ``TILE[0]`` rows)
MAX_ROWS = 65535 * TILE[0]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


# -- the gate ---------------------------------------------------------------------------------
@dataclass(frozen=True)
class StencilOpSpec:
    """One operator pass, decided from the configuration."""

    op: str
    shape: tuple[int, int]
    n_in: int
    n_out: int
    periodic: tuple[bool, bool]
    #: (const, f1, f2) of the row-low, row-high, column-low, column-high sides
    sides: tuple[tuple[float, float, float], ...]
    halves: tuple[float, float]  # 0.5/dx per axis
    scales: tuple[float, float]  # 1/dx² per axis
    dtype: torch.dtype


def stencil_op_2d_spec(grid, op: str, *, dtype=torch.float32, bcs=None) -> StencilOpSpec:
    """Check that the kernel supports a configuration and describe it.

    `bcs` are rank-0 conditions (one triplet per side for every plane);
    without them the grid must be fully periodic. Raises
    :class:`KernelUnsupportedError` exactly where the configuration is not
    supported; nothing here builds or touches a device.
    """
    if op not in OPERATORS:
        raise KernelUnsupportedError(f"No stencil-operator kernel for `{op}`")
    if not isinstance(grid, CartesianGrid) or grid.num_axes != 2:
        raise KernelUnsupportedError("The stencil-operator kernel requires a 2D CartesianGrid")
    if dtype == torch.bfloat16:
        raise bf16_refusal("the stencil-operator kernel #2", "ops/pallas_cartesian.py:1372")
    if dtype not in _DTYPES:
        raise KernelUnsupportedError(f"The kernel takes float32 or float64 data, not {dtype}")
    if op == "vector_laplace" and _corner_weight() != 0:
        raise KernelUnsupportedError(
            "The kernel implements the 5-point Laplacian only; under a corner weight the "
            "plain operator runs, as pde_tpu's gate (pde_tpu/ops/pallas_cartesian.py:1303-1306, "
            ":1365-1366)"
        )
    if grid.shape[0] > MAX_ROWS:
        raise KernelUnsupportedError(f"The kernel takes at most {MAX_ROWS} rows")
    if bcs is None and not all(grid.periodic):
        raise KernelUnsupportedError("Non-periodic grids require explicit boundary conditions")
    try:
        specs = None if bcs is None else affine_bc_specs(grid, bcs)
    except KernelUnsupportedError as err:
        raise KernelUnsupportedError(
            f"{err}; the standalone stencil operators take scalar BC values only"
        ) from err
    sides = []
    for ax in range(2):
        axis_specs = None if specs is None else specs[ax]
        if axis_specs is None:
            sides += [(0.0, 0.0, 0.0)] * 2
            continue
        if grid.shape[ax] < 2:
            raise KernelUnsupportedError(
                "A non-periodic axis needs at least 2 cells for the kernel"
            )
        sides += [side.scalar_triplet() for side in axis_specs]
    n_in, n_out = OPERATORS[op]
    return StencilOpSpec(
        op=op, shape=tuple(grid.shape), n_in=n_in, n_out=n_out,
        periodic=tuple(specs is None or specs[ax] is None for ax in range(2)),
        sides=tuple(sides), halves=tuple((0.5 / grid.discretization).tolist()),
        scales=tuple((1.0 / grid.discretization**2).tolist()), dtype=dtype,
    )


# -- plain version and tile emulation ---------------------------------------------------------
def _apply(spec: StencilOpSpec, center, up, down, left, right) -> list:
    """The operator's output planes from the stacked input planes and their
    four neighbours, in the kernel's order of operations."""
    gx, gy = spec.halves
    sx, sy = spec.scales

    def d_row(f):
        return (down[f] - up[f]) * gx

    def d_col(f):
        return (right[f] - left[f]) * gy

    def lap(f):
        if sx == sy:
            return (up[f] + down[f] + left[f] + right[f] - 4.0 * center[f]) * sx
        c2 = 2.0 * center[f]
        return (up[f] + down[f] - c2) * sx + (left[f] + right[f] - c2) * sy

    op = spec.op
    if op == "gradient_squared":
        dr, dc = d_row(0), d_col(0)
        return [dr * dr + dc * dc]
    if op == "gradient":
        return [d_row(0), d_col(0)]
    if op == "divergence":
        return [d_row(0) + d_col(1)]
    if op == "vector_laplace":
        return [lap(0), lap(1)]
    if op == "vector_gradient":  # out[i, j] = d_j v_i, row-major
        return [d_row(0), d_col(0), d_row(1), d_col(1)]
    # tensor_divergence: out[i] = sum_j d_j t_ij, t row-major
    return [d_row(0) + d_col(1), d_row(2) + d_col(3)]


def stencil_op_2d_plain(data: torch.Tensor, spec: StencilOpSpec) -> torch.Tensor:
    """The operator on the stacked ``(n_in, n, m)`` planes in plain PyTorch;
    returns ``(n_out, n, m)``."""
    row_lo, row_hi, col_lo, col_hi = spec.sides
    up, down = _neighbours(data, 1, spec.periodic[0], row_lo, row_hi)
    left, right = _neighbours(data, 2, spec.periodic[1], col_lo, col_hi)
    return torch.stack(_apply(spec, data, up, down, left, right))


def stencil_op_2d_tiled(data: torch.Tensor, spec: StencilOpSpec, tile=TILE) -> torch.Tensor:
    """Pure-torch emulation of the CUDA kernel, output tile by output tile.

    Each tile (`tile` rows by columns, or one int for both) loads its cells
    and one neighbour row and column per side, wrapped by index on periodic
    axes and zero beyond a non-periodic edge; the neighbour beyond a global
    edge cell is then replaced by the side's ghost value, and the operator
    is applied to the tile's cells, as each thread of the kernel does.
    """
    tile_rows, tile_cols = (tile, tile) if isinstance(tile, int) else tile
    n_rows, n_cols = spec.shape
    row_lo, row_hi, col_lo, col_hi = spec.sides
    out = torch.empty((spec.n_out, n_rows, n_cols), dtype=data.dtype, device=data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)

    def window(start: int, size: int, n: int, periodic: bool):
        g = torch.arange(start - 1, start + size + 1)
        if periodic:
            return g % n, torch.ones_like(g, dtype=torch.bool), g[1:-1]
        return g.clamp(0, n - 1), (g >= 0) & (g < n), g[1:-1]

    for row0 in range(0, n_rows, tile_rows):
        rows = min(tile_rows, n_rows - row0)
        r, r_in, gr = window(row0, rows, n_rows, spec.periodic[0])
        for col0 in range(0, n_cols, tile_cols):
            cols = min(tile_cols, n_cols - col0)
            c, c_in, gc = window(col0, cols, n_cols, spec.periodic[1])
            w = torch.where(r_in[:, None] & c_in[None, :], data[:, r][:, :, c], zero)
            center = w[:, 1:-1, 1:-1]
            up, down = w[:, :-2, 1:-1], w[:, 2:, 1:-1]
            left, right = w[:, 1:-1, :-2], w[:, 1:-1, 2:]
            if not spec.periodic[0]:
                at_lo, at_hi = (gr == 0)[:, None], (gr == n_rows - 1)[:, None]
                up, down = (torch.where(at_lo, _ghost(row_lo, center, down), up),
                            torch.where(at_hi, _ghost(row_hi, center, up), down))
            if not spec.periodic[1]:
                at_lo, at_hi = (gc == 0)[None, :], (gc == n_cols - 1)[None, :]
                left, right = (torch.where(at_lo, _ghost(col_lo, center, right), left),
                               torch.where(at_hi, _ghost(col_hi, center, left), right))
            values = _apply(spec, center, up, down, left, right)
            out[:, row0 : row0 + rows, col0 : col0 + cols] = torch.stack(values)
    return out


# -- the CUDA build ----------------------------------------------------------------------------
class _KernelSource:
    """The kernel's source as a build unit of
    :func:`.cuda_stencil_2d.build_programs`."""

    library = "stencil_op_2d"

    def __init__(self):
        self.source = _SOURCE.read_text()
        text = self.source + " ".join(_NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @staticmethod
    def load(path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for suffix in _DTYPES.values():
            fn = getattr(lib, f"stencil_op_2d_{suffix}")
            fn.argtypes = [
                ctypes.c_int,  # op
                ctypes.c_void_p, ctypes.c_void_p,  # host arrays of input and output pointers
                ctypes.c_int, ctypes.c_int,  # n_rows, n_cols
                ctypes.c_int, ctypes.c_int,  # rows_periodic, cols_periodic
                ctypes.c_void_p,  # scales: 4 host doubles
                ctypes.c_void_p,  # sides: 12 host doubles
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib


@functools.cache
def kernel_source() -> _KernelSource:
    """The kernel's build unit (``build_programs([kernel_source()])`` builds it)."""
    return _KernelSource()


# -- the wrapper ------------------------------------------------------------------------------
def stencil_op_2d(
    data: torch.Tensor, spec: StencilOpSpec, out: torch.Tensor | None = None
) -> torch.Tensor:
    """The spec's operator on the stacked ``(n_in, n, m)`` planes `data`,
    written to ``(n_out, n, m)`` planes.

    A CPU tensor gets the plain version. A CUDA tensor goes through the CUDA
    kernel, which writes `out` (allocated when not given; it must not overlap
    `data`); any failure raises. ``stencil_op_2d.launches`` counts kernel
    launches.
    """
    n_rows, n_cols = spec.shape
    if tuple(data.shape) != (spec.n_in, n_rows, n_cols) or data.dtype != spec.dtype:
        raise ValueError(
            f"Expected a {(spec.n_in, n_rows, n_cols)} {spec.dtype} tensor, got "
            f"{tuple(data.shape)} {data.dtype}"
        )
    if data.device.type == "cpu":
        result = stencil_op_2d_plain(data, spec)
        return result if out is None else out.copy_(result)
    if data.device.type != "cuda":
        raise RuntimeError(f"No stencil-operator kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("The kernel needs a contiguous tensor")
    if out is None:
        out = torch.empty((spec.n_out, n_rows, n_cols), dtype=data.dtype, device=data.device)
    elif (
        tuple(out.shape) != (spec.n_out, n_rows, n_cols) or out.dtype != data.dtype
        or out.device != data.device or not out.is_contiguous()
        or (out.data_ptr() < data.data_ptr() + data.nbytes
            and data.data_ptr() < out.data_ptr() + out.nbytes)
    ):
        raise ValueError("`out` must be a contiguous (n_out, n, m) tensor apart from `data`")
    launch = getattr(_library(kernel_source()), f"stencil_op_2d_{_DTYPES[spec.dtype]}")
    plane = n_rows * n_cols * data.element_size()
    ins = (ctypes.c_void_p * spec.n_in)(*[data.data_ptr() + f * plane for f in range(spec.n_in)])
    outs = (ctypes.c_void_p * spec.n_out)(
        *[out.data_ptr() + f * plane for f in range(spec.n_out)])
    scales = (ctypes.c_double * 4)(*spec.halves, *spec.scales)
    sides = (ctypes.c_double * 12)(*[v for side in spec.sides for v in side])
    args = (list(OPERATORS).index(spec.op), ctypes.addressof(ins), ctypes.addressof(outs),
            n_rows, n_cols, int(spec.periodic[0]), int(spec.periodic[1]),
            ctypes.addressof(scales), ctypes.addressof(sides),
            torch.cuda.current_stream(data.device).cuda_stream)
    if data.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(data.device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"stencil_op_2d kernel launch failed with CUDA error {err}")
    stencil_op_2d.launches += 1
    return out


stencil_op_2d.launches = 0


def make_stencil_op_2d(grid, op: str, bcs=None) -> Callable:
    """The registry's operator: ``op(data, t=0.0, args=None)`` on field data
    (``(n, m)``, ``(2, n, m)`` or ``(2, 2, n, m)`` as the operator's input
    rank says), returning the output rank's layout, through one kernel pass.

    The configuration is checked here (for float32); a float64 call gets its
    own spec at first use.
    """
    specs = {torch.float32: stencil_op_2d_spec(grid, op, dtype=torch.float32, bcs=bcs)}
    rank_in, rank_out = _RANKS[op]
    n_in, _ = OPERATORS[op]
    shape_in = (2,) * rank_in + tuple(grid.shape)
    shape_out = (2,) * rank_out + tuple(grid.shape)

    def operator(data, t=0.0, args=None):
        if tuple(data.shape) != shape_in:
            raise ValueError(f"`{op}` takes {shape_in} data, got {tuple(data.shape)}")
        spec = specs.get(data.dtype)
        if spec is None:
            spec = specs[data.dtype] = stencil_op_2d_spec(grid, op, dtype=data.dtype, bcs=bcs)
        planes = data.reshape((n_in,) + tuple(grid.shape)).contiguous()
        return stencil_op_2d(planes, spec).reshape(shape_out)

    return operator
