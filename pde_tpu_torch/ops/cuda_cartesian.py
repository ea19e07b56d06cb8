"""Temporally blocked 2D affine Laplacian: CUDA kernel, plain version, ladder.

Port of the single-device 2D path of :mod:`pde_tpu.ops.pallas_cartesian`:
``make_affine_laplace_2d`` computes ``f -> (a*I + b*lap)^k f`` in one pass
over device memory, and ``make_fused_euler_window_2d`` splits a step count
over a binary ladder of such kernels (k = 16, 8, 4, 2, 1).

Three implementations of the same function live here:

- the CUDA kernel (``csrc/affine_laplace_2d.cu``), built with ``nvcc`` for
  ``sm_90a`` at first use into ``pde_tpu_torch/_build/`` and called through
  a plain C interface with ``ctypes``;
- :func:`affine_laplace_2d_plain`, k plain PyTorch steps, the oracle that the
  kernel is held against and what the wrapper runs for tensors on the CPU;
- :func:`affine_laplace_2d_tiled`, a pure-torch emulation of the kernel's
  tiling (same tile, halo and wrap index maths), so the CPU tests reach the
  halo and wrap logic that only the card can run otherwise.

:func:`affine_laplace_2d` is the wrapper: for a CPU tensor it returns the
plain version; for a CUDA tensor it launches the kernel or raises.

Supported (decided from the configuration alone, before any build): a 2D
``CartesianGrid``, float32 or float64 data, each axis periodic or carrying
scalar constant affine BCs with at least 2 cells, the 5-point stencil, and
``1 <= k <= 16``. Everything else raises :class:`KernelUnsupportedError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..grids.cartesian import CartesianGrid

#: output tile side of the CUDA kernel (``kTile`` in the .cu source); the
#: tile emulation defaults to it
TILE = 64
#: deepest temporal block one kernel pass takes
MAX_STEPS = 16

_PACKAGE = Path(__file__).resolve().parent.parent
_SOURCE = _PACKAGE / "csrc" / "affine_laplace_2d.cu"
_BUILD_DIR = _PACKAGE / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelUnsupportedError(NotImplementedError):
    """The configuration cannot be lowered to the fused CUDA kernel."""


def _corner_weight() -> float:
    from ..utils.config import config

    return float(config["operators.cartesian.laplacian_2d_corner_weight"])


# -- boundary conditions as affine ghost formulas -------------------------------------------
class BCSideSpec:
    """Affine ghost-point data of one axis side with scalar coefficients:
    ``ghost = const + f1*edge + f2*next_inward``."""

    __slots__ = ("f1", "f2", "const")

    def __init__(self, f1: float, f2: float, const: float):
        self.f1 = float(f1)
        self.f2 = float(f2)
        self.const = float(const)

    def scalar_triplet(self) -> tuple[float, float, float]:
        """(const, f1, f2), the order of ``pde_tpu``'s ``scalar_triplet``."""
        return self.const, self.f1, self.f2


def _uniform_scalar(value, what: str) -> float:
    """Collapse a uniform array to a float; raise for per-point values."""
    flat = np.asarray(value, dtype=float).reshape(-1)
    if flat.size and np.all(flat == flat[0]):
        return float(flat[0])
    raise KernelUnsupportedError(
        f"Per-point array BC {what}s are not supported by the kernel (ROADMAP B1(c))"
    )


def affine_bc_specs(grid, bcs):
    """Per-axis affine ghost specs: ``None`` for a periodic axis, else a
    (low, high) pair of :class:`BCSideSpec`. Returns ``None`` when fully
    periodic; raises :class:`KernelUnsupportedError` for conditions the
    kernel cannot lower."""
    from ..grids.boundaries.local import ConstBC1stOrderBase, ConstBC2ndOrderBase

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
            sides.append(
                BCSideSpec(
                    _uniform_scalar(f1, "factor"),
                    _uniform_scalar(f2, "factor"),
                    _uniform_scalar(const, "value"),
                )
            )
        params.append(tuple(sides))
    if all(p is None for p in params):
        return None
    return tuple(params)


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


def affine_laplace_spec(grid, *, a: float, b: float, k: int, dtype, bcs=None) -> AffineLaplaceSpec:
    """Check that the kernel supports a configuration and describe it.

    Raises :class:`KernelUnsupportedError` exactly where the configuration
    is not supported; nothing here builds or touches a device.
    """
    if not isinstance(grid, CartesianGrid) or grid.num_axes != 2:
        raise KernelUnsupportedError("The kernel requires a 2D CartesianGrid")
    if dtype not in (torch.float32, torch.float64):
        raise KernelUnsupportedError(
            f"The kernel takes float32 or float64 data, not {dtype} "
            "(bf16 storage is ROADMAP B1(f))"
        )
    if _corner_weight() != 0:
        raise KernelUnsupportedError(
            "The kernel implements the 5-point Laplacian only; the 9-point "
            "corner-weight stencil is ROADMAP B1(e)"
        )
    if not 1 <= k <= MAX_STEPS:
        raise KernelUnsupportedError(f"The kernel takes 1 <= k <= {MAX_STEPS} steps, not {k}")
    if bcs is None and not all(grid.periodic):
        raise KernelUnsupportedError("Non-periodic grids require explicit boundary conditions")
    specs = None if bcs is None else affine_bc_specs(grid, bcs)
    sides = []
    periodic = []
    for ax in range(2):
        axis_specs = None if specs is None else specs[ax]
        periodic.append(axis_specs is None)
        if axis_specs is None:
            sides += [(0.0, 0.0, 0.0)] * 2
        else:
            if grid.shape[ax] < 2:
                raise KernelUnsupportedError(
                    "A non-periodic axis needs at least 2 cells for the kernel"
                )
            sides += [side.scalar_triplet() for side in axis_specs]
    sx, sy = (1.0 / grid.discretization**2).tolist()
    return AffineLaplaceSpec(
        shape=tuple(grid.shape), k=int(k), a=float(a), b=float(b), sx=sx, sy=sy,
        periodic=tuple(periodic), sides=tuple(sides), dtype=dtype,
    )


# -- plain version ------------------------------------------------------------------------
def _ghost(side, edge, inward):
    """``c + f1*edge (+ f2*inward)``, in the order of the kernel."""
    const, f1, f2 = side
    ghost = const + f1 * edge
    if f2:
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


def _update(spec: AffineLaplaceSpec, center, up, down, left, right):
    """One step of ``a*f + b*lap(f)`` from the five stencil values."""
    if spec.sx == spec.sy:
        lap4 = up + down + left + right - 4.0 * center
        return spec.a * center + (spec.b * spec.sx) * lap4
    lap = (up + down - 2.0 * center) * spec.sx + (left + right - 2.0 * center) * spec.sy
    return spec.a * center + spec.b * lap


def affine_laplace_2d_plain(data: torch.Tensor, spec: AffineLaplaceSpec) -> torch.Tensor:
    """k plain PyTorch steps of ``f <- a*f + b*lap(f)`` (rolls for periodic
    axes, the ghost formula for affine sides)."""
    row_lo, row_hi, col_lo, col_hi = spec.sides
    f = data
    for _ in range(spec.k):
        up, down = _neighbours(f, 0, spec.periodic[0], row_lo, row_hi)
        left, right = _neighbours(f, 1, spec.periodic[1], col_lo, col_hi)
        f = _update(spec, f, up, down, left, right)
    return f


# -- emulation of the kernel's tiling ----------------------------------------------------------
def affine_laplace_2d_tiled(
    data: torch.Tensor, spec: AffineLaplaceSpec, tile: int = TILE
) -> torch.Tensor:
    """Pure-torch emulation of the CUDA kernel, tile by tile.

    Each output tile loads a (tile + 2k)² window with wrapped periodic halos
    and zeros outside non-periodic edges, rewrites the edge ghosts and
    advances one level per step on the shrinking valid region, then writes
    its centre; the index maths are the kernel's.
    """
    n_rows, n_cols = data.shape
    k = spec.k
    w = tile + 2 * k
    rows_periodic, cols_periodic = spec.periodic
    row_lo, row_hi, col_lo, col_hi = spec.sides
    out = torch.empty_like(data)
    for row0 in range(0, n_rows, tile):
        for col0 in range(0, n_cols, tile):
            gr0, gc0 = row0 - k, col0 - k
            gr = torch.arange(gr0, gr0 + w)
            gc = torch.arange(gc0, gc0 + w)
            row_in = torch.ones(w, dtype=torch.bool) if rows_periodic else (gr >= 0) & (gr < n_rows)
            col_in = torch.ones(w, dtype=torch.bool) if cols_periodic else (gc >= 0) & (gc < n_cols)
            r = gr % n_rows if rows_periodic else gr.clamp(0, n_rows - 1)
            c = gc % n_cols if cols_periodic else gc.clamp(0, n_cols - 1)
            inside = row_in[:, None] & col_in[None, :]
            zero = torch.zeros((), dtype=data.dtype)
            cur = torch.where(inside, data[r][:, c], zero)
            g_row_lo, g_row_hi = -1 - gr0, n_rows - gr0
            g_col_lo, g_col_hi = -1 - gc0, n_cols - gc0
            for s in range(k):
                lo, hi = s, w - s
                span = slice(lo, hi)
                if not rows_periodic:
                    keep = col_in[span]
                    if lo <= g_row_lo and g_row_lo + 2 < hi:
                        g = g_row_lo
                        new = _ghost(row_lo, cur[g + 1, span], cur[g + 2, span])
                        cur[g, span] = torch.where(keep, new, cur[g, span])
                    if lo <= g_row_hi - 2 and g_row_hi < hi:
                        g = g_row_hi
                        new = _ghost(row_hi, cur[g - 1, span], cur[g - 2, span])
                        cur[g, span] = torch.where(keep, new, cur[g, span])
                if not cols_periodic:
                    keep = row_in[span]
                    if lo <= g_col_lo and g_col_lo + 2 < hi:
                        g = g_col_lo
                        new = _ghost(col_lo, cur[span, g + 1], cur[span, g + 2])
                        cur[span, g] = torch.where(keep, new, cur[span, g])
                    if lo <= g_col_hi - 2 and g_col_hi < hi:
                        g = g_col_hi
                        new = _ghost(col_hi, cur[span, g - 1], cur[span, g - 2])
                        cur[span, g] = torch.where(keep, new, cur[span, g])
                inner = slice(lo + 1, hi - 1)
                value = _update(
                    spec,
                    cur[inner, inner],
                    cur[lo : hi - 2, inner],
                    cur[lo + 2 : hi, inner],
                    cur[inner, lo : hi - 2],
                    cur[inner, lo + 2 : hi],
                )
                nxt = cur.clone()
                nxt[inner, inner] = torch.where(inside[inner, inner], value, zero)
                cur = nxt
            n_r, n_c = min(tile, n_rows - row0), min(tile, n_cols - col0)
            out[row0 : row0 + n_r, col0 : col0 + n_c] = cur[k : k + n_r, k : k + n_c]
    return out


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


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libaffine_laplace_2d_{digest[:16]}.so"


def build_kernels() -> dict:
    """Compile the kernel library unless this source was built already.

    Returns ``{"path", "seconds", "compiled", "log"}``; ``log`` holds the
    compiler's resource report (``-Xptxas -v``). Raises when nvcc fails.
    """
    path = _library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "compiled": False,
                "log": log_path.read_text() if log_path.exists() else ""}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "compiled": True, "log": log}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    lib = ctypes.CDLL(build_kernels()["path"])
    argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # in, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_rows, n_cols, k
        ctypes.c_int, ctypes.c_int,  # rows_periodic, cols_periodic
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # a, b, sx, sy
        ctypes.c_void_p,  # sides: 12 host doubles
        ctypes.c_void_p,  # stream
    ]
    for name in ("affine_laplace_2d_f32", "affine_laplace_2d_f64"):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# -- the wrapper ------------------------------------------------------------------------------
def affine_laplace_2d(
    data: torch.Tensor, spec: AffineLaplaceSpec, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``(a*I + b*lap)^k data`` as described by `spec`.

    A CPU tensor gets the plain version. A CUDA tensor goes through the CUDA
    kernel, which writes `out` (allocated when not given; it must not be
    `data`, since tiles read their neighbours' cells); any failure raises.
    ``affine_laplace_2d.launches`` counts kernel launches.
    """
    if tuple(data.shape) != spec.shape or data.dtype != spec.dtype:
        raise ValueError(
            f"Expected a {spec.shape} {spec.dtype} tensor, got {tuple(data.shape)} {data.dtype}"
        )
    if data.device.type == "cpu":
        result = affine_laplace_2d_plain(data, spec)
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
    lib = _library()
    launch = lib.affine_laplace_2d_f32 if spec.dtype == torch.float32 else lib.affine_laplace_2d_f64
    sides = (ctypes.c_double * 12)(*[v for side in spec.sides for v in side])
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = launch(
            data.data_ptr(), out.data_ptr(), spec.shape[0], spec.shape[1], spec.k,
            int(spec.periodic[0]), int(spec.periodic[1]),
            spec.a, spec.b, spec.sx, spec.sy, ctypes.addressof(sides), stream,
        )
    if err != 0:
        raise RuntimeError(f"affine_laplace_2d kernel launch failed with CUDA error {err}")
    affine_laplace_2d.launches += 1
    return out


affine_laplace_2d.launches = 0


def make_affine_laplace_2d(
    grid, *, a: float = 0.0, b: float = 1.0, k: int = 1, dtype=torch.float32, bcs=None,
) -> Callable:
    """Return ``f -> (a*I + b*lap)^k f`` as one kernel pass.

    Without ``bcs`` the grid must be fully periodic; with ``bcs``, axes may
    carry scalar constant affine BCs (Dirichlet/Neumann/Robin/curvature),
    whose ghost cells the kernel rewrites at every intermediate step. The
    returned callable takes ``(data, out=None)``.
    """
    spec = affine_laplace_spec(grid, a=a, b=b, k=k, dtype=dtype, bcs=bcs)

    def affine_laplace(data, out=None):
        return affine_laplace_2d(data, spec, out=out)

    return affine_laplace


def make_fused_euler_window_2d(
    grid, *, diffusivity: float, dt: float, dtype=torch.float32, k: int = MAX_STEPS, bcs=None,
) -> Callable:
    """Return ``window(data, steps) -> data`` advancing `steps` Euler steps of
    diffusion, k steps per kernel pass.

    The step count is split over a binary ladder of kernels (k, k/2, ..., 1),
    so a remainder costs O(log k) passes. Passes alternate between two
    buffers; the input is never written.
    """
    specs = []
    while k >= 1:
        specs.append(
            affine_laplace_spec(grid, a=1.0, b=dt * diffusivity, k=k, dtype=dtype, bcs=bcs)
        )
        k //= 2
    return affine_window(specs, affine_laplace_2d)


def affine_window(specs, run: Callable) -> Callable:
    """``window(data, steps) -> data`` splitting `steps` over the passes of
    `specs` (largest k first), each ``run(data, spec, out=...)``, alternating
    between two buffers; the input is never written. The window carries its
    ``specs``."""

    def window(data, steps):
        buffers = None
        passes = 0
        remaining = int(steps)
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                if buffers is None:
                    buffers = (torch.empty_like(data), torch.empty_like(data))
                data = run(data, spec, out=buffers[passes % 2])
                passes += 1
        return data

    window.specs = specs
    return window
