"""Temporally blocked 3D affine Laplacian: CUDA kernel, plain version, tile
and march emulations, ladder.

Port of the single-device 3D path of :mod:`pde_tpu.ops.pallas_cartesian`:
``make_affine_laplace_3d`` computes ``f -> (a*I + b*lap)^k f`` in one pass
over device memory, and ``make_fused_euler_window_3d`` splits a step count
over a binary ladder of such passes (k = 4, 2, 1 from the top k the host picks).

Four implementations of the same function live here:

- the CUDA kernel, the hand-written template ``csrc/affine_laplace_3d.cuh``
  (an x-marching wavefront over (y, z) column tiles) instantiated for every
  k it takes and both dtypes at the plan :func:`march_plan_3d` picks, one
  library per periodicity of the three axes (the entry points are generated here, so the plan lives in one
  place), built with ``nvcc`` for ``sm_90a`` at first use into
  ``pde_tpu_torch/_build/`` and called through a plain C interface with
  ``ctypes``;
- :func:`affine_laplace_3d_plain`, k plain PyTorch steps, the oracle that the
  kernel is held against and what the wrapper runs for tensors on the CPU;
- :func:`affine_laplace_3d_tiled`, a pure-torch emulation of the values the
  kernel's blocks compute (each block's chunk and column tile with k-deep
  halos, wraps and ghosts), so the CPU tests reach the halo and seam logic;
- :func:`affine_laplace_3d_marched`, a pure-torch replay of the kernel's
  schedule: its shared-memory slots per level, when each plane enters and
  retires, where each ghost is formed, the chunk borders.

Supported (decided from the configuration alone, before any build): a 3D
``CartesianGrid``, float32 or float64 data, each axis periodic or carrying
scalar constant affine BCs with at least 2 cells, and ``1 <= k <= 4``.
Everything else raises :class:`KernelUnsupportedError`. The TPU kernel's
alignment rules and its 96 KB plane switch to the y-chunked kernel are VMEM
limits and do not carry over.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
from dataclasses import dataclass
from typing import Callable

import torch

from ..grids.cartesian import CartesianGrid
from .cuda_cartesian import (
    _NVCC_FLAGS,
    _PACKAGE,
    KernelUnsupportedError,
    _ghost,
    _neighbours,
    affine_bc_specs,
    affine_window,
    bf16_refusal,
)
from .cuda_march import MarchWindow
from .cuda_stencil_2d import _DTYPES, SMEM_BUDGET, _library, along

#: deepest temporal block one pass takes (the TPU kernel's cap)
MAX_STEPS = 4
#: steps per pass at the top of the window's ladder: the k of the least time per
#: step on the H100 (``scripts/torch_affine3d_sweep.py``, PERF.md)
TOP_STEPS = 4
#: a CUDA grid's y and z extents (the tile counts along y and x)
_MAX_BLOCKS = 65535
#: the march's output column tile along z: 256-cell rows take no ragged tile
MARCH_TZ = 64
#: its y extents, largest first
MARCH_TY = (32, 16, 8)
#: x planes per chunk
MARCH_CX = 32
#: shared-memory planes per level of the march (``MarchShape::kSlots``)
MARCH_SLOTS = 2

_CSRC = _PACKAGE / "csrc"
_TEMPLATE = _CSRC / "affine_laplace_3d.cuh"
#: the march geometry both 3D templates include
_MARCH = _CSRC / "march_3d.cuh"


# -- the march's plan -------------------------------------------------------------------------
def march_plan(levels: int, slots: int, halo: int, itemsize: int,
               budget: int = SMEM_BUDGET) -> tuple[int, int, int] | None:
    """The plan ``(cx, ty, tz)`` of a march that keeps `slots` shared-memory
    window planes for each of `levels` levels, with `halo` cells of halo per
    side: chunks of :data:`MARCH_CX` x planes, column tiles :data:`MARCH_TZ`
    cells along z and the largest of :data:`MARCH_TY` along y whose planes
    fit `budget` bytes (by default :data:`.cuda_stencil_2d.SMEM_BUDGET`, two
    blocks per SM at least); None when none fits."""
    for ty in MARCH_TY:
        if levels * slots * (ty + 2 * halo) * (MARCH_TZ + 2 * halo) * itemsize <= budget:
            return (MARCH_CX, ty, MARCH_TZ)
    return None


def march_plan_3d(k: int, itemsize: int) -> tuple[int, int, int]:
    """The affine march's plan ``(cx, ty, tz)`` at k steps and this itemsize:
    :func:`march_plan` of k levels of :data:`MARCH_SLOTS` planes, halo k."""
    plan = march_plan(k, MARCH_SLOTS, k, itemsize)
    if plan is None:
        raise KernelUnsupportedError(f"No march plan fits k = {k} at {itemsize} bytes a cell")
    return plan


def halo_factor(tile, halo: int) -> float:
    """Cells a march block reads per cell it writes, with `halo` cells of halo
    around its plan ``(cx, ty, tz)``: ``prod_i (T_i + 2*halo) / T_i``."""
    factor = 1.0
    for t in tile:
        factor *= (t + 2 * halo) / t
    return factor


def check_block_counts(shape, tile) -> None:
    """Raise :class:`KernelUnsupportedError` where the tile (or chunk) counts
    along x or y pass the CUDA grid's limit (the count along z has room for
    any shape)."""
    for axis in (0, 1):
        if -(-shape[axis] // tile[axis]) > _MAX_BLOCKS:
            raise KernelUnsupportedError(
                f"{shape[axis]} cells along axis {axis} need more than {_MAX_BLOCKS} tiles"
            )


# -- the gate ---------------------------------------------------------------------------------
@dataclass(frozen=True)
class AffineLaplace3DSpec:
    """Everything one kernel pass needs, decided from the configuration."""

    shape: tuple[int, int, int]
    k: int
    a: float
    b: float
    scales: tuple[float, float, float]  # 1/dx² per axis
    periodic: tuple[bool, bool, bool]
    #: (const, f1, f2) of the low and high face of x, y and z
    sides: tuple[tuple[float, float, float], ...]
    dtype: torch.dtype
    #: the kernel's plan at this k and dtype: x chunk and (y, z) column tile
    tile: tuple[int, int, int]


def affine_laplace_3d_spec(
    grid, *, a: float, b: float, k: int, dtype, bcs=None
) -> AffineLaplace3DSpec:
    """Check that the kernel supports a configuration and describe it.

    Raises :class:`KernelUnsupportedError` exactly where the configuration
    is not supported; nothing here builds or touches a device.
    """
    if not isinstance(grid, CartesianGrid) or grid.num_axes != 3:
        raise KernelUnsupportedError("The kernel requires a 3D CartesianGrid")
    if dtype == torch.bfloat16:
        raise bf16_refusal("the 3D affine kernels #3 and #11",
                           "ops/pallas_cartesian.py:1495, 5510")
    if dtype not in (torch.float32, torch.float64):
        raise KernelUnsupportedError(f"The kernel takes float32 or float64 data, not {dtype}")
    if not 1 <= k <= MAX_STEPS:
        raise KernelUnsupportedError(f"The kernel takes 1 <= k <= {MAX_STEPS} steps, not {k}")
    if bcs is None and not all(grid.periodic):
        raise KernelUnsupportedError("Non-periodic grids require explicit boundary conditions")
    specs = None if bcs is None else affine_bc_specs(grid, bcs)
    sides = []
    periodic = []
    for ax in range(3):
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
    tile = march_plan_3d(k, _DTYPES[dtype][2])
    check_block_counts(grid.shape, tile)
    return AffineLaplace3DSpec(
        shape=tuple(grid.shape), k=int(k), a=float(a), b=float(b),
        scales=tuple((1.0 / grid.discretization**2).tolist()), periodic=tuple(periodic),
        sides=tuple(sides), dtype=dtype, tile=tile,
    )


# -- plain version ------------------------------------------------------------------------
def _update(spec: AffineLaplace3DSpec, center, pairs):
    """One step of ``a*f + b*lap(f)`` from the centre and the (low, high)
    neighbours of each axis, in the kernel's order of operations."""
    sx, sy, sz = spec.scales
    (up, down), (north, south), (west, east) = pairs
    if sx == sy == sz:
        lap6 = up + down + north + south + west + east - 6.0 * center
        return spec.a * center + (spec.b * sx) * lap6
    lap = (
        (up + down - 2.0 * center) * sx
        + (north + south - 2.0 * center) * sy
        + (west + east - 2.0 * center) * sz
    )
    return spec.a * center + spec.b * lap


def affine_laplace_3d_plain(data: torch.Tensor, spec: AffineLaplace3DSpec) -> torch.Tensor:
    """k plain PyTorch steps of ``f <- a*f + b*lap(f)`` (rolls for periodic
    axes, the ghost formula for affine faces)."""
    f = data
    for _ in range(spec.k):
        pairs = [
            _neighbours(f, ax, spec.periodic[ax], spec.sides[2 * ax], spec.sides[2 * ax + 1])
            for ax in range(3)
        ]
        f = _update(spec, f, pairs)
    return f


# -- emulation of the kernel's tiling ----------------------------------------------------------
def window_steps(cur: torch.Tensor, spec, g0, in_dom, edges) -> torch.Tensor:
    """k steps of the kernel on one window, as its threads compute them.

    Window cell 0 stands for cell `g0` of the grid (of the block, in the ext
    kernel); ``in_dom[ax]`` marks the window's cells along `ax` that lie in
    the domain, and ``edges[ax]`` says whether the low and the high face of
    `ax` are faces of the domain with ghosts. Cells outside the domain enter
    at zero and stay there; at every step the ghost plane of each such face
    is rewritten over the valid region of the two other axes, for cells
    whose coordinates there lie in the domain. Returns the window after k
    steps; its centre (k cells in from every side) is valid.
    """
    zero = torch.zeros((), dtype=cur.dtype)
    inside = along(in_dom[0], 0, 3) & along(in_dom[1], 1, 3) & along(in_dom[2], 2, 3)
    w = cur.shape
    for s in range(spec.k):
        lo, hi = s, [wa - s for wa in w]
        for ax in range(3):
            u, v = [b for b in range(3) if b != ax]
            span = [slice(lo, hi[b]) for b in range(3)]
            keep = in_dom[u][span[u]][:, None] & in_dom[v][span[v]][None, :]
            g_lo, g_hi = -1 - g0[ax], spec.shape[ax] - g0[ax]

            def plane(i, _ax=ax, _span=span):
                idx = list(_span)
                idx[_ax] = i
                return tuple(idx)

            if edges[ax][0] and lo <= g_lo and g_lo + 2 < hi[ax]:
                new = _ghost(spec.sides[2 * ax], cur[plane(g_lo + 1)], cur[plane(g_lo + 2)])
                cur[plane(g_lo)] = torch.where(keep, new, cur[plane(g_lo)])
            if edges[ax][1] and lo <= g_hi - 2 and g_hi < hi[ax]:
                new = _ghost(spec.sides[2 * ax + 1], cur[plane(g_hi - 1)], cur[plane(g_hi - 2)])
                cur[plane(g_hi)] = torch.where(keep, new, cur[plane(g_hi)])
        inner = tuple(slice(lo + 1, h - 1) for h in hi)
        pairs = []
        for ax in range(3):
            low, high = list(inner), list(inner)
            low[ax] = slice(lo, hi[ax] - 2)
            high[ax] = slice(lo + 2, hi[ax])
            pairs.append((cur[tuple(low)], cur[tuple(high)]))
        value = _update(spec, cur[inner], pairs)
        nxt = cur.clone()
        nxt[inner] = torch.where(inside[inner], value, zero)
        cur = nxt
    return cur


def affine_laplace_3d_tiled(
    data: torch.Tensor, spec: AffineLaplace3DSpec, tile=None
) -> torch.Tensor:
    """Pure-torch emulation of the CUDA kernel, tile by tile (`tile` defaults
    to the kernel's).

    Each output tile loads a window with k-deep halos on all six faces
    (periodic halos wrapped, zeros outside non-periodic faces), rewrites the
    face ghosts and advances one level per step on the shrinking valid
    region, then writes its centre; the index maths are the kernel's.
    """
    tile = spec.tile if tile is None else tuple(tile)
    k = spec.k
    zero = torch.zeros((), dtype=data.dtype)
    out = torch.empty_like(data)
    for origin in itertools.product(*(range(0, n, t) for n, t in zip(spec.shape, tile))):
        g0 = [o - k for o in origin]
        w = [t + 2 * k for t in tile]
        index, in_dom = [], []
        for ax in range(3):
            g = torch.arange(g0[ax], g0[ax] + w[ax])
            n = spec.shape[ax]
            if spec.periodic[ax]:
                index.append(g % n)
                in_dom.append(torch.ones(w[ax], dtype=torch.bool))
            else:
                index.append(g.clamp(0, n - 1))
                in_dom.append((g >= 0) & (g < n))
        inside = along(in_dom[0], 0, 3) & along(in_dom[1], 1, 3) & along(in_dom[2], 2, 3)
        cur = torch.where(inside, data[tuple(along(i, ax, 3) for ax, i in enumerate(index))], zero)
        edges = [(not p, not p) for p in spec.periodic]
        cur = window_steps(cur, spec, g0, in_dom, edges)
        sizes = [min(t, n - o) for t, n, o in zip(tile, spec.shape, origin)]
        out[tuple(slice(o, o + n) for o, n in zip(origin, sizes))] = cur[
            tuple(slice(k, k + n) for n in sizes)
        ]
    return out


# -- replay of the kernel's march --------------------------------------------------------------
def march_block(win: MarchWindow, spec, k: int, planes: int, store) -> None:
    """One block's march as the kernel schedules it (``march_3d`` of
    ``csrc/affine_laplace_3d.cuh``): iteration t brings level 0 of window
    plane t, then level s + 1 of plane t - s - 1 for s = 0 .. k - 1, each
    level's new plane going into its slot (one of :data:`MARCH_SLOTS`) after
    the level above has read its operands. Shared-memory slots start as NaN,
    so a read of a cell the schedule has not written yet (or has
    overwritten) poisons the result. The replay runs the threads in
    lockstep, but between two barriers they race: a read of another
    thread's cell (a y or z neighbour) from a slot that any thread stores to
    in the same iteration reads NaN too. Ghosts are formed where they are
    read, in the kernel's order. ``store(w, [values], mask)`` takes level k
    of window plane w."""
    wy, wz = win.load.shape
    dtype = spec.dtype
    nan = torch.full((wy, wz), float("nan"), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    y = torch.arange(wy)[:, None]
    z = torch.arange(wz)[None, :]
    depth = torch.minimum(torch.minimum(y, wy - 1 - y), torch.minimum(z, wz - 1 - z))
    smem = {(s, r): nan.clone() for s in range(k) for r in range(MARCH_SLOTS)}

    def slot(s, w):
        return (s, w % MARCH_SLOTS)

    y_lo, y_hi, z_lo, z_hi = win.edges
    for t in range(planes):
        stored = {slot(s, t - s) for s in range(k) if t >= 2 * s}  # slots written in t
        new = torch.where(win.load & win.plane(t)[0], win.read(t)[0], zero)
        for s in range(k):
            nxt = nan
            if t >= 2 * s + 2:
                w = t - s - 1
                _, x_domain, x_lo, x_hi = win.plane(w)
                cur = smem[slot(s, w)]
                active = depth >= s + 1
                inside = win.domain & x_domain
                center, up, down = cur, smem[slot(s, w - 1)], new
                shared = nan if slot(s, w) in stored else cur  # as other threads see it
                north, south = shared.roll(1, 0), shared.roll(-1, 0)
                west, east = shared.roll(1, 1), shared.roll(-1, 1)
                if x_lo:
                    up = _ghost(spec.sides[0], center, down)
                if x_hi:
                    down = _ghost(spec.sides[1], center, up)
                north = torch.where(y_lo, _ghost(spec.sides[2], center, south), north)
                south = torch.where(y_hi, _ghost(spec.sides[3], center, north), south)
                west = torch.where(z_lo, _ghost(spec.sides[4], center, east), west)
                east = torch.where(z_hi, _ghost(spec.sides[5], center, west), east)
                value = _update(spec, center, [(up, down), (north, south), (west, east)])
                nxt = torch.where(active & inside, value, zero)
                if s + 1 == k:
                    store(w, [nxt], active & win.out)
            if t >= 2 * s:
                smem[slot(s, t - s)] = torch.where(depth >= s, new, smem[slot(s, t - s)])
            new = nxt


def grid_window(datas, shape, periodic, origin, tile, halo: int) -> MarchWindow:
    """The serial kernels' window (``GridGeo``) of the block whose first output
    cell is `origin`, with `halo` cells of halo: periodic axes wrap, cells
    outside a non-periodic axis are outside the domain; ``read`` gives one
    plane of each of `datas`, ``row`` a window plane's x and ``cols`` the
    window columns' (y, z) in the grid, unwrapped (the side inputs' faces
    are read there)."""
    columns, coords = [], []
    for ax in (1, 2):
        g = torch.arange(origin[ax] - halo, origin[ax] + tile[ax] + halo)
        coords.append(g)
        n, per = shape[ax], periodic[ax]
        inside = torch.ones_like(g, dtype=torch.bool) if per else (g >= 0) & (g < n)
        no_face = torch.zeros_like(inside)
        columns.append((
            g % n if per else g.clamp(0, n - 1), inside,
            no_face if per else g == 0, no_face if per else g == n - 1,
            (g >= origin[ax]) & (g < origin[ax] + tile[ax]) & (g < n),
        ))
    (iy, dy, ly, hy, oy), (iz, dz, lz, hz, oz) = columns
    domain = dy[:, None] & dz[None, :]
    edges = (domain & ly[:, None], domain & hy[:, None], domain & lz[None, :], domain & hz[None, :])
    out = domain & oy[:, None] & oz[None, :]
    nx, per_x = shape[0], periodic[0]

    def plane(w):
        gx = origin[0] - halo + w
        x_in = per_x or 0 <= gx < nx
        return x_in, x_in, not per_x and gx == 0, not per_x and gx == nx - 1

    def read(w):
        return [d[(origin[0] - halo + w) % nx][iy[:, None], iz[None, :]] for d in datas]

    def row(w):
        return origin[0] - halo + w

    return MarchWindow(domain, domain, edges, out, plane, read, row, cols=tuple(coords))


def march_blocks(shape, halo: int, tile, window: Callable, march: Callable, n_out: int,
                 dtype) -> list[torch.Tensor]:
    """Every block's march over `shape` at the plan `tile`, in the kernels'
    grid of chunks and column tiles, with `halo` cells of halo: ``window(origin)``
    gives the :class:`MarchWindow` of the block whose first output cell is
    `origin`, and ``march(window, planes, store)`` replays its march over
    `planes` window planes, handing each output plane of its `n_out`
    volumes to ``store(w, values, mask)``. Returns the volumes; cells no
    block writes stay NaN."""
    outs = [torch.full(tuple(shape), float("nan"), dtype=dtype) for _ in range(n_out)]
    for origin in itertools.product(*(range(0, n, t) for n, t in zip(shape, tile))):
        sizes = [min(t, n - o) for t, n, o in zip(tile, shape, origin)]
        region = (slice(halo, halo + sizes[1]), slice(halo, halo + sizes[2]))
        target = (slice(origin[1], origin[1] + sizes[1]), slice(origin[2], origin[2] + sizes[2]))

        def store(w, values, mask, x=origin[0] - halo, region=region, target=target):
            for out, value in zip(outs, values, strict=True):
                cells = (x + w, *target)
                out[cells] = torch.where(mask[region], value[region], out[cells])

        march(window(origin), sizes[0] + 2 * halo, store)
    return outs


def affine_laplace_3d_marched(
    data: torch.Tensor, spec: AffineLaplace3DSpec, tile=None,
) -> torch.Tensor:
    """Pure-torch replay of the CUDA kernel's march, block by block (`tile`,
    the plan ``(cx, ty, tz)``, defaults to the kernel's): see
    :func:`march_block`. Cells no block writes stay NaN."""
    tile = spec.tile if tile is None else tuple(tile)
    k = spec.k
    (out,) = march_blocks(
        spec.shape, k, tile,
        lambda origin: grid_window([data], spec.shape, spec.periodic, origin, tile, k),
        lambda win, planes, store: march_block(win, spec, k, planes, store), 1, data.dtype)
    return out


# -- the CUDA build ----------------------------------------------------------------------------
def emit_source(periodic: tuple[bool, bool, bool]) -> str:
    """The generated entry points: the template instantiated for every k and
    dtype at the plan :func:`march_plan_3d` picks for them, for one
    periodicity."""
    flags = ", ".join(str(bool(p)).lower() for p in periodic)
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_cartesian_3d.py: one instantiation per",
        f"// (k, dtype) at its plan, for periodic axes ({flags}); the kernel is the",
        "// template in pde_tpu_torch/csrc/affine_laplace_3d.cuh.",
        '#include "affine_laplace_3d.cuh"',
        "",
    ]
    for ctype, suffix, itemsize in _DTYPES.values():
        lines += [
            f'extern "C" int affine_laplace_3d_{suffix}(const void* in, void* out, const int* ints,',
            "                                     const double* doubles, void* stream) {",
            "  switch (ints[6]) {",
        ]
        for k in range(1, MAX_STEPS + 1):
            cx, ty, tz = march_plan_3d(k, itemsize)
            lines.append(
                f"    case {k}: return pde_tpu_torch::launch_affine_3d<{ctype}, {k}, {cx}, {ty}, "
                f"{tz}, {flags}>(in, out, ints, doubles, stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


class _KernelSource:
    """The kernel's generated source for one periodicity, as a build unit of
    :func:`.cuda_stencil_2d.build_programs`."""

    library = "affine_laplace_3d"

    def __init__(self, periodic: tuple[bool, bool, bool]):
        self.periodic = periodic
        self.source = emit_source(periodic)
        text = self.source + _TEMPLATE.read_text() + _MARCH.read_text() + " ".join(_NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @staticmethod
    def load(path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for name in ("affine_laplace_3d_f32", "affine_laplace_3d_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # in, out
                ctypes.c_void_p,  # ints: 10 host ints
                ctypes.c_void_p,  # doubles: 23 host doubles
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib


@functools.cache
def kernel_source(periodic: tuple[bool, bool, bool]) -> _KernelSource:
    """The kernel's build unit for axes of this periodicity
    (``build_programs([kernel_source(spec.periodic)])`` builds it)."""
    return _KernelSource(tuple(bool(p) for p in periodic))


# -- the wrapper ------------------------------------------------------------------------------
def affine_laplace_3d(
    data: torch.Tensor, spec: AffineLaplace3DSpec, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``(a*I + b*lap)^k data`` as described by `spec`.

    A CPU tensor gets the plain version. A CUDA tensor goes through the CUDA
    kernel, which writes `out` (allocated when not given; it must not be
    `data`, since tiles read their neighbours' cells); any failure raises.
    ``affine_laplace_3d.launches`` counts kernel launches.
    """
    if tuple(data.shape) != spec.shape or data.dtype != spec.dtype:
        raise ValueError(
            f"Expected a {spec.shape} {spec.dtype} tensor, got {tuple(data.shape)} {data.dtype}"
        )
    if data.device.type == "cpu":
        result = affine_laplace_3d_plain(data, spec)
        return result if out is None else out.copy_(result)
    if data.device.type != "cuda":
        raise RuntimeError(f"No 3D affine Laplacian kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("The kernel needs a contiguous tensor")
    if out is None:
        out = torch.empty_like(data)
    elif (
        out.shape != data.shape or out.dtype != data.dtype or out.device != data.device
        or not out.is_contiguous() or out.data_ptr() == data.data_ptr()
    ):
        raise ValueError("`out` must be a distinct contiguous tensor like `data`")
    lib = _library(kernel_source(spec.periodic))
    launch = lib.affine_laplace_3d_f32 if spec.dtype == torch.float32 else lib.affine_laplace_3d_f64
    ints = (ctypes.c_int * 10)(*spec.shape, *spec.tile, spec.k, *map(int, spec.periodic))
    doubles = (ctypes.c_double * 23)(
        spec.a, spec.b, *spec.scales, *[v for side in spec.sides for v in side]
    )
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = launch(data.data_ptr(), out.data_ptr(), ctypes.addressof(ints),
                     ctypes.addressof(doubles), stream)
    if err != 0:
        raise RuntimeError(f"affine_laplace_3d kernel launch failed with CUDA error {err}")
    affine_laplace_3d.launches += 1
    return out


affine_laplace_3d.launches = 0


def make_affine_laplace_3d(
    grid, *, a: float = 0.0, b: float = 1.0, k: int = 1, dtype=torch.float32, bcs=None,
) -> Callable:
    """Return ``f -> (a*I + b*lap)^k f`` as one kernel pass.

    Without ``bcs`` the grid must be fully periodic; with ``bcs``, axes may
    carry scalar constant affine BCs (Dirichlet/Neumann/Robin/curvature),
    whose ghost cells the kernel rewrites at every intermediate step. The
    returned callable takes ``(data, out=None)``.
    """
    spec = affine_laplace_3d_spec(grid, a=a, b=b, k=k, dtype=dtype, bcs=bcs)

    def affine_laplace(data, out=None):
        return affine_laplace_3d(data, spec, out=out)

    return affine_laplace


def make_fused_euler_window_3d(
    grid, *, diffusivity: float, dt: float, dtype=torch.float32, k: int = TOP_STEPS, bcs=None,
) -> Callable:
    """Return ``window(data, steps) -> data`` advancing `steps` Euler steps of
    diffusion, k steps per kernel pass.

    The step count is split over a binary ladder of passes (k, k/2, ..., 1),
    so a remainder costs O(log k) passes. Passes alternate between two
    buffers; the input is never written. The window carries its ``specs``.
    """
    specs = []
    while k >= 1:
        specs.append(
            affine_laplace_3d_spec(grid, a=1.0, b=dt * diffusivity, k=k, dtype=dtype, bcs=bcs)
        )
        k //= 2
    return affine_window(specs, affine_laplace_3d)
