"""Temporally blocked Euler-Maruyama windows: two generated CUDA kernels,
their plain versions, tile emulations, and the ladder window.

Port of the single-device 2D SDE path of :mod:`pde_tpu.ops.pallas_cartesian`:

- ``sde_stencil_2d`` replaces ``make_fused_sde_stencil_window_2d``: k Euler
  steps of a traced rhs per pass, plus the pre-scaled increments of a
  ``(k, n, m)`` device tensor, plane s added after step s;
- ``sde_kernel_noise_2d`` replaces ``make_fused_sde_kernel_noise_window_2d``:
  the same window, with the increments drawn in the kernel by Philox4x32-10
  (``csrc/philox.cuh``; plain version :mod:`.philox`), keyed by two seed
  words and counted by (global step, global row, global column), so the
  stream does not depend on the tiling;
- :func:`make_chunked_sde_window_2d` replaces the JAX package's function of
  that name: a step count split over the ladder of passes (k, k/2, ..., 1).

Both kernels are the Euler-Maruyama kernel of the template
``csrc/multi_stencil_2d.cuh`` (``sde_window_2d_kernel``: the multi-field
window of :mod:`.cuda_stencil_2d` for one field, with a noise policy and
index tables in place of index remainders). One source
is generated per rhs and noise mode (``staged``, or a law of
:data:`.philox.LAWS`), with every k of the ladder for float and double,
built with ``nvcc`` for ``sm_90a`` at first use into ``pde_tpu_torch/_build/``.
CPU tensors get the plain versions; CUDA tensors launch the kernel or raise.

Side inputs (B2(b), ``pde_tpu``'s ``_BCSideStager2D``): where a step's ghosts
read per-point or time-dependent BC values, the program carries the
:class:`.cuda_stencil_2d.SideInputs` of the deterministic windows, the source
names only each input's kind, and its entry points launch the template's
``sde_window_sides_2d_kernel`` (the same pass, the tables' pointers and
strides among its arguments), so the scalar-side kernel keeps its code. The
in-kernel stream does not depend on them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from dataclasses import dataclass
from typing import Callable

import torch

from . import philox
from .cuda_cartesian import _NVCC_FLAGS, KernelUnsupportedError
from .cuda_stencil_2d import (
    _CSRC,
    _DTYPES,
    _TEMPLATE,
    SideInputs,
    WindowProgram,
    _library,
    check_sides,
    emit_program,
    multi_stencil_spec,
    side_args,
    tiled_pass,
)

_PHILOX = _CSRC / "philox.cuh"
#: noise modes of a generated library: staged increments, or a law drawn in the kernel
NOISE_MODES = ("staged",) + philox.LAWS
_LAW_ENUM = {"normal": "kNormal", "irwin4": "kIrwin4", "rademacher": "kRademacher"}


class SdeProgram:
    """A traced one-field step with its noise mode and generated CUDA source."""

    def __init__(self, stencil: WindowProgram, noise: str):
        if stencil.n_fields != 1:
            raise KernelUnsupportedError("Euler-Maruyama windows advance one field")
        if noise not in NOISE_MODES:
            raise KernelUnsupportedError(
                f"No kernel noise for {noise!r} (expected one of {NOISE_MODES})"
            )
        self.stencil, self.noise = stencil, noise
        self.library = "sde_stencil_2d" if noise == "staged" else "sde_kernel_noise_2d"
        self.source = emit_sde_source(stencil, noise)
        text = self.source + _TEMPLATE.read_text() + _PHILOX.read_text() + " ".join(_NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    def load(self, path: str) -> ctypes.CDLL:
        return _load(path, self.library, self.stencil.sides is not None)


def emit_sde_source(stencil: WindowProgram, noise: str) -> str:
    """CUDA C++ of one traced step with a noise policy, and its C entry points
    (with the side inputs' tables and strides where the step reads them)."""
    staged = noise == "staged"
    sides = stencil.sides is not None
    side_params = "const void* const* sides, const long long* steps, " if sides else ""
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_sde_2d.py from a traced step; the kernel",
        "// is the template in pde_tpu_torch/csrc/multi_stencil_2d.cuh with the noise",
        "// policy " + ("StagedNoise." if staged else f"PhiloxNoise (csrc/philox.cuh), law {noise}."),
        '#include "multi_stencil_2d.cuh"',
        '#include "philox.cuh"',
        "",
        *emit_program(stencil),
    ]
    for dtype, (ctype, suffix, _) in _DTYPES.items():
        if staged:
            lines += [
                f'extern "C" int sde_stencil_2d_{suffix}(const void* in, void* out, const void* noise,',
                f"                                int n_rows, int n_cols, int k, {side_params}"
                "void* stream) {",
                f"  const pde_tpu_torch::StagedNoise<{ctype}> policy{{",
                f"      static_cast<const {ctype}*>(noise), static_cast<size_t>(n_rows) * n_cols}};",
            ]
        else:
            lines += [
                f'extern "C" int sde_kernel_noise_2d_{suffix}(const void* in, void* out, int n_rows,',
                "                                     int n_cols, int k, unsigned key0, unsigned key1,",
                f"                                     unsigned step0, double scale, {side_params}"
                "void* stream) {",
                f"  const pde_tpu_torch::PhiloxNoise<{ctype}, pde_tpu_torch::{_LAW_ENUM[noise]}> "
                f"policy{{key0, key1, step0, static_cast<{ctype}>(scale)}};",
            ]
        lines += [
            "  const void* ins[1] = {in};",
            "  void* outs[1] = {out};",
            "  switch (k) {",
        ]
        launcher, extra = ("launch_sides", "sides, steps, ") if sides else ("launch", "")
        for k in stencil.ladder:
            tile = stencil.tiles[dtype][k]
            lines.append(
                f"    case {k}: return pde_tpu_torch::{launcher}<Program, {ctype}, {k}, {tile}>"
                f"(ins, outs, n_rows, n_cols, {extra}stream, policy);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


@functools.cache
def _load(path: str, library: str, sides: bool = False) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    # the side inputs: a host array of device pointers and one of step strides
    side_types = [ctypes.c_void_p] * (2 if sides else 0)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{library}_{suffix}")
        if library == "sde_stencil_2d":
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in, out, noise planes
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_rows, n_cols, k
                *side_types,
                ctypes.c_void_p,  # stream
            ]
        else:
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # in, out
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_rows, n_cols, k
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,  # key words, first global step
                ctypes.c_double,  # increment scale
                *side_types,
                ctypes.c_void_p,  # stream
            ]
        fn.restype = ctypes.c_int
    return lib


# -- the gate ---------------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class SdeSpec:
    """One kernel pass: a noise program at k steps on one shape and dtype."""

    program: SdeProgram
    shape: tuple[int, int]
    k: int
    dtype: torch.dtype
    tile: int
    #: scale of the in-kernel increments, ``sqrt(dt * var / cell_volume)``
    #: (None for staged increments, which come scaled)
    scale: float | None = None

    @property
    def stencil_spec(self):
        return multi_stencil_spec(self.program.stencil, self.k, self.dtype)


def sde_spec(program: SdeProgram, k: int, dtype, scale: float | None = None) -> SdeSpec:
    """Describe one pass; raises :class:`KernelUnsupportedError` where the
    kernel does not take it (nothing is built here)."""
    base = multi_stencil_spec(program.stencil, k, dtype)
    if (program.noise == "staged") != (scale is None):
        raise ValueError("In-kernel noise needs its scale; staged noise comes scaled")
    return SdeSpec(program, base.shape, k, dtype, base.tile,
                   None if scale is None else float(scale))


# -- plain versions and tile emulations -------------------------------------------------------
def _philox_noise(spec: SdeSpec, ctl) -> Callable:
    """``noise(s, rows, cols)``: the in-kernel increments of pass step s."""
    seed_a, seed_b, step0 = (int(c) for c in ctl)

    def noise(s, rows, cols):
        return philox.cell_increments(
            spec.program.noise, (seed_a, seed_b), step0 + s, rows, cols, spec.dtype, spec.scale
        )

    return noise


def _plain(data, spec: SdeSpec, noise: Callable, sides=None) -> torch.Tensor:
    stencil = spec.program.stencil
    helpers = stencil.plain_helpers
    helpers.side_views = sides
    rows = torch.arange(spec.shape[0], device=data.device)
    cols = torch.arange(spec.shape[1], device=data.device)
    work = data
    try:
        for s in range(spec.k):
            helpers.step = s
            (work,) = stencil.plain_step([work])
            work = work + noise(s, rows, cols)
    finally:
        helpers.side_views = None
    return work


def sde_stencil_2d_plain(data, noise, spec: SdeSpec, sides=None) -> torch.Tensor:
    """k plain PyTorch steps on the whole plane, plane s of `noise` added
    after step s; `sides`: the pass's views of the program's side inputs
    (:meth:`.cuda_stencil_2d.SideInputs.for_pass`), where it has them."""
    return _plain(data, spec, lambda s, rows, cols: noise[s], sides)


def sde_kernel_noise_2d_plain(data, ctl, spec: SdeSpec, sides=None) -> torch.Tensor:
    """k plain PyTorch steps on the whole plane, :mod:`.philox`'s increments
    of global step ``ctl[2] + s`` added after step s; `sides` as above."""
    return _plain(data, spec, _philox_noise(spec, ctl), sides)


def sde_stencil_2d_tiled(data, noise, spec: SdeSpec, tile: int = 8, sides=None) -> torch.Tensor:
    """Emulation of kernel #10's tiling: each tile's halo cells read the
    increments of the global cells they stand for, and its ghosts the side
    inputs at the global cells along the side."""
    (out,) = tiled_pass(
        [data], spec.stencil_spec, tile, noise=lambda s, rows, cols: noise[s][rows][:, cols],
        sides=sides,
    )
    return out


def sde_kernel_noise_2d_tiled(data, ctl, spec: SdeSpec, tile: int = 8, sides=None) -> torch.Tensor:
    """Emulation of kernel #9's tiling, drawing the stream per global cell."""
    (out,) = tiled_pass([data], spec.stencil_spec, tile, noise=_philox_noise(spec, ctl),
                        sides=sides)
    return out


# -- the wrappers -----------------------------------------------------------------------------
def _check(data, spec: SdeSpec, out, sides):
    if tuple(data.shape) != spec.shape or data.dtype != spec.dtype:
        raise ValueError(
            f"Expected a {spec.shape} {spec.dtype} plane, got {tuple(data.shape)} {data.dtype}"
        )
    check_sides(spec.program.stencil, sides, spec, data.device)
    if data.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"No SDE window kernel for device {data.device}")
    if data.device.type == "cuda":
        if not data.is_contiguous():
            raise ValueError("The kernel needs a contiguous plane")
        if out is not None and (
            out.shape != data.shape or out.dtype != data.dtype or out.device != data.device
            or not out.is_contiguous() or out.data_ptr() == data.data_ptr()
        ):
            raise ValueError("`out` must be a distinct contiguous plane like `data`")


def _launch(fn, data, out, *args) -> torch.Tensor:
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA error {err}")
    return out


def sde_stencil_2d(data, noise, spec: SdeSpec, out=None, sides=None) -> torch.Tensor:
    """k Euler-Maruyama steps with staged increments (kernel #10).

    `noise` holds the pre-scaled increments, ``(k, n, m)`` of the plane's
    dtype and device; `sides` the pass's views of the program's side inputs
    (:meth:`.cuda_stencil_2d.SideInputs.for_pass`; required where it has
    them). CPU tensors get the plain version; CUDA tensors launch the
    kernel, which writes `out` (allocated when not given; it must not be
    `data`). ``sde_stencil_2d.launches`` counts kernel launches of both
    modes, ``.sides_launches`` those of the side-input mode.
    """
    if spec.program.noise != "staged":
        raise ValueError("This spec draws its increments in the kernel")
    _check(data, spec, out, sides)
    if tuple(noise.shape) != (spec.k, *spec.shape) or noise.dtype != spec.dtype \
            or noise.device != data.device:
        raise ValueError(f"Expected ({spec.k}, {spec.shape}) {spec.dtype} increments beside the plane")
    if data.device.type == "cpu":
        result = sde_stencil_2d_plain(data, noise, spec, sides)
        return result if out is None else out.copy_(result)
    if not noise.is_contiguous():
        raise ValueError("The kernel needs contiguous increments")
    out = torch.empty_like(data) if out is None else out
    lib = _library(spec.program)
    fn = lib.sde_stencil_2d_f32 if spec.dtype == torch.float32 else lib.sde_stencil_2d_f64
    side_arrays = side_args(spec.program.stencil, sides)
    _launch(fn, data, out, data.data_ptr(), out.data_ptr(), noise.data_ptr(),
            spec.shape[0], spec.shape[1], spec.k, *map(ctypes.addressof, side_arrays))
    sde_stencil_2d.launches += 1
    sde_stencil_2d.sides_launches += sides is not None
    return out


sde_stencil_2d.launches = 0
sde_stencil_2d.sides_launches = 0


def sde_kernel_noise_2d(data, ctl, spec: SdeSpec, out=None, sides=None) -> torch.Tensor:
    """k Euler-Maruyama steps with increments drawn in the kernel (kernel #9).

    ``ctl = (seed_a, seed_b, global_step_base)``, three uint32 values, as in
    the TPU kernel; `sides` as for :func:`sde_stencil_2d` (the stream does
    not depend on them). CPU tensors get the plain version; CUDA tensors
    launch the kernel or raise. ``sde_kernel_noise_2d.launches`` counts
    kernel launches of both modes, ``.sides_launches`` those of the
    side-input mode.
    """
    if spec.program.noise == "staged":
        raise ValueError("This spec takes staged increments")
    ctl = tuple(int(c) for c in ctl)
    if len(ctl) != 3 or not all(0 <= c <= philox.MASK32 for c in ctl):
        raise ValueError(f"`ctl` must be three uint32 values, got {ctl}")
    _check(data, spec, out, sides)
    if data.device.type == "cpu":
        result = sde_kernel_noise_2d_plain(data, ctl, spec, sides)
        return result if out is None else out.copy_(result)
    out = torch.empty_like(data) if out is None else out
    lib = _library(spec.program)
    fn = lib.sde_kernel_noise_2d_f32 if spec.dtype == torch.float32 else lib.sde_kernel_noise_2d_f64
    side_arrays = side_args(spec.program.stencil, sides)
    _launch(fn, data, out, data.data_ptr(), out.data_ptr(), spec.shape[0], spec.shape[1],
            spec.k, *ctl, spec.scale, *map(ctypes.addressof, side_arrays))
    sde_kernel_noise_2d.launches += 1
    sde_kernel_noise_2d.sides_launches += sides is not None
    return out


sde_kernel_noise_2d.launches = 0
sde_kernel_noise_2d.sides_launches = 0


# -- the ladder window ------------------------------------------------------------------------
def make_chunked_sde_window_2d(
    grid, make_step: Callable, halo_per_step: int, noise_fn: Callable | None, *,
    dtype=torch.float32, kernel_noise: dict | None = None, sides: SideInputs | None = None,
    dt: float | None = None,
) -> Callable:
    """Return ``window(data, window_seed, steps) -> data`` for Euler-Maruyama
    stepping of one field.

    ``make_step(helpers)`` is the deterministic step over one plane (as for
    :func:`.cuda_stencil_2d.make_chunked_multi_window_2d`).
    ``noise_fn(window_seed, indices, like) -> (len(indices), n, m)`` gives the
    pre-scaled increments of the window's steps `indices` for a plane `like`,
    from the same per-step stream as the plain step loop, so fused and plain
    trajectories differ only by rounding. ``kernel_noise={"dist", "scale"}``
    draws the increments in the kernel instead (`noise_fn` is unused): the
    key words come from the window seed, the step count from the position in
    the window. With the side inputs `sides` the ghosts' per-point and
    time-dependent parts become the kernel's arguments; where they depend on
    time the window is ``window(data, window_seed, t0, steps)`` of step `dt`
    (``window.needs_t``), inner step i at ``t0 + i*dt``, as ``pde_tpu``'s
    ``window(data, key, t0, steps)``. Passes alternate between two buffers;
    the input is never written. The window carries ``needs_key = True``,
    ``needs_t``, its ``program`` and ``specs``.
    """
    stencil = WindowProgram(grid, make_step, halo_per_step, 1, sides=sides)
    sides = stencil.sides
    needs_t = sides is not None and sides.needs_t
    if needs_t and dt is None:
        raise ValueError("A window whose side inputs depend on time needs its dt")
    if kernel_noise is None:
        program = SdeProgram(stencil, "staged")
        specs = [sde_spec(program, kk, dtype) for kk in stencil.ladder]
    else:
        program = SdeProgram(stencil, kernel_noise["dist"])
        specs = [sde_spec(program, kk, dtype, kernel_noise["scale"]) for kk in stencil.ladder]

    def window(data, window_seed, *args):
        t0, steps = args if needs_t else (0.0, *args)
        key = philox.seed_words(window_seed)
        buffers = None
        index = passes = 0
        remaining = int(steps)
        views = None if sides is None else sides.passes(t0, remaining, dt, data.dtype,
                                                        data.device)
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                if buffers is None:
                    buffers = (torch.empty_like(data), torch.empty_like(data))
                out = buffers[passes % 2]
                pass_sides = None if views is None else views(index, spec.k)
                if kernel_noise is None:
                    noise = noise_fn(window_seed, range(index, index + spec.k), data)
                    data = sde_stencil_2d(data, noise, spec, out=out, sides=pass_sides)
                else:
                    data = sde_kernel_noise_2d(data, (*key, index), spec, out=out,
                                               sides=pass_sides)
                index += spec.k
                passes += 1
        return data

    window.needs_key = True
    window.needs_t = needs_t
    window.n_aux = 0
    window.program = program
    window.specs = specs
    return window
