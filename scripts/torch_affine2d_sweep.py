"""Design sweep of pde_tpu_torch's two 2D affine Laplacian kernels on one NVIDIA GPU.

Times variants of the row march (``AffineRowMarch`` of
``pde_tpu_torch/csrc/affine_march_2d.cuh``) on the main path's pass,
``DiffusionPDE(0.1)`` at dt = 0.1 on a 4096² periodic grid (``uniform(0, 1)``,
seed 17), through the serial kernel (row 1) and, for some, through the
halo-extended kernel (row 12) over the four 2048² blocks of a 2x2 mesh (halo
k, flags 0). The variants (the production plan wherever one is not named):

- the control: a copy of the parent's tile kernels, held in this script (a
  64x64 output tile loading a (64 + 2k)² window, 256 threads, two shared
  window buffers, two barriers a level), serial at k = 8 and 16, ext at 16;
- the plan's level-0 rows in flight (1 or 3) and the launch bounds' blocks per
  SM (1, 3 or 4) at k = 8, 10, 12 and 16, 1-3 rows in flight at k = 1, 2 and
  4; in fp64 1 or 3 rows and 1 or 2 blocks at k = 1, 2, 4, 6, 8, 12 and 16;
- at k = 8 and 16: strips ``tx`` of 128 and 512 columns (production 256),
  two window columns a thread, chunks one step either side of
  ``chunk_rows`` (64 and 256 rows against 128), the ext kernel;
- the column neighbours through ``__shfl_up_sync``/``__shfl_down_sync``
  (shared memory only at warp edges), a copy of the template rewritten by this
  script.

Each variant is held against its plain version (chip_smoke's tolerances:
1e-6 x k relative to max|f| in fp32, 1e-12 in fp64) and timed with CUDA events
over 50 passes, all variants in turns, twice; ptxas' registers and spills
beside each, and the SASS opcode counts of the production kernel at the top
k. Then the production wrappers: the serial kernel at every k in fp32 (and
k = 4, 8, 16 in fp64), the ext kernel at every k of the ladder, and the
registry's ``laplace`` (row 1 at k = 1), each with ms per step and its share
of the bound.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_affine2d_sweep.py [--production | --dtype bf16]

``--production`` skips the variants and times only what any checkout of the
port since its 2D ext kernel has (the wrappers above): copied into an older
checkout, it times that checkout's kernels, so that old and new can be read
in turns in one call.

One line per variant and wrapper (both rounds' ms, ms per step, share of the
bound, error, ptxas' registers and spills), then the card's name and power
limit as ``nvidia-smi`` gives them.

``--dtype bf16`` sweeps the bf16 storage passes instead (ROADMAP B1(f)): the
serial kernel's bf16 entry points (the float32 march at its plan, loading
and storing bf16, every level rounded to bf16) on the same 4096² state cast
to bf16, at every k from 1 to 16, beside the float32 passes in turns (two
rounds); each bf16 pass held within one bf16 ulp of max|f| of its plain
version (the share of cells that differ printed), its ms per step against
its 4-byte bound, ptxas' registers and spills; the last lines name each
dtype's k of the least time a step, against which the bf16 windows' top
(``TOP_STEPS``, float32's) is read.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

REPEATS = 50
N = 4096

# the parent's tile kernels (before the row march), the control variants
PARENT_SERIAL = r"""
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;
constexpr int kMaxSteps = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Side {
  double c, f1, f2;
};

struct Params {
  int n_rows, n_cols, k;
  int rows_periodic, cols_periodic;
  double a, b, sx, sy;
  Side row_lo, row_hi, col_lo, col_hi;
};

__device__ __forceinline__ int wrap_index(int i, int n) { return ((i % n) + n) % n; }

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    affine_laplace_2d_kernel(const T* __restrict__ in, T* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = p.k;
  const int w = kTile + 2 * k;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + w * w;

  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int gr0 = row0 - k;
  const int gc0 = col0 - k;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int i = ty; i < w; i += kBlockY) {
    const int gr = gr0 + i;
    const bool row_in = p.rows_periodic || (gr >= 0 && gr < p.n_rows);
    const int r = p.rows_periodic ? wrap_index(gr, p.n_rows) : gr;
    for (int j = tx; j < w; j += kBlockX) {
      const int gc = gc0 + j;
      const bool col_in = p.cols_periodic || (gc >= 0 && gc < p.n_cols);
      const int c = p.cols_periodic ? wrap_index(gc, p.n_cols) : gc;
      cur[i * w + j] = (row_in && col_in) ? in[static_cast<size_t>(r) * p.n_cols + c] : T(0);
    }
  }
  __syncthreads();

  const T a = T(p.a), b = T(p.b), sx = T(p.sx), sy = T(p.sy);
  const T bsx = T(p.b * p.sx);
  const bool isotropic = p.sx == p.sy;
  const int ghost_row_lo = -1 - gr0, ghost_row_hi = p.n_rows - gr0;
  const int ghost_col_lo = -1 - gc0, ghost_col_hi = p.n_cols - gc0;

  for (int s = 0; s < k; ++s) {
    const int lo = s, hi = w - s;
    if (!p.rows_periodic) {
      const bool do_lo = ghost_row_lo >= lo && ghost_row_lo + 2 < hi;
      const bool do_hi = ghost_row_hi - 2 >= lo && ghost_row_hi < hi;
      for (int j = lo + ty * kBlockX + tx; j < hi; j += kBlockX * kBlockY) {
        const int gc = gc0 + j;
        if (!(p.cols_periodic || (gc >= 0 && gc < p.n_cols))) continue;
        if (do_lo) {
          const int g = ghost_row_lo;
          cur[g * w + j] = ghost_value(p.row_lo, cur[(g + 1) * w + j], cur[(g + 2) * w + j]);
        }
        if (do_hi) {
          const int g = ghost_row_hi;
          cur[g * w + j] = ghost_value(p.row_hi, cur[(g - 1) * w + j], cur[(g - 2) * w + j]);
        }
      }
    }
    if (!p.cols_periodic) {
      const bool do_lo = ghost_col_lo >= lo && ghost_col_lo + 2 < hi;
      const bool do_hi = ghost_col_hi - 2 >= lo && ghost_col_hi < hi;
      for (int i = lo + ty * kBlockX + tx; i < hi; i += kBlockX * kBlockY) {
        const int gr = gr0 + i;
        if (!(p.rows_periodic || (gr >= 0 && gr < p.n_rows))) continue;
        if (do_lo) {
          const int g = ghost_col_lo;
          cur[i * w + g] = ghost_value(p.col_lo, cur[i * w + g + 1], cur[i * w + g + 2]);
        }
        if (do_hi) {
          const int g = ghost_col_hi;
          cur[i * w + g] = ghost_value(p.col_hi, cur[i * w + g - 1], cur[i * w + g - 2]);
        }
      }
    }
    __syncthreads();

    for (int i = lo + 1 + ty; i < hi - 1; i += kBlockY) {
      const int gr = gr0 + i;
      const bool row_in = p.rows_periodic || (gr >= 0 && gr < p.n_rows);
      for (int j = lo + 1 + tx; j < hi - 1; j += kBlockX) {
        const int gc = gc0 + j;
        const bool col_in = p.cols_periodic || (gc >= 0 && gc < p.n_cols);
        T v = T(0);
        if (row_in && col_in) {
          const T center = cur[i * w + j];
          const T up = cur[(i - 1) * w + j];
          const T down = cur[(i + 1) * w + j];
          const T left = cur[i * w + j - 1];
          const T right = cur[i * w + j + 1];
          if (isotropic) {
            v = a * center + bsx * (up + down + left + right - T(4) * center);
          } else {
            const T lap = (up + down - T(2) * center) * sx + (left + right - T(2) * center) * sy;
            v = a * center + b * lap;
          }
        }
        nxt[i * w + j] = v;
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int i = ty; i < kTile; i += kBlockY) {
    const int gr = row0 + i;
    if (gr >= p.n_rows) break;
    for (int j = tx; j < kTile; j += kBlockX) {
      const int gc = col0 + j;
      if (gc >= p.n_cols) break;
      out[static_cast<size_t>(gr) * p.n_cols + gc] = cur[(i + k) * w + j + k];
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int n_rows, int n_cols, int k, int rows_periodic,
           int cols_periodic, double a, double b, double sx, double sy, const double* sides,
           void* stream) {
  if (k < 1 || k > kMaxSteps || n_rows < 1 || n_cols < 1) return cudaErrorInvalidValue;
  Params p;
  p.n_rows = n_rows;
  p.n_cols = n_cols;
  p.k = k;
  p.rows_periodic = rows_periodic;
  p.cols_periodic = cols_periodic;
  p.a = a;
  p.b = b;
  p.sx = sx;
  p.sy = sy;
  Side* side_list[4] = {&p.row_lo, &p.row_hi, &p.col_lo, &p.col_hi};
  for (int i = 0; i < 4; ++i) {
    side_list[i]->c = sides[3 * i];
    side_list[i]->f1 = sides[3 * i + 1];
    side_list[i]->f2 = sides[3 * i + 2];
  }
  const int w = kTile + 2 * k;
  const size_t smem = 2 * static_cast<size_t>(w) * w * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(affine_laplace_2d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_cols + kTile - 1) / kTile, (n_rows + kTile - 1) / kTile);
  const dim3 block(kBlockX, kBlockY);
  affine_laplace_2d_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

}

extern "C" int affine_laplace_2d_f32(const void* in, void* out, int n_rows, int n_cols, int k,
                                     int rows_periodic, int cols_periodic, double a, double b,
                                     double sx, double sy, const double* sides, void* stream) {
  return launch<float>(in, out, n_rows, n_cols, k, rows_periodic, cols_periodic, a, b, sx, sy,
                       sides, stream);
}

extern "C" int affine_laplace_2d_f64(const void* in, void* out, int n_rows, int n_cols, int k,
                                     int rows_periodic, int cols_periodic, double a, double b,
                                     double sx, double sy, const double* sides, void* stream) {
  return launch<double>(in, out, n_rows, n_cols, k, rows_periodic, cols_periodic, a, b, sx, sy,
                        sides, stream);
}
"""

PARENT_EXT = r"""
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;
constexpr int kMaxSteps = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxBlocks = 8;

struct Side {
  double c, f1, f2;
};

struct Params {
  int n_rows, n_cols, halo, ld, k;
  double a, b, sx, sy;
  Side row_lo, row_hi, col_lo, col_hi;
};

template <typename T>
struct Blocks {
  const T* in[kMaxBlocks];
  T* out[kMaxBlocks];
  int edge[kMaxBlocks][4];
};

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

__device__ __forceinline__ bool in_domain(int i, int n, bool lo_edge, bool hi_edge) {
  return (!lo_edge || i >= 0) && (!hi_edge || i < n);
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    affine_laplace_ext_2d_kernel(Blocks<T> blocks, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const T* __restrict__ in = blocks.in[z];
  T* __restrict__ out = blocks.out[z];
  const bool e_rlo = blocks.edge[z][0] != 0, e_rhi = blocks.edge[z][1] != 0;
  const bool e_clo = blocks.edge[z][2] != 0, e_chi = blocks.edge[z][3] != 0;
  const int k = p.k;
  const int h = p.halo;
  const int ld = p.ld;
  const int w = kTile + 2 * k;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + w * w;

  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int gr0 = row0 - k;
  const int gc0 = col0 - k;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int i = ty; i < w; i += kBlockY) {
    const int gr = gr0 + i;
    const bool row_in = in_domain(gr, p.n_rows, e_rlo, e_rhi) && gr < p.n_rows + h;
    for (int j = tx; j < w; j += kBlockX) {
      const int gc = gc0 + j;
      const bool col_in = in_domain(gc, p.n_cols, e_clo, e_chi) && gc < p.n_cols + h;
      cur[i * w + j] =
          (row_in && col_in) ? in[static_cast<size_t>(gr + h) * ld + gc + h] : T(0);
    }
  }
  __syncthreads();

  const T a = T(p.a), b = T(p.b), sx = T(p.sx), sy = T(p.sy);
  const T bsx = T(p.b * p.sx);
  const bool isotropic = p.sx == p.sy;
  const int ghost_row_lo = -1 - gr0, ghost_row_hi = p.n_rows - gr0;
  const int ghost_col_lo = -1 - gc0, ghost_col_hi = p.n_cols - gc0;

  for (int s = 0; s < k; ++s) {
    const int lo = s, hi = w - s;
    if (e_rlo || e_rhi) {
      const bool do_lo = e_rlo && ghost_row_lo >= lo && ghost_row_lo + 2 < hi;
      const bool do_hi = e_rhi && ghost_row_hi - 2 >= lo && ghost_row_hi < hi;
      for (int j = lo + ty * kBlockX + tx; j < hi; j += kBlockX * kBlockY) {
        if (!in_domain(gc0 + j, p.n_cols, e_clo, e_chi)) continue;
        if (do_lo) {
          const int g = ghost_row_lo;
          cur[g * w + j] = ghost_value(p.row_lo, cur[(g + 1) * w + j], cur[(g + 2) * w + j]);
        }
        if (do_hi) {
          const int g = ghost_row_hi;
          cur[g * w + j] = ghost_value(p.row_hi, cur[(g - 1) * w + j], cur[(g - 2) * w + j]);
        }
      }
    }
    if (e_clo || e_chi) {
      const bool do_lo = e_clo && ghost_col_lo >= lo && ghost_col_lo + 2 < hi;
      const bool do_hi = e_chi && ghost_col_hi - 2 >= lo && ghost_col_hi < hi;
      for (int i = lo + ty * kBlockX + tx; i < hi; i += kBlockX * kBlockY) {
        if (!in_domain(gr0 + i, p.n_rows, e_rlo, e_rhi)) continue;
        if (do_lo) {
          const int g = ghost_col_lo;
          cur[i * w + g] = ghost_value(p.col_lo, cur[i * w + g + 1], cur[i * w + g + 2]);
        }
        if (do_hi) {
          const int g = ghost_col_hi;
          cur[i * w + g] = ghost_value(p.col_hi, cur[i * w + g - 1], cur[i * w + g - 2]);
        }
      }
    }
    __syncthreads();

    for (int i = lo + 1 + ty; i < hi - 1; i += kBlockY) {
      const bool row_in = in_domain(gr0 + i, p.n_rows, e_rlo, e_rhi);
      for (int j = lo + 1 + tx; j < hi - 1; j += kBlockX) {
        const bool col_in = in_domain(gc0 + j, p.n_cols, e_clo, e_chi);
        T v = T(0);
        if (row_in && col_in) {
          const T center = cur[i * w + j];
          const T up = cur[(i - 1) * w + j];
          const T down = cur[(i + 1) * w + j];
          const T left = cur[i * w + j - 1];
          const T right = cur[i * w + j + 1];
          if (isotropic) {
            v = a * center + bsx * (up + down + left + right - T(4) * center);
          } else {
            const T lap = (up + down - T(2) * center) * sx + (left + right - T(2) * center) * sy;
            v = a * center + b * lap;
          }
        }
        nxt[i * w + j] = v;
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int i = ty; i < kTile; i += kBlockY) {
    const int gr = row0 + i;
    if (gr >= p.n_rows) break;
    for (int j = tx; j < kTile; j += kBlockX) {
      const int gc = col0 + j;
      if (gc >= p.n_cols) break;
      out[static_cast<size_t>(gr + h) * ld + gc + h] = cur[(i + k) * w + j + k];
    }
  }
}

template <typename T>
int launch(const void* const* ins, void* const* outs, const int* edges, int n_blocks,
           int n_rows, int n_cols, int halo, int ld, int k, double a, double b, double sx,
           double sy, const double* sides, void* stream) {
  if (k < 1 || k > kMaxSteps || k > halo || n_rows < halo || n_cols < halo ||
      ld < n_cols + 2 * halo || n_blocks < 1 || n_blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  Params p;
  p.n_rows = n_rows;
  p.n_cols = n_cols;
  p.halo = halo;
  p.ld = ld;
  p.k = k;
  p.a = a;
  p.b = b;
  p.sx = sx;
  p.sy = sy;
  Side* side_list[4] = {&p.row_lo, &p.row_hi, &p.col_lo, &p.col_hi};
  for (int i = 0; i < 4; ++i) {
    side_list[i]->c = sides[3 * i];
    side_list[i]->f1 = sides[3 * i + 1];
    side_list[i]->f2 = sides[3 * i + 2];
  }
  Blocks<T> blocks;
  for (int z = 0; z < n_blocks; ++z) {
    blocks.in[z] = static_cast<const T*>(ins[z]);
    blocks.out[z] = static_cast<T*>(outs[z]);
    for (int e = 0; e < 4; ++e) blocks.edge[z][e] = edges[4 * z + e];
  }
  const int w = kTile + 2 * k;
  const size_t smem = 2 * static_cast<size_t>(w) * w * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(affine_laplace_ext_2d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_cols + kTile - 1) / kTile, (n_rows + kTile - 1) / kTile, n_blocks);
  const dim3 block(kBlockX, kBlockY);
  affine_laplace_ext_2d_kernel<T>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(blocks, p);
  return cudaGetLastError();
}

}

extern "C" int affine_laplace_ext_2d_f32(const void* const* ins, void* const* outs,
                                         const int* edges, int n_blocks, int n_rows, int n_cols,
                                         int halo, int ld, int k, double a, double b, double sx,
                                         double sy, const double* sides, void* stream) {
  return launch<float>(ins, outs, edges, n_blocks, n_rows, n_cols, halo, ld, k, a, b, sx, sy,
                      sides, stream);
}

extern "C" int affine_laplace_ext_2d_f64(const void* const* ins, void* const* outs,
                                         const int* edges, int n_blocks, int n_rows, int n_cols,
                                         int halo, int ld, int k, double a, double b, double sx,
                                         double sy, const double* sides, void* stream) {
  return launch<double>(ins, outs, edges, n_blocks, n_rows, n_cols, halo, ld, k, a, b, sx, sy,
                      sides, stream);
}
"""

# the column neighbours by warp shuffles: the template's neighbour reads and
# shared-memory stores, rewritten (shared memory only at the warp's edges)
SHUFFLE = (
    ("T left = row[q - 1], right = row[q + 1];  // the column neighbours",
     "const unsigned lane = threadIdx.x & 31u;\n"
     "        T left = __shfl_up_sync(0xffffffffu, center, 1);\n"
     "        T right = __shfl_down_sync(0xffffffffu, center, 1);\n"
     "        if (lane == 0u) left = row[q - 1];\n"
     "        if (lane == 31u) right = row[q + 1];"),
    ("slot<L + 1, w>()[q] = x;",
     "if ((lane + 1u) % 32u < 2u) slot<L + 1, w>()[q] = x;"),
    ("dst[tid + m * NT] = next[R % P][m];",
     "if (((tid & 31) + 1) % 32 < 2) dst[tid + m * NT] = next[R % P][m];"),
)


def _variant(k: int, tx: int = 256, threads: int = 0, prefetch: int = 0, min_blocks: int = 0,
             chunk: int = 0, dtype: str = "float", route: str = "shared", ext: bool = False,
             control: bool = False) -> dict:
    return {"k": k, "tx": tx, "threads": threads, "prefetch": prefetch, "min_blocks": min_blocks,
            "chunk": chunk, "dtype": dtype, "route": route, "ext": ext, "control": control}


VARIANTS = (
    *(_variant(k, control=True) for k in (8, 16)),
    _variant(16, control=True, ext=True),
    # the plan: level-0 rows in flight and blocks per SM asked of ptxas, by k
    *(_variant(k, prefetch=p, min_blocks=b) for k in (8, 10, 12, 16)
      for p, b in ((1, 1), (3, 1), (1, 3), (3, 3), (1, 4), (3, 4))),
    *(_variant(k, prefetch=p) for k in (1, 2, 4) for p in (1, 2, 3)),
    *(_variant(k, dtype="double", prefetch=p, min_blocks=b) for k in (1, 2, 4, 6, 8, 12, 16)
      for p, b in ((1, 1), (3, 1), (1, 2), (3, 2))),
    # strips, two columns a thread, chunks, shuffles, the ext kernel
    *(v for k in (8, 16) for v in (
        _variant(k, tx=128), _variant(k, tx=512), _variant(k, threads=160),
        *(_variant(k, chunk=c) for c in (64, 256)),
        _variant(k, route="shuffle"), _variant(k, ext=True), _variant(k, ext=True, min_blocks=4))),
    *(_variant(16, tx=128, prefetch=p, min_blocks=5) for p in (1, 3)),
    *(_variant(16, chunk=256, prefetch=p, min_blocks=4) for p in (1, 3)),
)


def _plan(v) -> tuple[int, int, int, int]:
    """The variant's (tx, threads, prefetch, min_blocks): as given, else production's."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops.cuda_stencil_2d import row_threads

    _, _, prefetch, min_blocks = cc.affine_row_plan(v["k"], 4 if v["dtype"] == "float" else 8)
    return (v["tx"], v["threads"] or row_threads(v["tx"] + 2 * v["k"]),
            v["prefetch"] or prefetch, v["min_blocks"] or min_blocks)


def _label(v) -> str:
    kind = "ext 4x2048^2" if v["ext"] else "4096^2"
    if v["control"]:
        return f"{kind} {v['dtype']} k={v['k']} parent tile kernel (tile 64, 256 threads)"
    tx, threads, prefetch, min_blocks = _plan(v)
    chunk = "auto" if v["chunk"] == 0 else v["chunk"]
    return (f"{kind} {v['dtype']} k={v['k']} march tx={tx} threads={threads} prefetch={prefetch} "
            f"blocks/SM={min_blocks} chunk={chunk} neighbours={v['route']}")


class _Unit:
    """A source for ``build_programs``."""

    library = "affine2d_sweep"

    def __init__(self, source: str, salt: str):
        self.source = source
        self.digest = hashlib.sha256((source + salt).encode()).hexdigest()[:16]


def _march_source(variants, template: str | None) -> str:
    """The variants' entry points on the template (`template`: a rewritten copy
    of it, inlined; None: the template itself)."""
    lines = ['#include "affine_march_2d.cuh"'] if template is None else [template]
    for v in variants:
        plan = ", ".join(map(str, _plan(v)))
        if v["ext"]:
            lines += [
                f'extern "C" int variant_{v["index"]}(const void* const* ins, void* const* outs, '
                "const int* edges, int n_blocks, const int* ints, const double* doubles, "
                "void* stream) {",
                f"  return pde_tpu_torch::launch_affine_ext_2d<{v['dtype']}, {v['k']}, {plan}, true, "
                "true>(ins, outs, edges, n_blocks, ints, doubles, stream);", "}"]
        else:
            lines += [
                f'extern "C" int variant_{v["index"]}(const void* in, void* out, const int* ints, '
                "const double* doubles, void* stream) {",
                f"  return pde_tpu_torch::launch_affine_2d<{v['dtype']}, {v['k']}, {plan}, true, "
                "true>(in, out, ints, doubles, stream);", "}"]
    return "\n".join(lines) + "\n"


def bf16_ulp(ref) -> float:
    """One bf16 ulp of max|ref|: 2**(floor(log2 max|ref|) - 7)."""
    import math

    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def bf16_sweep() -> None:
    """The ``--dtype bf16`` sweep (see the module docstring)."""
    import numpy as np
    import torch

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    grid = pde.UnitGrid([N, N], periodic=True)
    f32 = torch.as_tensor(np.random.default_rng(17).random((N, N)), dtype=torch.float32,
                          device=device)
    datas = {torch.bfloat16: f32.to(torch.bfloat16), torch.float32: f32}
    units = {dtype: cc.kernel_source((True, True), "affine_laplace_2d", dtype == torch.bfloat16)
             for dtype in datas}
    built = dict(zip(units, cs.build_programs(list(units.values()))))
    print(f"[sweep bf16] built the bf16 and float32 libraries of #1 on {smi}", flush=True)
    cells = N * N
    runs = []  # (dtype, k, fn, error, share of differing cells, ptxas)
    for k in range(1, cc.MAX_STEPS + 1):
        for dtype, data in datas.items():
            spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtype)
            out = torch.empty_like(data)

            def run(spec=spec, data=data, out=out):
                cc.affine_laplace_2d(data, spec, out=out)

            run()
            torch.cuda.synchronize()
            ref = cc.affine_laplace_2d_plain(data, spec)
            diff = (out.double() - ref.double()).abs()
            if dtype == torch.bfloat16:
                err = float(diff.max()) / bf16_ulp(ref.double())
                if not (bool(torch.isfinite(out).all()) and err <= 1.0):
                    raise AssertionError(f"bf16 k={k}: {err} ulps from its plain version")
            else:
                err = float(diff.max()) / float(ref.abs().max())
                if err > smoke.F32_STEP_RTOL * k:
                    raise AssertionError(f"float32 k={k} disagrees with its plain version")
            share = float((diff > 0).double().mean())
            tx, threads, _, _ = spec.tile
            ptx = " | ".join(smoke._ptxas_of(built[dtype]["log"], "affine_laplace_2d_kernel",
                                             f"IfLi{k}ELi{tx}ELi{threads}E"))
            runs.append((dtype, k, run, err, share, ptx))
    times = [[smoke._cuda_ms(torch, fn, REPEATS) for _, _, fn, _, _, _ in runs] for _ in range(2)]
    per_step = {}
    for j, (dtype, k, _, err, share, ptx) in enumerate(runs):
        itemsize = 2 if dtype == torch.bfloat16 else 4
        b_ms = smoke._bound(2 * cells * itemsize, smoke._affine_flops((1.0, 1.0)) * k * cells)[0]
        best = min(times[0][j], times[1][j])
        per_step[(dtype, k)] = best / k
        what = (f"{err:.2f} bf16 ulps of max|f| from its plain version, {share:.4%} of cells "
                "differ" if itemsize == 2 else f"max_rel {err:.2e}")
        print(f"[sweep bf16] {str(dtype)[6:]} k={k}: {times[0][j]:.4f} / {times[1][j]:.4f} ms "
              f"(two rounds in turns, {best / k:.5f} ms per step, {b_ms / best:.1%} of the "
              f"{b_ms:.4f} ms bound), {what}; {ptx}", flush=True)
    for dtype in datas:
        k = min(range(1, cc.MAX_STEPS + 1), key=lambda kk: per_step[(dtype, kk)])
        print(f"[sweep bf16] {str(dtype)[6:]}: the least time a step at k = {k} "
              f"({per_step[(dtype, k)]:.5f} ms)", flush=True)
    print(smi)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_affine2d_sweep: torch.cuda.is_available() is False; no result")
    if sys.argv[1:] == ["--dtype", "bf16"]:
        return bf16_sweep()
    production_only = sys.argv[1:] == ["--production"]

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    dtypes = {"float": torch.float32, "double": torch.float64}
    grid = pde.UnitGrid([N, N], periodic=True)
    gen = np.random.default_rng(17)
    datas = {name: torch.as_tensor(gen.random((N, N)), dtype=dt, device=device)
             for name, dt in dtypes.items()}
    ext_ins = {name: [torch.as_tensor(np.pad(datas[name].cpu().numpy()[r:r + N // 2, c:c + N // 2],
                                             16, mode="wrap"), device=device)
                      for r in (0, N // 2) for c in (0, N // 2)] for name in dtypes}
    cells = N * N

    def spec_of(k, dtype, ext=False):
        if ext:
            return ce.affine_laplace_ext_spec(grid, (N // 2, N // 2), a=1.0, b=0.01, k=k,
                                              halo=16, dtype=dtypes[dtype])
        return cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtypes[dtype])

    def bound(k, dtype, ext=False):
        itemsize = 4 if dtype == "float" else 8
        n_bytes = (4 * (N // 2 + 32) ** 2 + cells if ext else 2 * cells) * itemsize
        return smoke._bound(n_bytes, smoke._affine_flops((1.0, 1.0)) * k * cells)[0]

    refs = {}

    def reference(k, dtype, ext=False):
        if (k, dtype, ext) not in refs:
            spec = spec_of(k, dtype, ext)
            if ext:
                refs[(k, dtype, ext)] = [ce.affine_laplace_ext_2d_plain(x, spec, [0] * 4)
                                         for x in ext_ins[dtype]]
            else:
                refs[(k, dtype, ext)] = [cc.affine_laplace_2d_plain(datas[dtype], spec)]
        return refs[(k, dtype, ext)]

    def check(label, got, k, dtype, ext=False):
        ref = reference(k, dtype, ext)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        tol = (smoke.F64_TOL if dtype == "double" else smoke.F32_STEP_RTOL * k) * scale
        if not (all(bool(torch.isfinite(g).all()) for g in got) and err <= tol):
            raise AssertionError(f"{label} disagrees with its plain version: {err}")
        return err

    variants = [dict(v, index=i) for i, v in enumerate(VARIANTS)]
    groups, units = [], []
    if not production_only:
        flags = " ".join(cc._NVCC_FLAGS)
        template = (cc._CSRC / "affine_march_2d.cuh").read_text()
        shuffled = template.replace("#pragma once\n", "")  # inlined into its unit
        for old, new in SHUFFLE:
            if old not in shuffled:
                raise AssertionError(f"the template no longer holds {old!r}")
            shuffled = shuffled.replace(old, new)
        for key in sorted({(v["dtype"], v["k"]) for v in variants
                           if not v["control"] and v["route"] == "shared"}):
            group = [v for v in variants if not v["control"] and v["route"] == "shared"
                     and (v["dtype"], v["k"]) == key]  # one nvcc per (dtype, k), in parallel
            groups.append(group)
            units.append(_Unit(_march_source(group, None), flags + template))
        shuffle = [v for v in variants if v["route"] == "shuffle"]
        groups.append(shuffle)
        units.append(_Unit(_march_source(shuffle, shuffled), flags))
        for ext in (False, True):
            group = [v for v in variants if v["control"] and v["ext"] == ext]
            groups.append(group)
            units.append(_Unit(PARENT_EXT if ext else PARENT_SERIAL, flags))
    top = getattr(cc, "TOP_STEPS", cc.MAX_STEPS)
    ladder = [top >> i for i in range(top.bit_length())]
    production = [cc.kernel_source((True, True)), ce.affine_ext_source((True, True))] if hasattr(
        cc, "kernel_source") else []
    built = cs.build_programs(units + production)
    print(f"[sweep] built {len(built)} libraries on {smi}", flush=True)

    runs = []  # (label, fn, error, ptxas, k, bound)
    for group, b in zip(groups, built):
        lib = ctypes.CDLL(b["path"])
        for v in group:
            k, dtype, ext = v["k"], v["dtype"], v["ext"]
            spec = spec_of(k, dtype, ext)
            suffix = "f32" if dtype == "float" else "f64"
            if v["control"]:
                fn = getattr(lib, f"affine_laplace{'_ext' if ext else ''}_2d_{suffix}")
            else:
                fn = getattr(lib, f"variant_{v['index']}")
            fn.restype = ctypes.c_int
            ints = ins = out_ptrs = edges = None
            sides = (ctypes.c_double * 12)(*[0.0] * 12)
            doubles = cc.step_doubles(spec) if hasattr(cc, "step_doubles") else None
            if ext:
                outs = [torch.empty_like(x) for x in ext_ins[dtype]]
                ins = (ctypes.c_void_p * 4)(*[x.data_ptr() for x in ext_ins[dtype]])
                out_ptrs = (ctypes.c_void_p * 4)(*[o.data_ptr() for o in outs])
                edges = (ctypes.c_int * 16)()
                ld = N // 2 + 32
                if v["control"]:
                    args = (ctypes.addressof(ins), ctypes.addressof(out_ptrs),
                            ctypes.addressof(edges), 4, N // 2, N // 2, 16, ld, k, 1.0, 0.01,
                            1.0, 1.0, ctypes.addressof(sides))
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
                        ctypes.c_double] * 4 + [ctypes.c_void_p] * 2
                else:
                    tx, threads, prefetch, _ = _plan(v)
                    chunk = v["chunk"] or cs.chunk_rows(N // 2, -(-(N // 2) // tx), 4)
                    ints = (ctypes.c_int * 11)(N // 2, N // 2, 16, ld, chunk, k, tx, threads,
                                               prefetch, 1, 1)
                    args = (ctypes.addressof(ins), ctypes.addressof(out_ptrs),
                            ctypes.addressof(edges), 4, ctypes.addressof(ints),
                            ctypes.addressof(doubles))
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            else:
                outs = [torch.empty_like(datas[dtype])]
                if v["control"]:
                    args = (datas[dtype].data_ptr(), outs[0].data_ptr(), N, N, k, 1, 1, 1.0,
                            0.01, 1.0, 1.0, ctypes.addressof(sides))
                    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
                        ctypes.c_double] * 4 + [ctypes.c_void_p] * 2
                else:
                    tx, threads, prefetch, _ = _plan(v)
                    chunk = v["chunk"] or cs.chunk_rows(N, -(-N // tx))
                    ints = (ctypes.c_int * 9)(N, N, chunk, k, tx, threads, prefetch, 1, 1)
                    args = (datas[dtype].data_ptr(), outs[0].data_ptr(), ctypes.addressof(ints),
                            ctypes.addressof(doubles))
                    fn.argtypes = [ctypes.c_void_p] * 5

            def launch(fn=fn, args=args, label=_label(v),
                       keep=(doubles, sides, ints, ins, out_ptrs, edges, outs)):
                err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"{label}: launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            h = 16
            got = [o[h:h + N // 2, h:h + N // 2] for o in outs] if ext else outs
            err = check(_label(v), got, k, dtype, ext)
            kernel = "control" if v["control"] else (
                f"affine_laplace{'_ext' if ext else ''}_2d_kernel")
            needle = "" if v["control"] else "I{}Li{}ELi{}ELi{}ELi{}ELi{}E".format(
                dtype[0], k, *_plan(v))
            ptx = ("" if v["control"] else " | ".join(smoke._ptxas_of(b["log"], kernel, needle)))
            runs.append((_label(v), launch, err, ptx, k, bound(k, dtype, ext)))

    # the production wrappers
    for dtype, ks in (("float", range(1, cc.MAX_STEPS + 1)), ("double", (4, 8, 16))):
        out = torch.empty_like(datas[dtype])
        for k in ks:
            spec = spec_of(k, dtype)

            def serial_pass(spec=spec, out=out, dtype=dtype):
                cc.affine_laplace_2d(datas[dtype], spec, out=out)

            serial_pass()
            torch.cuda.synchronize()
            err = check(f"affine_laplace_2d k={k}", [out], k, dtype)
            runs.append((f"production affine_laplace_2d 4096^2 {dtype} k={k}", serial_pass, err,
                         "", k, bound(k, dtype)))
    for k in sorted(set(ladder) | {16}, reverse=True):
        spec = spec_of(k, "float", ext=True)
        outs = [torch.empty_like(x) for x in ext_ins["float"]]

        def ext_pass(spec=spec, outs=outs):
            ce.affine_laplace_ext_2d(ext_ins["float"], outs, [[0] * 4] * 4, spec)

        ext_pass()
        torch.cuda.synchronize()
        err = check(f"affine_laplace_ext_2d k={k}", [o[16:16 + N // 2, 16:16 + N // 2]
                                                     for o in outs], k, "float", ext=True)
        runs.append((f"production affine_laplace_ext_2d 4x2048^2 float halo 16 k={k}", ext_pass,
                     err, "", k, bound(k, "float", ext=True)))
    laplace = pde.get_backend("cuda").make_operator(grid, "laplace", "periodic")
    lap = cc.affine_laplace_spec(grid, a=0.0, b=1.0, k=1, dtype=torch.float32)
    err = float((laplace(datas["float"]) - cc.affine_laplace_2d_plain(datas["float"], lap))
                .abs().max())
    runs.append(("production registry laplace 4096^2 float (k = 1)",
                 lambda: laplace(datas["float"]), err, "", 1, bound(1, "float")))

    if not production_only:  # SASS of the production kernel at the top k: opcodes by count
        from torch_sde_sweep import _sass_histogram

        tx, threads, _, _ = cc.affine_row_plan(top, 4)
        print(f"[sweep] SASS of the production affine_laplace_2d kernel (float, periodic, k = "
              f"{top}, tx {tx}, {threads} threads): " + _sass_histogram(
                  Path(cc._nvcc()).parent / "cuobjdump", built[len(units)]["path"],
                  "affine_laplace_2d_kernel", "IfLi{}ELi{}ELi{}E".format(top, tx, threads)),
              flush=True)

    times = [[smoke._cuda_ms(torch, fn, REPEATS) for _, fn, _, _, _, _ in runs] for _ in range(2)]
    for j, (label, _, err, ptx, k, b_ms) in enumerate(runs):
        print(f"[sweep] {label}: {times[0][j]:.4f} / {times[1][j]:.4f} ms (two rounds in turns, "
              f"{times[0][j] / k:.5f} ms per step, {b_ms / times[0][j]:.1%} of the {b_ms:.4f} ms "
              f"bound), max_abs {err:.3e}; {ptx}", flush=True)
    print(smi)


if __name__ == "__main__":
    sys.exit(main())
