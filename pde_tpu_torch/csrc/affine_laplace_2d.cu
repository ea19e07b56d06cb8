// Temporally blocked affine Laplacian on a 2D Cartesian grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel `make_affine_laplace_2d` of
// pde_tpu/ops/pallas_cartesian.py: one pass over device memory computes
//     f <- (a*I + b*lap)^k f,   1 <= k <= 16,
// with the 5-point Laplacian, periodic axes, and constant affine ghost cells
// on non-periodic sides, ghost = c + f1*edge + f2*next_inward (Dirichlet,
// Neumann, Robin and curvature conditions).
//
// What bounds it on this card. One step per pass reads and writes each cell
// once: 8 B per fp32 cell update, so a single-step kernel is capped at
// HBM bandwidth / 8 B (a bound from the data sheet: 3.35 TB/s / 8 B =
// 4.2e11 updates/s on an H100 SXM, not a measurement). Temporal blocking
// divides those bytes by k; after that, shared-memory traffic (five loads and
// one store per update) and the arithmetic, including the halo cells that
// neighbouring tiles recompute, set the pace.
//
// Design. The TPU kernel keeps full-width row bands in VMEM and gets column
// neighbours from lane rolls; a 4096-wide band does not fit in 227 KB of
// shared memory, so here each block owns a TILE x TILE output tile and loads
// a (TILE + 2k)^2 window with k-deep halos on all four sides. Periodic halos
// wrap by index, ((i % n) + n) % n, so grids smaller than the halo wrap more
// than once. The k steps run in shared memory, ping-ponging two buffers; the
// valid region shrinks by one cell per side per step, and only the centre
// tile is written back. At every step the single ghost row or column at a
// non-periodic global edge is rewritten from the current level's edge and
// next-inward values; cells further out lie outside the light cone of the
// tile and are held at zero. The 5-point stencil never reads corner ghosts.
// With TILE = 64 and k = 16, a tile recomputes about 1.5x the cell updates
// it writes (the halo cost), in exchange for 1/16 of the device-memory bytes.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;
constexpr int kMaxSteps = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Side {
  double c, f1, f2;  // ghost = c + f1 * edge + f2 * next_inward
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
  const int w = kTile + 2 * k;  // side of the shared-memory window
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + w * w;

  const int row0 = blockIdx.y * kTile;  // first output row of this tile
  const int col0 = blockIdx.x * kTile;
  const int gr0 = row0 - k;  // global row of window row 0
  const int gc0 = col0 - k;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // load the window; cells outside a non-periodic domain start at zero
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
  // window indices of the ghost rows/columns at the global domain edges
  const int ghost_row_lo = -1 - gr0, ghost_row_hi = p.n_rows - gr0;
  const int ghost_col_lo = -1 - gc0, ghost_col_hi = p.n_cols - gc0;

  for (int s = 0; s < k; ++s) {
    const int lo = s, hi = w - s;  // level s is valid on [lo, hi)^2
    // rewrite the ghost cells of level s; a ghost is needed only when its
    // edge and next-inward cells lie in the valid region
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

    // level s+1 on [lo+1, hi-1)^2
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

  // write the centre tile
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

}  // namespace

// Plain C entry points, loaded with ctypes. `sides` holds 12 host doubles:
// (c, f1, f2) for the row-low, row-high, column-low and column-high sides.
// Each launches on `stream` without synchronising and returns the CUDA error
// code of the launch (0 on success).
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
