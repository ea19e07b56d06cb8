// Temporally blocked affine Laplacian on halo-extended 2D blocks, for Hopper
// (sm_90a): kernel #1 (affine_laplace_2d.cu) fed from the buffers of a
// decomposed grid.
//
// Replaces the TPU kernel `make_affine_laplace_ext_2d` of
// pde_tpu/ops/pallas_cartesian.py: for each local block of shape (n, m),
// held in an extended buffer of shape (n + 2h, m + 2h) (rows `ld` elements
// apart, ld >= m + 2h, so that rows can start on 128-byte lines) whose halo
// rings were filled from the neighbouring blocks, one pass computes
//     f <- (a*I + b*lap)^k f,   1 <= k <= h, k <= 16,
// on the block's interior and writes it into the interior of another buffer
// of the same shape. Edge flags (row_lo, row_hi, col_lo, col_hi) say which
// sides of the block lie on a non-periodic global edge; there the cells
// beyond the edge are held at zero and the single ghost row or column is
// rewritten at every step from the current level, ghost = c + f1*edge +
// f2*next_inward, as kernel #1 does on the global grid. Elsewhere the halo is
// trusted: it holds the neighbour's (or, on a periodic axis with one block,
// the block's own wrapped) cells.
//
// What bounds it on this card. As kernel #1: one pass reads and writes each
// interior cell once (the halo ring is read too, 4h(n + m) cells), so the
// bytes per cell-update fall as 1/k; past that the shared-memory traffic and
// the recomputed tile halos set the pace.
//
// Design. Kernel #1's tiling, unchanged: each block of threads owns a
// TILE x TILE output tile, loads a (TILE + 2k)^2 window with k-deep halos on
// four sides and runs the k steps in shared memory, ping-ponging two buffers.
// The window is read from the extended buffer at offset (h - k, h - k)
// relative to the tile, with the buffer's leading dimension: no index wraps.
// The global-edge tests of kernel #1 (`!periodic`) become the runtime flags.
// One launch covers up to kMaxBlocks local blocks of one device, which share
// a shape: blockIdx.z indexes a table of (input, output, flags).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;
constexpr int kMaxSteps = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxBlocks = 8;

struct Side {
  double c, f1, f2;  // ghost = c + f1 * edge + f2 * next_inward
};

struct Params {
  int n_rows, n_cols, halo, ld, k;  // block shape, halo and row stride of the buffers, steps
  double a, b, sx, sy;
  Side row_lo, row_hi, col_lo, col_hi;
};

template <typename T>
struct Blocks {
  const T* in[kMaxBlocks];
  T* out[kMaxBlocks];
  int edge[kMaxBlocks][4];  // row_lo, row_hi, col_lo, col_hi
};

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

// whether local index i along an axis of n cells lies in the domain
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
  const int w = kTile + 2 * k;  // side of the shared-memory window
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + w * w;

  const int row0 = blockIdx.y * kTile;  // first output row of this tile (local)
  const int col0 = blockIdx.x * kTile;
  const int gr0 = row0 - k;  // local row of window row 0
  const int gc0 = col0 - k;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // load the window from the buffer; cells beyond a flagged edge start at
  // zero, cells past the buffer (beyond the tiles' light cone) too
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
  // window indices of the ghost rows/columns at the block's flagged edges
  const int ghost_row_lo = -1 - gr0, ghost_row_hi = p.n_rows - gr0;
  const int ghost_col_lo = -1 - gc0, ghost_col_hi = p.n_cols - gc0;

  for (int s = 0; s < k; ++s) {
    const int lo = s, hi = w - s;  // level s is valid on [lo, hi)^2
    // rewrite the ghost cells of level s; a ghost is needed only when its
    // edge and next-inward cells lie in the valid region
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

    // level s+1 on [lo+1, hi-1)^2
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

  // write the centre tile into the interior of the output buffer
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

}  // namespace

// Plain C entry points, loaded with ctypes. `ins` and `outs` are host arrays
// of n_blocks device pointers to (n_rows + 2*halo, n_cols + 2*halo) buffers
// whose rows are `ld` elements apart; `edges` holds 4 host ints per block;
// `sides` 12 host doubles: (c, f1, f2) for the row-low, row-high, column-low
// and column-high sides. Each launches on `stream` without synchronising and
// returns the CUDA error code of the launch (0 on success).
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
