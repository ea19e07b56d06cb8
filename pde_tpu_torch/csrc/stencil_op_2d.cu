// Standalone first-order stencil operators on a 2D Cartesian grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel `make_stencil_op_pallas` of pde_tpu/ops/pallas_cartesian.py: one
// pass over device memory applies one operator to n_in planes and writes n_out planes,
//
//   gradient_squared   1 -> 1   (d_x f)^2 + (d_y f)^2
//   gradient           1 -> 2   d_x f, d_y f
//   divergence         2 -> 1   d_x v_0 + d_y v_1
//   vector_laplace     2 -> 2   lap v_0, lap v_1                      (5-point)
//   vector_gradient    2 -> 4   d_x v_0, d_y v_0, d_x v_1, d_y v_1   (out[i, j] = d_j v_i)
//   tensor_divergence  4 -> 2   d_x t_00 + d_y t_01, d_x t_10 + d_y t_11
//
// with central differences (d_x f = (f[i+1] - f[i-1]) * 0.5/dx) and the Laplacian
// (f[i-1] + f[i+1] - 2 f) / dx^2 + (f[j-1] + f[j+1] - 2 f) / dy^2, its isotropic form
// (up + down + left + right - 4 f) / dx^2 when dx = dy. Axes are periodic, or carry one
// constant affine condition per side for every plane: the neighbour beyond a global edge
// cell is the ghost c + f1 * edge + f2 * next_inward (Dirichlet, Neumann, Robin, curvature).
//
// What bounds it on this card. Each operator reads every input cell and writes every output
// cell once and does a few flops per output (<= 9 for the Laplacian), far below the fp32
// rate: the bound is the bytes, (n_in + n_out) planes over the HBM bandwidth (for
// vector_gradient on a 4096^2 fp32 grid, 6 x 64 MiB = 403 MB, 120 us at 3.35 TB/s).
//
// Design. The TPU kernel DMAs full-width row bands with 8-row halos into VMEM and takes the
// column neighbours from lane rolls. A radius-1 stencil applied once reuses each value five
// times at most, which the L1 cache catches, so this kernel uses no shared memory. Threads
// run along the contiguous (column) axis, so every load and store of a warp is one coalesced
// row segment; each thread owns kRows consecutive rows of one column and issues all loads of a
// plane (its kRows + 2 column values and kRows left and right neighbours) before it does any
// arithmetic, so many loads are in flight per thread. Periodic neighbours wrap by index;
// beyond a non-periodic edge the ghost formula replaces the neighbour. Global offsets are
// 64-bit. The operator, the type and each axis's periodicity are template parameters (one
// library holds all 48 instantiations); the outputs are planes of one stacked tensor.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockX = 32;  // threads along columns: one warp spans 32 columns
constexpr int kBlockY = 8;   // threads along rows
constexpr int kRows = 8;     // consecutive rows per thread
constexpr int kMaxPlanes = 4;

enum Op : int {
  kGradientSquared = 0,
  kGradient = 1,
  kDivergence = 2,
  kVectorLaplace = 3,
  kVectorGradient = 4,
  kTensorDivergence = 5,
};

__host__ __device__ constexpr int planes_in(int op) {
  return op == kGradientSquared || op == kGradient ? 1 : op == kTensorDivergence ? 4 : 2;
}

__host__ __device__ constexpr int planes_out(int op) {
  return op == kGradientSquared || op == kDivergence ? 1 : op == kVectorGradient ? 4 : 2;
}

struct Side {
  double c, f1, f2;  // ghost = c + f1 * edge + f2 * next_inward
};

struct Params {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int n_rows, n_cols;
  double hx, hy;  // 0.5/dx, 0.5/dy
  double sx, sy;  // 1/dx^2, 1/dy^2
  Side row_lo, row_hi, col_lo, col_hi;
};

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

template <int kOp, typename T, bool kRowsPeriodic, bool kColsPeriodic>
__global__ void __launch_bounds__(kBlockX * kBlockY) stencil_op_2d_kernel(const Params p) {
  constexpr int kIn = planes_in(kOp);
  constexpr int kOut = planes_out(kOp);
  const int n_rows = p.n_rows, n_cols = p.n_cols;
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row0 = (blockIdx.y * kBlockY + threadIdx.y) * kRows;
  if (col >= n_cols || row0 >= n_rows) return;
  const int rows = min(kRows, n_rows - row0);  // rows this thread writes

  // column neighbours; a non-periodic edge column takes a ghost instead
  int col_l = col - 1, col_r = col + 1;
  if (kColsPeriodic) {
    if (col_l < 0) col_l += n_cols;
    if (col_r >= n_cols) col_r -= n_cols;
  }
  const bool edge_l = !kColsPeriodic && col == 0;
  const bool edge_r = !kColsPeriodic && col == n_cols - 1;
  const T hx = T(p.hx), hy = T(p.hy), sx = T(p.sx), sy = T(p.sy);
  const bool isotropic = p.sx == p.sy;

  T acc[kOut][kRows];
#pragma unroll
  for (int f = 0; f < kIn; ++f) {
    const T* in = static_cast<const T*>(p.in[f]);
    // every load of this plane first: rows row0-1 .. row0+rows of this column, then the
    // left and right neighbours of the thread's rows
    T v[kRows + 2], l[kRows], r[kRows];
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
      int row = row0 - 1 + i;
      if (kRowsPeriodic) {
        if (row < 0) row += n_rows;
        else if (row >= n_rows) row -= n_rows;
      }
      const bool load = i <= rows + 1 && row >= 0 && row < n_rows;
      v[i] = load ? __ldg(in + static_cast<size_t>(row) * n_cols + col) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t base = static_cast<size_t>(row0 + i) * n_cols;
      l[i] = i < rows && !edge_l ? __ldg(in + base + col_l) : T(0);
      r[i] = i < rows && !edge_r ? __ldg(in + base + col_r) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= rows) continue;
      const int row = row0 + i;
      const T c = v[i + 1];
      T up = v[i], down = v[i + 2], left = l[i], right = r[i];
      if (!kRowsPeriodic) {
        if (row == 0) up = ghost_value(p.row_lo, c, down);
        else if (row == n_rows - 1) down = ghost_value(p.row_hi, c, up);
      }
      if (!kColsPeriodic) {
        if (edge_l) left = ghost_value(p.col_lo, c, right);
        else if (edge_r) right = ghost_value(p.col_hi, c, left);
      }
      const T dr = (down - up) * hx;
      const T dc = (right - left) * hy;
      if constexpr (kOp == kGradientSquared) {
        acc[0][i] = dr * dr + dc * dc;
      } else if constexpr (kOp == kGradient) {
        acc[0][i] = dr;
        acc[1][i] = dc;
      } else if constexpr (kOp == kDivergence) {
        if (f == 0) acc[0][i] = dr;
        else acc[0][i] = acc[0][i] + dc;
      } else if constexpr (kOp == kVectorLaplace) {
        acc[f][i] = isotropic ? (up + down + left + right - T(4) * c) * sx
                              : (up + down - T(2) * c) * sx + (left + right - T(2) * c) * sy;
      } else if constexpr (kOp == kVectorGradient) {
        acc[2 * f][i] = dr;
        acc[2 * f + 1][i] = dc;
      } else {  // tensor divergence: out[i] = d_x t_i0 + d_y t_i1, t row-major
        if (f % 2 == 0) acc[f / 2][i] = dr;
        else acc[f / 2][i] = acc[f / 2][i] + dc;
      }
    }
  }

#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    T* out = static_cast<T*>(p.out[o]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) out[static_cast<size_t>(row0 + i) * n_cols + col] = acc[o][i];
    }
  }
}

template <int kOp, typename T, bool kRowsPeriodic, bool kColsPeriodic>
cudaError_t launch_op(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.n_cols + kBlockX - 1) / kBlockX,
                  (p.n_rows + kBlockY * kRows - 1) / (kBlockY * kRows));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  stencil_op_2d_kernel<kOp, T, kRowsPeriodic, kColsPeriodic>
      <<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(p);
  return cudaGetLastError();
}

template <int kOp, typename T>
int launch(const void* const* ins, void* const* outs, int n_rows, int n_cols, int rows_periodic,
           int cols_periodic, const double* scales, const double* sides, void* stream) {
  if (n_rows < 1 || n_cols < 1) return cudaErrorInvalidValue;
  Params p;
  for (int f = 0; f < kMaxPlanes; ++f) {
    p.in[f] = f < planes_in(kOp) ? ins[f] : nullptr;
    p.out[f] = f < planes_out(kOp) ? outs[f] : nullptr;
  }
  p.n_rows = n_rows;
  p.n_cols = n_cols;
  p.hx = scales[0];
  p.hy = scales[1];
  p.sx = scales[2];
  p.sy = scales[3];
  Side* side_list[4] = {&p.row_lo, &p.row_hi, &p.col_lo, &p.col_hi};
  for (int i = 0; i < 4; ++i) {
    side_list[i]->c = sides[3 * i];
    side_list[i]->f1 = sides[3 * i + 1];
    side_list[i]->f2 = sides[3 * i + 2];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_periodic && cols_periodic) return launch_op<kOp, T, true, true>(p, s);
  if (rows_periodic) return launch_op<kOp, T, true, false>(p, s);
  if (cols_periodic) return launch_op<kOp, T, false, true>(p, s);
  return launch_op<kOp, T, false, false>(p, s);
}

template <typename T>
int dispatch(int op, const void* const* ins, void* const* outs, int n_rows, int n_cols,
             int rows_periodic, int cols_periodic, const double* scales, const double* sides,
             void* stream) {
  switch (op) {
    case kGradientSquared:
      return launch<kGradientSquared, T>(ins, outs, n_rows, n_cols, rows_periodic, cols_periodic,
                                         scales, sides, stream);
    case kGradient:
      return launch<kGradient, T>(ins, outs, n_rows, n_cols, rows_periodic, cols_periodic, scales,
                                  sides, stream);
    case kDivergence:
      return launch<kDivergence, T>(ins, outs, n_rows, n_cols, rows_periodic, cols_periodic,
                                    scales, sides, stream);
    case kVectorLaplace:
      return launch<kVectorLaplace, T>(ins, outs, n_rows, n_cols, rows_periodic, cols_periodic,
                                       scales, sides, stream);
    case kVectorGradient:
      return launch<kVectorGradient, T>(ins, outs, n_rows, n_cols, rows_periodic, cols_periodic,
                                        scales, sides, stream);
    case kTensorDivergence:
      return launch<kTensorDivergence, T>(ins, outs, n_rows, n_cols, rows_periodic,
                                          cols_periodic, scales, sides, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. `op` is the operator's code (the Op enum above),
// `ins`/`outs` are host arrays of device pointers to the n_in input and n_out output planes,
// `scales` holds 4 host doubles (0.5/dx, 0.5/dy, 1/dx^2, 1/dy^2) and `sides` 12: (c, f1, f2)
// of the row-low, row-high, column-low and column-high sides. Each launches on `stream`
// without synchronising and returns the CUDA error code of the launch (0 on success).
extern "C" int stencil_op_2d_f32(int op, const void* const* ins, void* const* outs, int n_rows,
                                 int n_cols, int rows_periodic, int cols_periodic,
                                 const double* scales, const double* sides, void* stream) {
  return dispatch<float>(op, ins, outs, n_rows, n_cols, rows_periodic, cols_periodic, scales,
                         sides, stream);
}

extern "C" int stencil_op_2d_f64(int op, const void* const* ins, void* const* outs, int n_rows,
                                 int n_cols, int rows_periodic, int cols_periodic,
                                 const double* scales, const double* sides, void* stream) {
  return dispatch<double>(op, ins, outs, n_rows, n_cols, rows_periodic, cols_periodic, scales,
                          sides, stream);
}
