// The square window of the Euler-Maruyama kernels, for Hopper (sm_90a):
// k explicit steps of a traced one-field rhs plus a noise policy per pass over
// device memory. Hand-written template; the per-rhs part (a Program struct
// with one `level` function) is generated by pde_tpu_torch/ops/cuda_sde_2d.py
// through pde_tpu_torch/ops/cuda_stencil_2d.py (`emit_program`).
//
// What the generated program supplies, as a struct P:
//   P::kFields (1), P::kBuffers, P::kDepth      field planes, operand buffers,
//                                               halo cells consumed per step;
//   P::kRowsPeriodic, P::kColsPeriodic          the grid's periodicity;
//   P::kSideInputs, P::kSidePad, P::side_axis(i), P::side_step(i)  only in a
//                       program whose ghosts read side inputs (B2(b)): as in
//                       csrc/march_2d.cuh, each input a device table of the
//                       data's dtype, a row side's values along the columns
//                       (side_axis 1), a column side's along the rows (2), or
//                       one value (0), a step's row side_step(i) elements
//                       after the last's (the host's stride where it is -1);
//                       the tables along a side are padded by kSidePad cells
//                       before the grid (wrapped on a periodic axis);
//   template <class T> static void P::level(const Level<T, ...>& L, int h)
//     one Euler step on the current field buffers, valid on the window region
//     of halo h: it fills the operand buffers (each stencil operator's operand
//     that is not a bare field, over the region it is needed on, with
//     __syncthreads() between groups) and writes the next level of every field
//     over halo h - kDepth into L.nxt. Stencil reads substitute the affine
//     ghost value (c + f1*edge + f2*next_inward) of the operand itself where
//     the cell sits on a non-periodic global edge; a side input's term reads
//     L.sp[i] at the cell's global column (row side), row (column side) or
//     at 0 (a value per step).
//
// Design. Each block owns a TILE x TILE output tile and loads a
// (TILE + 2*K*kDepth)^2 window of the field, with halos on all four sides.
// Periodic halos wrap by index (more than once on small grids), cells outside
// a non-periodic domain are held at zero, and the window shrinks by kDepth
// cells per side per step. Every buffer shares the window's layout, so one
// index addresses all planes. The field planes are ping-ponged; the input is
// never written. K and TILE are chosen on the host from a shared-memory budget
// per (buffers, dtype), so that two blocks fit on one SM. (The multi-field
// kernels #7 and #8 march down the rows instead: csrc/march_2d.cuh.)

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pde_tpu_torch {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// The side inputs of a program at the step being computed (none in most
// programs): each input's row, from the entry of global cell 0 (or the value).
template <typename T, int NS>
struct LevelSides {
  const T* sp[NS];
};
template <typename T>
struct LevelSides<T, 0> {};

// The device tables of a program's side inputs: each input's first row for
// the pass and its stride from one step's row to the next.
template <typename T, int NS>
struct WindowSideTable {
  const T* p[NS];
  long long step[NS];
};
template <typename T>
struct WindowSideTable<T, 0> {};

// The field and operand planes of one level, in shared memory, and the
// step's side inputs where the program has any.
template <typename T, int NF, int NB, int NS = 0>
struct Level : LevelSides<T, NS> {
  T* cur[NF];
  T* nxt[NF];
  T* buf[NB > 0 ? NB : 1];
  int w;       // side of the window (all planes share its layout)
  int h0;      // halo of the window on the first level
  int tile;    // side of the output tile
  int gr0;     // global row of window row 0
  int gc0;     // global column of window column 0
  int n_rows;  // grid shape
  int n_cols;
};

__device__ __forceinline__ int wrap_index(int i, int n) { return ((i % n) + n) % n; }

// Calls body(idx, gr, gc, inside) for every cell of the window region with
// halo h: window index, global row and column, and whether it lies in the domain.
template <bool RP, bool CP, typename L, class F>
__device__ __forceinline__ void for_each_cell(const L& lv, int h, F&& body) {
  const int lo = lv.h0 - h, hi = lv.h0 + lv.tile + h;
  for (int i = lo + static_cast<int>(threadIdx.y); i < hi; i += kBlockY) {
    const int gr = lv.gr0 + i;
    const bool row_in = RP || (gr >= 0 && gr < lv.n_rows);
    for (int j = lo + static_cast<int>(threadIdx.x); j < hi; j += kBlockX) {
      const int gc = lv.gc0 + j;
      const bool col_in = CP || (gc >= 0 && gc < lv.n_cols);
      body(i * lv.w + j, gr, gc, row_in && col_in);
    }
  }
}

// -- the Euler-Maruyama window ------------------------------------------------------
//
// Replaces the TPU kernels `make_fused_sde_stencil_window_2d` (policy
// StagedNoise below) and `make_fused_sde_kernel_noise_window_2d` (PhiloxNoise in
// philox.cuh): the square window for one field, with step s's increment added
// after level s to every cell of that level's valid region that lies in the
// domain, halo cells included. (r, c) is the global cell the window cell stands
// for, wrapped on periodic axes, so a halo cell gets the increment its owner
// tile gives it; cells outside a non-periodic domain get none and stay zero.
// An increment is a pure function of (step, r, c): the staged plane's cell, or
// Philox's counter (step0 + s, r, c, 0).
//
// Design for this card (each choice measured by scripts/torch_sde_sweep.py).
// - Index tables. At block start the wrapped global row and column of every
//   window index are written to two int tables of W entries in shared memory,
//   with the full double wrap (a halo may wrap more than once on small grids).
//   The window load and every level's noise read them, so no integer remainder
//   runs inside the step loop and the integer pipe is left to Philox.
//   Non-periodic axes test the domain and take no table.
// - Staged increments are read from device memory where they are added
//   (add_staged_direct), in the level's cell-to-thread mapping (so no barrier),
//   ROWS (2) of a thread's rows at a time with all their loads issued before
//   the first add: a level then exposes one load latency per two rows, not one
//   per row. More rows in flight cost registers and ran slower; copying the
//   increments into shared memory a step ahead with cp.async ran slower too,
//   since its buffers halve the blocks per SM.
// - Increments drawn in the kernel are dealt to the threads in row-major order
//   over the level's region (for_each_noisy_cell_linear), UNROLL (2) cells per
//   loop trip, so that every lane draws: the level's 2D mapping leaves up to
//   a third of the lanes of a region's last column chunk idle. One barrier per
//   step separates the two mappings; it costs less than the idle lanes did.
//   Tiles of 96 and 128 (fewer halo draws, fewer blocks per SM) ran slower.
//
// What bounds it on this card: staged, the bytes (input, K increment planes,
// output; halo cells re-read through L2); in the kernel, Philox's integer
// operations on the cells of every level, halo included.

// Pre-scaled increments staged in device memory: plane s holds step s's.
template <typename T>
struct StagedNoise {
  static constexpr bool kStaged = true;
  const T* __restrict__ planes;  // (K, n_rows, n_cols), contiguous
  size_t plane;                  // n_rows * n_cols

  __device__ __forceinline__ const T* cell(int s, int r, int c, int n_cols) const {
    return planes + s * plane + static_cast<size_t>(r) * n_cols + c;
  }
};

// Adds step s's staged increments to `nxt` over the region of halo h, in
// for_each_cell's cell-to-thread mapping, ROWS of the thread's rows at a time.
template <bool RP, bool CP, int W, int ROWS, typename L, typename T>
__device__ __forceinline__ void add_staged_direct(const L& lv, const StagedNoise<T>& noise,
                                                  const int* row_of, const int* col_of, int s,
                                                  int h, T* nxt) {
  constexpr int Q = (W + kBlockX - 1) / kBlockX;
  const int lo = lv.h0 - h, hi = lv.h0 + lv.tile + h;
  const int j0 = lo + static_cast<int>(threadIdx.x);
  int col[Q];
  bool col_in[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = j0 + q * kBlockX;
    if constexpr (CP) {
      col_in[q] = j < hi;
      col[q] = col_in[q] ? col_of[j] : 0;
    } else {
      col[q] = lv.gc0 + j;
      col_in[q] = j < hi && col[q] >= 0 && col[q] < lv.n_cols;
    }
  }
#pragma unroll 1
  for (int i1 = lo + static_cast<int>(threadIdx.y); i1 < hi; i1 += ROWS * kBlockY) {
    bool row_in[ROWS];
    T v[ROWS][Q];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int i = i1 + a * kBlockY;
      int r = 0;
      row_in[a] = i < hi;
      if (row_in[a]) {
        if constexpr (RP) {
          r = row_of[i];
        } else {
          r = lv.gr0 + i;
          row_in[a] = r >= 0 && r < lv.n_rows;
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[a][q] = row_in[a] && col_in[q] ? __ldg(noise.cell(s, r, col[q], lv.n_cols)) : T(0);
      }
    }
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (row_in[a] && col_in[q]) {
          const int idx = (i1 + a * kBlockY) * W + j0 + q * kBlockX;
          nxt[idx] = nxt[idx] + v[a][q];
        }
      }
    }
  }
}

// Calls body(idx, r, c) for every cell of the window region with halo h that
// lies in the domain (its window index and the global row and column it stands
// for), the region's cells dealt to the block's threads in row-major order.
// UNROLL cells per loop trip.
template <bool RP, bool CP, int W, int UNROLL, typename L, class F>
__device__ __forceinline__ void for_each_noisy_cell_linear(const L& lv, const int* row_of,
                                                           const int* col_of, int h, F&& body) {
  constexpr int kThreads = kBlockX * kBlockY;
  const int lo = lv.h0 - h;
  const int side = lv.tile + 2 * h;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int di = kThreads / side, dj = kThreads % side;
  int i = tid / side, j = tid % side;
#pragma unroll (UNROLL)
  for (int n = tid; n < side * side; n += kThreads) {
    int r, c;
    if constexpr (RP) {
      r = row_of[lo + i];
    } else {
      r = lv.gr0 + lo + i;
    }
    if constexpr (CP) {
      c = col_of[lo + j];
    } else {
      c = lv.gc0 + lo + j;
    }
    if ((RP || (r >= 0 && r < lv.n_rows)) && (CP || (c >= 0 && c < lv.n_cols))) {
      body((lo + i) * W + lo + j, r, c);
    }
    i += di;
    j += dj;
    if (j >= side) {
      j -= side;
      ++i;
    }
  }
}

// One K-step pass of a tile (the body of both kernels below). ROWS (staged
// loads in flight per thread, in rows) and UNROLL (drawn cells per loop trip)
// are template parameters so that the sweep can instantiate other choices; the
// defaults are the ones it found fastest. NS is the program's side inputs
// (0: none), whose rows the level of step s reads at step s of the pass.
template <class P, typename T, int K, int TILE, class N, int ROWS, int UNROLL, int NS>
__device__ __forceinline__ void sde_window_2d(const T* __restrict__ in, T* __restrict__ out,
                                              int n_rows, int n_cols, const N& noise,
                                              const WindowSideTable<T, NS>& sides) {
  static_assert(P::kFields == 1, "noise windows advance one field");
  constexpr bool RP = P::kRowsPeriodic;
  constexpr bool CP = P::kColsPeriodic;
  constexpr int NB = P::kBuffers;
  constexpr int D = P::kDepth;
  constexpr int H0 = K * D;
  constexpr int W = TILE + 2 * H0;
  constexpr int WW = W * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int* row_of = reinterpret_cast<int*>(smem + (2 + NB) * WW);
  int* col_of = row_of + W;

  Level<T, 1, NB, NS> lv;
  lv.cur[0] = smem;
  lv.nxt[0] = smem + WW;
#pragma unroll
  for (int b = 0; b < NB; ++b) lv.buf[b] = smem + (2 + b) * WW;
  const int row0 = blockIdx.y * TILE;  // first output row of this tile
  const int col0 = blockIdx.x * TILE;
  lv.w = W;
  lv.h0 = H0;
  lv.tile = TILE;
  lv.gr0 = row0 - H0;
  lv.gc0 = col0 - H0;
  lv.n_rows = n_rows;
  lv.n_cols = n_cols;

  // the index tables: wrapped global row and column of every window index
  for (int t = threadIdx.y * kBlockX + threadIdx.x; t < W; t += kBlockX * kBlockY) {
    if constexpr (RP) row_of[t] = wrap_index(lv.gr0 + t, n_rows);
    if constexpr (CP) col_of[t] = wrap_index(lv.gc0 + t, n_cols);
  }
  __syncthreads();

  // load the window; cells outside a non-periodic domain are zero
  for (int i = threadIdx.y; i < W; i += kBlockY) {
    const int gr = lv.gr0 + i;
    bool row_in = true;
    int r = gr;
    if constexpr (RP) {
      r = row_of[i];
    } else {
      row_in = gr >= 0 && gr < n_rows;
    }
    for (int j = threadIdx.x; j < W; j += kBlockX) {
      const int gc = lv.gc0 + j;
      bool col_in = true;
      int c = gc;
      if constexpr (CP) {
        c = col_of[j];
      } else {
        col_in = gc >= 0 && gc < n_cols;
      }
      lv.cur[0][i * W + j] = (row_in && col_in) ? in[static_cast<size_t>(r) * n_cols + c] : T(0);
    }
  }
  __syncthreads();

  for (int s = 0; s < K; ++s) {
    const int h = (K - s - 1) * D;  // halo of level s's valid region
    if constexpr (NS > 0) {  // step s's row of each input, from global cell 0's entry
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const long long step = P::side_step(i) >= 0 ? P::side_step(i) : sides.step[i];
        lv.sp[i] = sides.p[i] + s * step + (P::side_axis(i) == 0 ? 0 : P::kSidePad);
      }
    }
    P::template level<T>(lv, (K - s) * D);
    T* nxt = lv.nxt[0];
    if constexpr (N::kStaged) {
      add_staged_direct<RP, CP, W, ROWS>(lv, noise, row_of, col_of, s, h, nxt);
    } else {
      __syncthreads();  // the level wrote its cells through another mapping
      for_each_noisy_cell_linear<RP, CP, W, UNROLL>(lv, row_of, col_of, h,
                                                    [&](int idx, int r, int c) {
        nxt[idx] = nxt[idx] + noise.at(s, r, c);
      });
    }
    __syncthreads();
    T* tmp = lv.cur[0];
    lv.cur[0] = lv.nxt[0];
    lv.nxt[0] = tmp;
  }

  // write the centre tile
  for (int i = threadIdx.y; i < TILE; i += kBlockY) {
    const int gr = row0 + i;
    if (gr >= n_rows) break;
    for (int j = threadIdx.x; j < TILE; j += kBlockX) {
      const int gc = col0 + j;
      if (gc >= n_cols) break;
      out[static_cast<size_t>(gr) * n_cols + gc] = lv.cur[0][(i + H0) * W + j + H0];
    }
  }
}

template <class P, typename T, int K, int TILE, class N, int ROWS, int UNROLL>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    sde_window_2d_kernel(const T* __restrict__ in, T* __restrict__ out, int n_rows, int n_cols,
                         N noise) {
  sde_window_2d<P, T, K, TILE, N, ROWS, UNROLL, 0>(in, out, n_rows, n_cols, noise,
                                                   WindowSideTable<T, 0>{});
}

// The kernel of a program whose ghosts read side inputs (B2(b)): the same
// pass, with the input tables' pointers and strides among its parameters, an
// entry point of its own so that the kernel above keeps its registers.
template <class P, typename T, int K, int TILE, class N, int ROWS, int UNROLL>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    sde_window_sides_2d_kernel(const T* __restrict__ in, T* __restrict__ out, int n_rows,
                               int n_cols, N noise, WindowSideTable<T, P::kSideInputs> sides) {
  sde_window_2d<P, T, K, TILE, N, ROWS, UNROLL, P::kSideInputs>(in, out, n_rows, n_cols, noise,
                                                                sides);
}

// The dynamic shared memory of a K-step pass: the window's planes and its two
// index tables.
template <class P, typename T, int K, int TILE>
constexpr size_t sde_window_smem() {
  constexpr int W = TILE + 2 * K * P::kDepth;
  return static_cast<size_t>(2 + P::kBuffers) * W * W * sizeof(T) + 2 * W * sizeof(int);
}

// Launches one K-step Euler-Maruyama pass of one field on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success).
template <class P, typename T, int K, int TILE, class N, int ROWS = 2, int UNROLL = 2>
int launch_sde(const void* in, void* out, int n_rows, int n_cols, void* stream, N noise) {
  if (n_rows < 1 || n_cols < 1) return cudaErrorInvalidValue;
  constexpr size_t smem = sde_window_smem<P, T, K, TILE>();
  auto kernel = sde_window_2d_kernel<P, T, K, TILE, N, ROWS, UNROLL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_cols + TILE - 1) / TILE, (n_rows + TILE - 1) / TILE);
  const dim3 block(kBlockX, kBlockY);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n_rows, n_cols, noise);
  return cudaGetLastError();
}

// Launches one K-step pass of a program with side inputs, as launch_sde:
// `sides` holds P::kSideInputs device pointers, each input's first row for
// the pass, and `steps` each one's stride from a step's row to the next
// (P::side_step(i) where it is not -1).
template <class P, typename T, int K, int TILE, class N, int ROWS = 2, int UNROLL = 2>
int launch_sde_sides(const void* in, void* out, int n_rows, int n_cols, const void* const* sides,
                     const long long* steps, void* stream, N noise) {
  constexpr int NS = P::kSideInputs;
  if (n_rows < 1 || n_cols < 1 || sides == nullptr || steps == nullptr) {
    return cudaErrorInvalidValue;
  }
  WindowSideTable<T, NS> table;
  for (int i = 0; i < NS; ++i) {
    table.p[i] = static_cast<const T*>(sides[i]);
    table.step[i] = steps[i];
    if (table.p[i] == nullptr || (P::side_step(i) >= 0 && steps[i] != P::side_step(i))) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = sde_window_smem<P, T, K, TILE>();
  auto kernel = sde_window_sides_2d_kernel<P, T, K, TILE, N, ROWS, UNROLL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_cols + TILE - 1) / TILE, (n_rows + TILE - 1) / TILE);
  const dim3 block(kBlockX, kBlockY);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n_rows, n_cols, noise, table);
  return cudaGetLastError();
}

// The generated SDE entry points' form of launch_sde: one-element pointer
// arrays and the window's noise policy.
template <class P, typename T, int K, int TILE, class N>
int launch(const void* const* ins, void* const* outs, int n_rows, int n_cols, void* stream,
           N noise) {
  return launch_sde<P, T, K, TILE>(ins[0], outs[0], n_rows, n_cols, stream, noise);
}

// ... and of launch_sde_sides.
template <class P, typename T, int K, int TILE, class N>
int launch_sides(const void* const* ins, void* const* outs, int n_rows, int n_cols,
                 const void* const* sides, const long long* steps, void* stream, N noise) {
  return launch_sde_sides<P, T, K, TILE>(ins[0], outs[0], n_rows, n_cols, sides, steps, stream,
                                         noise);
}

}  // namespace pde_tpu_torch
