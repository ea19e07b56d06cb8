// The bf16 storage mode of the generated ext kernel #8 (the multi-field window
// on the halo-extended blocks of a decomposed 2D grid), designed for Hopper
// (sm_90a): the row march of march_2d.cuh with edge-free interior blocks.
//
// Replaces the bf16 planes of pde_tpu's `make_fused_multi_ext_window_2d`
// (pde_tpu/ops/pallas_cartesian.py:4081, bf16 gate :4121-4127,
// pde_tpu/parallel/fused.py:443): k explicit steps of a generated rhs over n
// bf16 planes, each field's every level rounded to bf16 by the program's last
// stage, the march in float registers and float shared rows.
//
// What bounds it on this card. Device memory is 4 bytes a cell a pass (a bf16
// read and write) and is far from the limit; the instructions a cell-step
// are (PERF.md, row 8). The ext kernels of march_2d.cuh pay for a block's
// edges in every cell of every block: the domain test of each stage, the
// flag-selected ghost of each stencil read, and, with side inputs, the
// tables' pointers rebuilt each stage row. Yet on the plan of 2048^2 blocks
// only the first strip and chunk at each flagged side meet it.
//
// Design: edge-free interior blocks. Each block decides, once and
// block-uniformly (ext_window_interior), whether its window (the strip and
// chunk plus H = K * kDepth cells on each side) lies wholly in the buffer and
// meets no flagged side: then every cell it loads or computes is in the domain
// and carries no edge flag. Such a block marches with the flags the stage
// functions see fixed at zero, so every ghost select folds away at compile
// time; it has no domain test, no load mask and no side-table pointer (no
// interior cell reads a side). The other blocks run march_2d.cuh's RowMarch.
// Both call the same generated stage functions, which compute a cell's value
// by the same operations in the same order, so a result does not depend on
// which blocks are interior (the plan). One launch: the branch is taken once
// a block, so the launch counts stay. The variants this design was chosen
// over (each thread's column in registers, two columns a thread, edge marches
// that take the interior stage call in plain warps or rows) and their times
// are in PERF.md (scripts/torch_bf16_ext_sweep.py).

#pragma once

#include <cuda_bf16.h>

#include "march_2d.cuh"

namespace pde_tpu_torch {

// Whether the window of one ext block, `rows` window rows from local row
// geo.r0 and `wx` window columns from local column geo.c0, lies wholly in the
// buffer (local cells [-h, n + h) of each axis) and meets no flagged side: no
// cell of it lies beyond a flagged side or on the row or column next to it
// (where the ghosts are substituted). Then every window cell is loaded, in
// the domain and without an edge flag.
template <bool RP, bool CP>
__device__ __forceinline__ bool ext_window_interior(const ExtRows<RP, CP>& g, int rows, int wx) {
  const int r_lo = g.r0, r_hi = g.r0 + rows - 1, c_lo = g.c0, c_hi = g.c0 + wx - 1;
  bool ok = r_lo >= -g.h && r_hi < g.n_rows + g.h && c_lo >= -g.h && c_hi < g.n_cols + g.h;
  if (!RP) ok = ok && (!g.e[0] || r_lo >= 1) && (!g.e[1] || r_hi <= g.n_rows - 2);
  if (!CP) ok = ok && (!g.e[2] || c_lo >= 1) && (!g.e[3] || c_hi <= g.n_cols - 2);
  return ok;
}

// One interior block's march: RowMarch's schedule, loads and stores on a
// window whose every cell is in the buffer and the domain and carries no edge
// flag, so the stage functions see zero flags and no side table.
template <class P, typename T, int K, int TX, int NT, class Geo, typename ST>
struct InteriorRowMarch {
  using S = RowShape<P, T, K, TX, NT>;
  static constexpr int NF = P::kFields, NV = P::kVolumes, D = P::kDepth, H = K * D;
  static constexpr int NS = SideInputCount<P>::value;
  static constexpr int M = S::kCols, WX = S::kWX;
  static_assert(RowValueCount<P>::value == 0, "the ext kernels take no values of a row");

  Geo& geo;
  const ST* const (&in)[NF];
  ST* const (&out)[NF];
  T* const smem;
  const int tid;
  int off[M];
  unsigned flags[M];

  __device__ __forceinline__ InteriorRowMarch(Geo& geo_, const ST* const (&in_)[NF],
                                              ST* const (&out_)[NF], T* smem_)
      : geo(geo_), in(in_), out(out_), smem(smem_), tid(threadIdx.x) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = tid + m * NT;
      off[m] = 0;
      flags[m] = 0u;
      if (q < WX) {
        const int depth = min(q, WX - 1 - q);
        const RowColumn c = geo.column(q, depth >= H);
        off[m] = c.off;
        flags[m] = c.flags | (unsigned(depth + 1) << kDepthShift);
      }
    }
  }

  __device__ __forceinline__ T* slot(int s, int v, int r) const {
    const int n = P::volume_slots(v);
    return smem + (s * P::kStepSlots + P::volume_base(v) + (r % n + n) % n) * WX;
  }

  __device__ __forceinline__ void load_row(T (&v)[NF][M]) {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        v[f][m] = T(0);
        if (flags[m] >> kDepthShift) v[f][m] = in[f][pl.off + off[m]];
      }
    }
  }

  template <int R, int SX, int J>
  __device__ __forceinline__ void stage(int t) {
    constexpr int lag = SX * D + P::stage_lag(J);
    constexpr bool output = J + 1 == P::kStages;
    constexpr int first = P::stage_out(J), width = P::stage_width(J);
    constexpr int wr = R - lag;
    if (t < 2 * lag) return;
    const MarchRow pl = geo.row(t - lag);
    RowOperands<T, NV, 0, NS> ops;
    if constexpr (NS > 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) ops.sp[i] = nullptr;  // no interior cell reads a side
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ops.lo[v] = slot(SX, v, wr - 1);
      ops.c[v] = slot(SX, v, wr);
      ops.hi[v] = slot(SX, v, wr + 1);
    }
    constexpr int step = output ? SX + 1 : SX;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const unsigned f = flags[m];
      const int q = tid + m * NT;
      if ((f >> kDepthShift) <= unsigned(lag)) continue;
      T val[width];
      P::template stage<J>(ops, q, 0u, 0u, val);  // no flag: every ghost select folds away
      if constexpr (output && SX + 1 == K) {
        if (f & kOut) {
#pragma unroll
          for (int i = 0; i < width; ++i) out[i][pl.off + off[m]] = val[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < width; ++i) slot(step, first + i, wr)[q] = val[i];
      }
    }
  }

  template <int R, int I>
  __device__ __forceinline__ void stages(int t) {
    if constexpr (I < K * P::kStages) {
      stage<R, I / P::kStages, I % P::kStages>(t);
      stages<R, I + 1>(t);
    }
  }

  template <int R>
  __device__ __forceinline__ void advance(int t, const T (&v0)[NF][M]) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T* dst = slot(0, f, R);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (flags[m] >> kDepthShift) dst[tid + m * NT] = v0[f][m];
      }
    }
    stages<R, 0>(t);
    __syncthreads();
  }

  template <int U>
  __device__ __forceinline__ void iterate(int t0, int rows, T (&next)[NF][M]) {
    if constexpr (U < S::period()) {
      const int t = t0 + U;
      if (t >= rows) return;
      T v0[NF][M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int f = 0; f < NF; ++f) v0[f][m] = next[f][m];
      }
      if (t + 1 < rows) load_row(next);
      advance<U>(t, v0);
      iterate<U + 1>(t0, rows, next);
    }
  }

  __device__ __forceinline__ void run(int rows) {
    T next[NF][M];
    load_row(next);
    for (int t0 = 0; t0 < rows; t0 += S::period()) iterate<0>(t0, rows, next);
  }
};

// One block of a bf16 ext pass: the interior march where its window allows,
// else RowMarch.
template <class P, typename T, int K, int TX, int NT, typename ST, class Geo>
__device__ __forceinline__ void bf16_ext_march(Geo& geo, const ST* const (&in)[P::kFields],
                                               ST* const (&out)[P::kFields], int rows,
                                               SideTable<T, SideInputCount<P>::value> sides) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  if (ext_window_interior(geo, rows, RowShape<P, T, K, TX, NT>::kWX)) {
    InteriorRowMarch<P, T, K, TX, NT, Geo, ST> march(geo, in, out, smem);
    march.run(rows);
  } else {
    RowMarch<P, T, K, TX, NT, Geo, ST> march(geo, in, out, smem, {}, sides);
    march.run(rows);
  }
}

template <class P, typename T, int K, int TX, int NT, typename ST>
__global__ void __launch_bounds__(NT)
    multi_stencil_bf16_ext_2d_kernel(ExtRowPtrs<ST, P::kFields> io, int n_rows, int n_cols,
                                     int halo, int ld, int chunk) {
  constexpr int H = K * P::kDepth;
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;
  const int c0 = blockIdx.x * TX;
  ExtRows<P::kRowsPeriodic, P::kColsPeriodic> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - H;
  geo.c0 = c0 - H;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - H;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const ST* in[P::kFields];
  ST* out[P::kFields];
#pragma unroll
  for (int f = 0; f < P::kFields; ++f) {
    in[f] = io.in[z][f];
    out[f] = io.out[z][f];
  }
  bf16_ext_march<P, T, K, TX, NT, ST>(geo, in, out, min(chunk, n_rows - r0) + 2 * H, {});
}

template <class P, typename T, int K, int TX, int NT, typename ST>
__global__ void __launch_bounds__(NT)
    multi_stencil_bf16_sides_ext_2d_kernel(ExtSidePtrs<T, P::kFields, P::kSideInputs, ST> io,
                                           int n_rows, int n_cols, int halo, int ld, int chunk) {
  constexpr int H = K * P::kDepth;
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;
  const int c0 = blockIdx.x * TX;
  ExtSideRows<P::kRowsPeriodic, P::kColsPeriodic> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - H;
  geo.c0 = c0 - H;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - H;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  geo.row0 = io.origin[z][0];
  geo.col0 = io.origin[z][1];
  const ST* in[P::kFields];
  ST* out[P::kFields];
#pragma unroll
  for (int f = 0; f < P::kFields; ++f) {
    in[f] = io.in[z][f];
    out[f] = io.out[z][f];
  }
  bf16_ext_march<P, T, K, TX, NT, ST>(geo, in, out, min(chunk, n_rows - r0) + 2 * H, io.sides);
}

// Launches one K-step bf16 ext pass, as launch_ext_2d.
template <class P, typename T, int K, int TX, int NT, typename ST>
int launch_bf16_ext_2d(const void* const* ins, void* const* outs, const int* edges, int n_blocks,
                       int n_rows, int n_cols, int halo, int ld, int chunk, void* stream) {
  constexpr int NF = P::kFields;
  if (n_blocks < 1 || n_blocks > kMaxExtBlocks || halo < K * P::kDepth || n_rows < halo ||
      n_cols < halo || ld < n_cols + 2 * halo || chunk < 1)
    return cudaErrorInvalidValue;
  const int strips = (n_cols + TX - 1) / TX;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  ExtRowPtrs<ST, NF> io;
  for (int z = 0; z < n_blocks; ++z) {
    for (int f = 0; f < NF; ++f) {
      io.in[z][f] = static_cast<const ST*>(ins[z * NF + f]);
      io.out[z][f] = static_cast<ST*>(outs[z * NF + f]);
    }
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[4 * z + e];
  }
  constexpr size_t smem = RowShape<P, T, K, TX, NT>::kSmem;
  auto kernel = multi_stencil_bf16_ext_2d_kernel<P, T, K, TX, NT, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks, n_blocks), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, n_rows, n_cols, halo, ld, chunk);
  return cudaGetLastError();
}

// Launches one K-step bf16 ext pass of a program with side inputs, as
// launch_ext_sides_2d.
template <class P, typename T, int K, int TX, int NT, typename ST>
int launch_bf16_ext_sides_2d(const void* const* ins, void* const* outs, const int* edges,
                             int n_blocks, int n_rows, int n_cols, int halo, int ld, int chunk,
                             const void* const* sides, const long long* steps, void* stream) {
  constexpr int NF = P::kFields, NS = P::kSideInputs;
  if (n_blocks < 1 || n_blocks > kMaxExtBlocks || halo < K * P::kDepth || n_rows < halo ||
      n_cols < halo || ld < n_cols + 2 * halo || chunk < 1 || sides == nullptr ||
      steps == nullptr || K * P::kDepth > P::kSidePad)
    return cudaErrorInvalidValue;
  const int strips = (n_cols + TX - 1) / TX;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  ExtSidePtrs<T, NF, NS, ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    for (int f = 0; f < NF; ++f) {
      io.in[z][f] = static_cast<const ST*>(ins[z * NF + f]);
      io.out[z][f] = static_cast<ST*>(outs[z * NF + f]);
    }
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[6 * z + e];
    io.origin[z][0] = edges[6 * z + 4];
    io.origin[z][1] = edges[6 * z + 5];
  }
  for (int i = 0; i < NS; ++i) {
    io.sides.p[i] = static_cast<const T*>(sides[i]);
    io.sides.step[i] = steps[i];
    if (io.sides.p[i] == nullptr || (P::side_step(i) >= 0 && steps[i] != P::side_step(i))) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = RowShape<P, T, K, TX, NT>::kSmem;
  auto kernel = multi_stencil_bf16_sides_ext_2d_kernel<P, T, K, TX, NT, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks, n_blocks), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, n_rows, n_cols, halo, ld, chunk);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
