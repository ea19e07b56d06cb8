// The deep row march of both 2D affine kernels, for Hopper (sm_90a): every
// pass deeper than the register march of affine_march_2d.cuh takes in its
// mode, with k a runtime argument and every level's rows in shared memory.
// Hand-written template; its entry points, one instantiation per (dtype or
// storage type, periodicity, mode), are generated by
// pde_tpu_torch/ops/cuda_cartesian.py (emit_deep_source).
//
// Replaces the deep passes of two TPU kernels of
// pde_tpu/ops/pallas_cartesian.py, f <- (a*I + b*lap)^k f with every mode of
// the register march (affine ghosts, the radial mode's row factors, the side
// inputs, bf16 storage): `make_affine_laplace_2d` (kernel #1, on the grid; its
// geometry gate `_fused_geometry_ok` takes 1 <= k <= 32) and
// `make_affine_laplace_ext_2d` (#12, on halo-extended blocks; the port's ext
// passes go up to 16). The register march keeps each thread's column of every
// level in registers (lv[K][3][M]) and unrolls its levels, so its registers
// grow with k: past 8 steps in the radial mode, 6 with side inputs and 5 with
// both it spills (PERF.md). Here registers do not grow with k: each level
// keeps a ring of three rows in shared memory, and the levels are a runtime
// loop.
//
// What bounds it on this card. A pass reads and writes every cell once (8 B
// per fp32 cell, 4 B in bf16): at least 40 us a 4096^2 fp32 pass at 3.35
// TB/s, whatever k. Past a few steps the shared-memory traffic sets the
// pace: each cell-step reads five values of its level (the centre, the rows
// above and below it, its column neighbours) and writes one.
//
// Design: the row march of affine_march_2d.cuh with the levels in shared memory.
//   - A block of kDeepThreads threads owns an output strip of tx columns
//     (runtime; the host's affine_deep_plan) and a chunk of rows, and marches
//     down the chunk plus k rows of halo at each end; a window row holds
//     wx = tx + 2k <= kDeepThreads * kDeepCols columns, dealt linearly over
//     the threads (column q = thread + m * kDeepThreads), whose offsets and
//     flags each thread computes once.
//   - Wavefront over the k levels: iteration t brings level 0 of window row t
//     (loaded one iteration ahead into registers); then, for s = 0 .. k - 1
//     while t - s - 1 >= 0, level s + 1 of row w = t - s - 1 is computed from
//     level s of rows w - 1, w, w + 1. Level k goes to device memory.
//   - Level s of window row y lives in shared row s * 3 + y % 3. Level s of
//     row w + 1 was written in this iteration by the same thread (its own
//     column); the column neighbours of row w were written in the iteration
//     before, and the slot written in an iteration is never the one read from
//     other threads in it, so one barrier an iteration orders them, as in the
//     register march. 3k shared rows a block.
//   - Every level computes every window column of every row it reaches; a
//     value outside a level's light cone never reaches a cell the block
//     writes, so no depth or domain test is run. The rings start at zero.
//   - Ghosts are formed where they are read, in the formulas of
//     AffineRowMarch::ghost, and the update is the register march's
//     (affine_update_2d, affine_radial_update_2d and, where it rounds each
//     product and sum, affine_radial_update_rn_2d), so that a deep pass takes
//     the register passes' operations in their order.
//   - The radial mode reads its factors from a copy of the window rows' slice
//     of the radial table in shared memory, loaded once a block and read at
//     one address by every thread.
//   - The side tables and the radial table have kDeepPad rows (an ext row
//     side's table columns) before the grid and after it, which covers the
//     k <= 32 rows a pass reads past the grid; the register march, compiled
//     with kSidePad = 16, gets the same tables from their row 16 on.
// The decomposed pass (the ext kernel) marches the blocks of a decomposed
// grid from their extended buffers (ExtRows), reading the global grid's tables
// at the block's origin; it calls the same march, so a decomposed run equals
// the serial one bit for bit.

#pragma once

#include "affine_march_2d.cuh"

namespace pde_tpu_torch {

constexpr int kDeepMaxSteps = 32;  // pde_tpu's 4 * _HALO
constexpr int kDeepPad = 32;       // SIDE_PAD and RADIAL_PAD of ops/cuda_cartesian.py
constexpr int kDeepSlots = 3;      // shared rows a level
constexpr int kDeepThreads = 256;  // threads a block
constexpr int kDeepCols = 2;       // window columns a thread, at most

// The side inputs of a deep pass: AffineSides with a t-table of up to
// kDeepMaxSteps steps.
template <typename T>
struct DeepSides {
  const T* arr[4];
  T tt[kDeepMaxSteps][4];
};

// Shared-memory bytes of a block: the rings (k levels of kDeepSlots rows of
// wx cells and a pad cell on each side), then in the radial mode the factors
// of `rows` window rows, then with side inputs the t-table (affine_deep_smem
// of ops/cuda_cartesian.py).
template <typename T>
__host__ __device__ constexpr size_t deep_ring_bytes(int k, int tx) {
  return (size_t(k) * kDeepSlots * (tx + 2 * k + 2) * sizeof(T) + 15) / 16 * 16;
}
template <typename T, bool RADIAL>
__host__ __device__ constexpr size_t deep_table_offset(int k, int tx, int rows) {
  return deep_ring_bytes<T>(k, tx) + (RADIAL ? size_t(rows) * sizeof(RadialRow<T>) : 0);
}
template <typename T, bool RADIAL, bool SIDES>
size_t deep_smem_bytes(int k, int tx, int rows) {
  return deep_table_offset<T, RADIAL>(k, tx, rows) + (SIDES ? 4 * kDeepMaxSteps * sizeof(T) : 0);
}

// One block's deep march on the window geometry `geo` (GridRows or ExtRows):
// `rows` window rows, window row w's radial factors at rad.rows[rad_base + w],
// a column side's const at arr[side_base + w] and a row side's of window
// column m at arr[off[m] + col_shift]. `in` and `out` hold the storage type
// ST (T, or __nv_bfloat16 with T = float: each level rounded to it).
template <int MODE, typename T, bool RP, bool CP, bool SIDES, class Geo, typename ST>
struct AffineDeepMarch {
  static constexpr int NT = kDeepThreads, MC = kDeepCols;
  // the radial update and ghosts with each product and sum rounded, as the
  // register march rounds them (AffineRowMarch::kRoundEach)
  static constexpr bool kRoundEach = MODE == kRadial && (SIDES || !std::is_same_v<ST, T>);

  Geo& geo;
  const AffineRowStep<T>& st;
  const ST* __restrict__ in;
  ST* __restrict__ out;
  T* const ring;
  RadialRow<T>* const fac;  // the window rows' factors (radial mode)
  T* const ttab;            // the pass's t-table, step s's four values from ttab[4 s] (side inputs)
  const AffineRadial<T> rad;
  const DeepSides<T>* const sides;
  const int tid, k, wx, rw, rows, edge_lo, edge_hi, rad_base, side_base, col_shift;
  int off[MC];
  unsigned flags[MC];

  __device__ __forceinline__ AffineDeepMarch(Geo& geo_, const AffineRowStep<T>& st_,
                                             const ST* in_, ST* out_, unsigned char* smem, int k_,
                                             int tx, int rows_, int edge_lo_, int edge_hi_,
                                             AffineRadial<T> rad_, int rad_base_,
                                             const DeepSides<T>* sides_, int side_base_,
                                             int col_shift_)
      : geo(geo_), st(st_), in(in_), out(out_), ring(reinterpret_cast<T*>(smem)),
        fac(reinterpret_cast<RadialRow<T>*>(smem + deep_ring_bytes<T>(k_, tx))),
        ttab(reinterpret_cast<T*>(smem + deep_table_offset<T, MODE == kRadial>(k_, tx, rows_))),
        rad(rad_), sides(sides_), tid(threadIdx.x), k(k_), wx(tx + 2 * k_), rw(tx + 2 * k_ + 2),
        rows(rows_), edge_lo(edge_lo_), edge_hi(edge_hi_), rad_base(rad_base_),
        side_base(side_base_), col_shift(col_shift_) {
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      const int q = tid + m * NT;
      off[m] = 0;
      flags[m] = 0u;
      if (q < wx) {
        const RowColumn c = geo.column(q, q >= k && q < wx - k);
        off[m] = c.off;
        flags[m] = c.flags;
      }
    }
  }

  // the ghost of side I (row-low, row-high, column-low, column-high) at step
  // s beside window column m of window row w: AffineRowMarch::ghost's formulas
  template <int I>
  __device__ __forceinline__ T ghost(int s, int m, int w, T edge, T inward) const {
    if constexpr (SIDES) {
      T c = st.side[I][0];
      const T* arr = sides->arr[I];
      if (arr != nullptr) c = I < 2 ? arr[off[m] + col_shift] : arr[side_base + w];
      c = c + ttab[4 * s + I];
      if constexpr (MODE == kRadial) {
        T g = add_rn(c, mul_rn(st.side[I][1], edge));
        if (st.side[I][2] != T(0)) g = add_rn(g, mul_rn(st.side[I][2], inward));
        return g;
      } else {
        T g = c + st.side[I][1] * edge;
        if (st.side[I][2] != T(0)) g = g + st.side[I][2] * inward;
        return g;
      }
    } else if constexpr (kRoundEach) {
      T g = add_rn(st.side[I][0], mul_rn(st.side[I][1], edge));
      if (st.side[I][2] != T(0)) g = add_rn(g, mul_rn(st.side[I][2], inward));
      return g;
    } else {
      return side_ghost(st.side[I], edge, inward);
    }
  }

  // level 0 of the next window row, into registers
  __device__ __forceinline__ void load_row(T (&v)[MC]) {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      v[m] = T(0);
      if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[m] = load_as<T>(in[pl.off + off[m]]);
    }
  }

  // level s + 1 of window row w from level s's rows at ring offsets `c` (w)
  // and `u` (w - 1), and `below`, the thread's columns of its row w + 1 (the
  // values the level below has just written): below k (`keep`) into level
  // s + 1's row w at ring offset `n` and into `below` for the level above, at
  // level k into the output row (`store`). Offsets are ints into the shared
  // ring, so no generic pointer is formed.
  __device__ __forceinline__ void level(int s, int w, int c, int u, int n, bool keep,
                                        T (&below)[MC], bool store, long long out_row) const {
    RadialRow<T> factors{T(0), T(0)};
    if constexpr (MODE == kRadial) factors = fac[w];
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      const int q = tid + m * NT;
      if (q >= wx) continue;
      const T center = ring[c + q];
      T up = ring[u + q], down = below[m];
      T left = ring[c + q - 1], right = ring[c + q + 1];  // the column neighbours
      if constexpr (!RP) {
        if (w == edge_lo) up = ghost<0>(s, m, w, center, down);
        if (w == edge_hi) down = ghost<1>(s, m, w, center, up);
      }
      if constexpr (!CP) {
        if (flags[m] & kLowEdge) left = ghost<2>(s, m, w, center, right);
        if (flags[m] & kHighEdge) right = ghost<3>(s, m, w, center, left);
      }
      T x;
      if constexpr (kRoundEach) {
        x = affine_radial_update_rn_2d(rad, factors, center, up, down, left, right);
      } else if constexpr (MODE == kRadial) {
        x = affine_radial_update_2d(rad, factors, center, up, down, left, right);
      } else {
        x = affine_update_2d<MODE == kIsotropic>(st, center, up, down, left, right);
      }
      if (keep) {
        x = round_to<ST>(x);  // the level in ST's values
        ring[n + q] = x;
        below[m] = x;
      } else if (store && (flags[m] & kOut)) {
        out[out_row + off[m]] = store_as<ST>(x);
      }
    }
  }

  __device__ __forceinline__ void run() {
    const int ring_cells = k * kDeepSlots * rw;
    for (int i = tid; i < ring_cells; i += NT) ring[i] = T(0);
    if constexpr (MODE == kRadial) {
      for (int w = tid; w < rows; w += NT) fac[w] = rad.rows[rad_base + w];
    }
    if constexpr (SIDES) {  // the t-table, each entry at a constant offset of the parameter
#pragma unroll
      for (int s = 0; s < kDeepMaxSteps; ++s) {
        if (tid == s) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ttab[4 * s + i] = sides->tt[s][i];
        }
      }
    }
    T next[MC];
    load_row(next);
    __syncthreads();
    const int level_cells = kDeepSlots * rw;  // a level's rows in the ring
    for (int t = 0; t < rows; ++t) {
      const int dst = (t % kDeepSlots) * rw + 1;  // level 0 of row t
      T below[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        const int q = tid + m * NT;
        below[m] = next[m];
        if (q < wx) ring[dst + q] = next[m];
      }
      if (t + 1 < rows) load_row(next);
      const long long out_row = geo.row(t - k).off;  // meaningful once t >= 2k
      const bool store = t >= 2 * k;
      const int levels = min(t, k);
      int jc = (t + kDeepSlots - 1) % kDeepSlots;  // the slot of row w = t - s - 1 at s = 0
      int lv = 1;                                  // level s's first row, past its pad cell
      for (int s = 0; s < levels; ++s) {
        const int ju = jc == 0 ? kDeepSlots - 1 : jc - 1;
        const int above = lv + level_cells;  // level s + 1's
        level(s, t - s - 1, lv + jc * rw, lv + ju * rw, above + jc * rw, s + 1 < k, below, store,
              out_row);
        jc = ju;  // level s + 1's centre row is one row up
        lv = above;
      }
      __syncthreads();
    }
  }
};

// One block's march in the mode of the kernel: radial, or the isotropic or
// anisotropic 5-point update as st.isotropic decides once a block.
template <bool RADIAL, typename T, bool RP, bool CP, bool SIDES, class Geo, typename ST>
__device__ __forceinline__ void affine_deep_march(Geo& geo, const AffineRowStep<T>& st,
                                                  const ST* in, ST* out, int k, int tx, int rows,
                                                  int edge_lo, int edge_hi,
                                                  const AffineRadial<T>& rad, int rad_base,
                                                  const DeepSides<T>* sides, int side_base,
                                                  int col_shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (RADIAL) {
    AffineDeepMarch<kRadial, T, RP, CP, SIDES, Geo, ST> march(
        geo, st, in, out, smem_raw, k, tx, rows, edge_lo, edge_hi, rad, rad_base, sides,
        side_base, col_shift);
    march.run();
  } else if (st.isotropic) {
    AffineDeepMarch<kIsotropic, T, RP, CP, SIDES, Geo, ST> march(
        geo, st, in, out, smem_raw, k, tx, rows, edge_lo, edge_hi, rad, rad_base, sides,
        side_base, col_shift);
    march.run();
  } else {
    AffineDeepMarch<kAnisotropic, T, RP, CP, SIDES, Geo, ST> march(
        geo, st, in, out, smem_raw, k, tx, rows, edge_lo, edge_hi, rad, rad_base, sides,
        side_base, col_shift);
    march.run();
  }
}

// Kernel #1's deep passes: window row w of a block is grid row r0 - k + w,
// its factors at rad.rows[r0 - k + kDeepPad + w], a column side's const at
// arr[r0 - k + kDeepPad + w]; a row side's at the column's grid column.
template <typename T, bool RADIAL, bool SIDES, bool RP, bool CP, typename ST>
__global__ void __launch_bounds__(kDeepThreads, 1)
    affine_laplace_deep_2d_kernel(const ST* __restrict__ in, ST* __restrict__ out, int n_rows,
                                  int n_cols, int chunk, int k, int tx, AffineRowStep<T> st,
                                  AffineRadial<T> rad, const __grid_constant__ DeepSides<T> sides) {
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * tx;
  GridRows<RP, CP> geo(n_rows, n_cols, r0 - k, c0 - k);
  const int edge_lo = RP ? kNoRow : k - r0;
  const int edge_hi = RP ? kNoRow : n_rows - 1 + k - r0;
  const int base = r0 - k + kDeepPad;
  affine_deep_march<RADIAL, T, RP, CP, SIDES>(geo, st, in, out, k, tx,
                                              min(chunk, n_rows - r0) + 2 * k, edge_lo, edge_hi,
                                              rad, base, &sides, base, 0);
}

// Kernel #12's deep passes on up to kMaxExtBlocks blocks (blockIdx.z): window
// row w of a block is its local row r0 - k + w, grid row origin_row + r0 - k
// + w; a row side's const of a window column at its offset in a buffer row
// plus origin_col - halo + kDeepPad.
template <typename T, bool RADIAL, bool SIDES, bool RP, bool CP, typename ST>
__global__ void __launch_bounds__(kDeepThreads, 1)
    affine_laplace_deep_ext_2d_kernel(AffineSideExtBlocks<ST> io, int n_rows, int n_cols,
                                      int halo, int ld, int chunk, int k, int tx,
                                      AffineRowStep<T> st, AffineRadial<T> rad,
                                      const __grid_constant__ DeepSides<T> sides) {
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * tx;
  ExtRows<RP, CP> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - k;
  geo.c0 = c0 - k;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - k;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const int edge_lo = RP || !geo.e[0] ? kNoRow : k - r0;
  const int edge_hi = RP || !geo.e[1] ? kNoRow : n_rows - 1 + k - r0;
  const int base = io.origin[z][0] + r0 - k + kDeepPad;
  affine_deep_march<RADIAL, T, RP, CP, SIDES>(
      geo, st, io.in[z], io.out[z], k, tx, min(chunk, n_rows - r0) + 2 * k, edge_lo, edge_hi,
      rad, base, &sides, base, io.origin[z][1] - halo + kDeepPad);
}

// The radial constants and the side inputs of a deep pass from the host:
// `doubles` holds make_affine_row_step's 16, then in the radial mode
// AffineRadial's cc and bsy, then with side inputs the pass's t-table, k rows
// of four; `rows` the radial table, `arrays` the 4 side tables' pointers.
template <typename T, bool RADIAL, bool SIDES>
bool deep_inputs(const void* rows, const void* const* arrays, const double* doubles, int k,
                 AffineRadial<T>& rad, DeepSides<T>& sides) {
  rad = AffineRadial<T>{T(0), T(0), nullptr};
  if (RADIAL) {
    if (rows == nullptr) return false;
    rad = AffineRadial<T>{T(doubles[16]), T(doubles[17]), static_cast<const RadialRow<T>*>(rows)};
  }
  const int first = RADIAL ? 18 : 16;
  for (int i = 0; i < 4; ++i) sides.arr[i] = nullptr;
  for (int s = 0; s < kDeepMaxSteps; ++s) {
    for (int i = 0; i < 4; ++i) sides.tt[s][i] = T(0);
  }
  if (SIDES) {
    if (arrays == nullptr) return false;
    for (int i = 0; i < 4; ++i) sides.arr[i] = static_cast<const T*>(arrays[i]);
    for (int s = 0; s < k; ++s) {
      for (int i = 0; i < 4; ++i) sides.tt[s][i] = T(doubles[first + 4 * s + i]);
    }
  }
  return true;
}

// Launches one deep pass of kernel #1 on `stream` without synchronising;
// returns the CUDA error of the launch (0 on success). `ints` holds the 9 host
// ints of affine_launch_grid's layout: the grid shape (rows, columns), the
// rows each block marches, k, the plan (tx, kDeepThreads, 1) and the
// periodicity of each axis, which must be this instantiation's.
template <typename T, bool RADIAL, bool SIDES, bool RP, bool CP, typename ST>
int launch_affine_deep_2d(const void* in, void* out, const void* rows, const void* const* arrays,
                          const int* ints, const double* doubles, void* stream) {
  const int n_rows = ints[0], n_cols = ints[1], chunk = ints[2], k = ints[3], tx = ints[4];
  if (ints[5] != kDeepThreads || ints[6] != 1 || ints[7] != RP || ints[8] != CP || k < 1 ||
      k > kDeepMaxSteps || tx < 1 || tx + 2 * k > kDeepThreads * kDeepCols || n_rows < 1 ||
      n_cols < 1 || chunk < 1) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  AffineRadial<T> rad;
  DeepSides<T> sides;
  if (!deep_inputs<T, RADIAL, SIDES>(rows, arrays, doubles, k, rad, sides)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = deep_smem_bytes<T, RADIAL, SIDES>(k, tx, min(chunk, n_rows) + 2 * k);
  auto kernel = affine_laplace_deep_2d_kernel<T, RADIAL, SIDES, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_cols + tx - 1) / tx, chunks), kDeepThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ST*>(in), static_cast<ST*>(out), n_rows, n_cols, chunk, k, tx,
      make_affine_row_step<T>(doubles), rad, sides);
  return cudaGetLastError();
}

// Launches one deep pass of kernel #12 over n_blocks blocks, as
// launch_affine_deep_2d: `ins` and `outs` are host arrays of n_blocks buffer
// pointers whose rows are `ld` elements apart; `edges` holds, per block, its
// 4 edge flags, then in the radial mode its first row in the grid and with
// side inputs its first row and column; `ints` the 11 host ints of
// affine_ext_launch_grid's layout (the block shape, the buffers' halo and ld,
// the rows each block marches, k, the plan and the periodicity).
template <typename T, bool RADIAL, bool SIDES, bool RP, bool CP, typename ST>
int launch_affine_deep_ext_2d(const void* const* ins, void* const* outs, const int* edges,
                              int n_blocks, const void* rows, const void* const* arrays,
                              const int* ints, const double* doubles, void* stream) {
  const int n_rows = ints[0], n_cols = ints[1], halo = ints[2], ld = ints[3], chunk = ints[4];
  const int k = ints[5], tx = ints[6];
  if (ints[7] != kDeepThreads || ints[8] != 1 || ints[9] != RP || ints[10] != CP || k < 1 ||
      k > kDeepMaxSteps || tx < 1 || tx + 2 * k > kDeepThreads * kDeepCols || n_blocks < 1 ||
      n_blocks > kMaxExtBlocks || halo < k || n_rows < halo || n_cols < halo ||
      ld < n_cols + 2 * halo || chunk < 1 || (SIDES && halo > kDeepPad)) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const int per_block = SIDES ? 6 : RADIAL ? 5 : 4;
  AffineSideExtBlocks<ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const ST*>(ins[z]);
    io.out[z] = static_cast<ST*>(outs[z]);
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[per_block * z + e];
    io.origin[z][0] = per_block > 4 ? edges[per_block * z + 4] : 0;
    io.origin[z][1] = per_block > 5 ? edges[per_block * z + 5] : 0;
    if (io.origin[z][0] < 0 || io.origin[z][1] < 0) return cudaErrorInvalidValue;
  }
  AffineRadial<T> rad;
  DeepSides<T> sides;
  if (!deep_inputs<T, RADIAL, SIDES>(rows, arrays, doubles, k, rad, sides)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = deep_smem_bytes<T, RADIAL, SIDES>(k, tx, min(chunk, n_rows) + 2 * k);
  auto kernel = affine_laplace_deep_ext_2d_kernel<T, RADIAL, SIDES, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_cols + tx - 1) / tx, chunks, n_blocks), kDeepThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(io, n_rows, n_cols, halo, ld, chunk, k, tx,
                                                make_affine_row_step<T>(doubles), rad, sides);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
