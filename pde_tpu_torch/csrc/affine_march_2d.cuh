// Temporally blocked affine Laplacian on 2D Cartesian grids, for Hopper
// (sm_90a): one row-marching wavefront for both 2D affine kernels, each
// thread's window column of every level held in registers. Hand-written
// template; its entry points, one instantiation per (k, dtype) at the plan the
// host picks, for one periodicity of the two axes, are generated by
// pde_tpu_torch/ops/cuda_cartesian.py (serial grids) and
// pde_tpu_torch/ops/cuda_ext_2d.py (the extended blocks of decomposed grids).
//
// Replaces two TPU kernels of pde_tpu/ops/pallas_cartesian.py that compute
//     f <- (a*I + b*lap)^k f,   1 <= k <= 16,
// with the 5-point Laplacian and per-axis spacing, periodic axes, and
// constant affine ghost cells on non-periodic sides, ghost = c + f1*edge +
// f2*next_inward (Dirichlet, Neumann, Robin and curvature conditions):
// `make_affine_laplace_2d` (kernel #1, on the grid) and
// `make_affine_laplace_ext_2d` (#12, on halo-extended blocks of shape
// (n + 2h, m + 2h), rows `ld` elements apart, whose int32 edge flags stand
// where the grid has its non-periodic sides; up to kMaxExtBlocks blocks a
// launch through blockIdx.z). Both also have the TPU kernels' 9-point
// corner-weight mode on fully periodic grids (its section at the end of
// this file).
//
// Kernel #1 also has the TPU kernel's radial mode (its `radial=` argument,
// `_radial_row_coeffs`): on a cylindrical grid, rows r and columns z, the
// (1/r) d/dr term of the Laplacian folds into the factors of the row above
// and below, so a step is
//     cu(row)*up + cd(row)*down + b*sy*(left + right) + (a - 2b(sx + sy))*c,
//     cu, cd = b*sx -+ (b / (2 dr)) / r,   r = (row + 1/2) dr + r_lo.
// The factors are one per grid row: the host's table of (cu, cd) pairs
// (radial_rows of ops/cuda_cartesian.py, the same numbers its torch versions
// read), one 8- or 16-byte load a level and row, which every thread of the
// block makes at the same address. The r axis is never periodic; its
// ghosts are the bounded rows' ghosts of the Cartesian march, and the
// isotropic fold does not apply. The radial mode has a kernel of its own,
// affine_laplace_radial_2d_kernel, the only one that takes its arguments
// (AffineRadial), so the Cartesian instantiations compile as they would
// without it. Its ext counterpart, affine_laplace_radial_ext_2d_kernel (TPU
// kernel #12's radial mode), marches the blocks of a decomposed cylindrical
// grid and reads the same table, at the block's global rows.
//
// Kernel #1 also takes the TPU kernel's side inputs (B1(c); its docstring
// at pde_tpu/ops/pallas_cartesian.py:807-817): a side's const may be one
// value per cell along the side (a row side's along the columns, a column
// side's along the rows) and may add a time-dependent value per step of the
// pass, the host's t-table (k rows of the four sides' values, evaluated from
// the solver's time on the host). Such passes have a kernel of their own,
// affine_laplace_sides_2d_kernel, whose march forms each ghost from
// AffineSides: the per-point tables in device memory, read only where a
// ghost is formed (a row side's at the thread's grid column, a column side's
// at the row's grid row, its table padded by kSidePad rows at either end),
// and the t-table by value among the kernel's parameters. Its passes go up
// to SIDES_TOP_STEPS = 6 steps (ops/cuda_cartesian.py): past that the ghosts'
// code and loads cost more a step than the deeper pass saves
// (scripts/torch_sides_sweep.py, PERF.md). The instantiations without side
// inputs compile as they would without them. Kernel #12 takes the same side
// inputs on the blocks of a decomposed grid (affine_laplace_sides_ext_2d_kernel,
// its section below): each block reads the global grid's tables at its
// origin. The radial modes of both take them too (their section at the end
// of the radial ext kernel's): the same march with the radial table and the
// side tables together, kernels of their own.
//
// bf16 storage (ROADMAP B1(f)): pde_tpu's kernels #1 and #12 take bf16 data
// where the columns are periodic, or cut by the mesh
// (pde_tpu/ops/pallas_cartesian.py:306-315, 775-790, 5455-5467, 5764-5767).
// Every kernel and launcher of the 5-point and radial marches takes a storage
// type ST last, T by default. With ST = __nv_bfloat16 and T = float the march
// loads and stores bf16 and rounds each level it keeps to bf16 (round_to,
// below), as pde_tpu's band holds every level in bf16; registers,
// shared rows, coefficients, the radial table and the side tables stay float
// (the side tables and the t-table hold bf16-rounded values), at the float
// plan. The bf16 entry points live in libraries of their own; with ST = T
// each instantiation compiles as before. The Cartesian modes keep nvcc's FMA
// contraction: an f32 value a rounding apart from the plain version's rarely
// crosses a bf16 midpoint. The radial modes round every product and sum of
// the update and the ghosts as the plain version does (kRoundEach, below),
// as the radial side-input mode does in fp32: with FMAs the bf16 radial pass
// was 1.5 bf16 ulps of max|f| off its plain version at k = 7 on the H100.
//
// What bounds it on this card. A pass reads and writes every cell once: 8 B
// per fp32 cell (4 B in bf16), so a 4096^2 pass takes at least 40 us (20 us)
// at the data sheet's 3.35 TB/s whatever k, and k steps divide that per step; the 5-point update
// is 6-8 flops, far below the 67 TFLOP/s fp32 rate. Past a few steps the
// instructions issued per cell-step set the pace: the update, its two
// shared-memory loads and one store, the recomputed halo and the barrier per
// row.
//
// Design: the row march of march_2d.cuh (kernels #7/#8) for one field whose
// rhs reaches one row, on its window geometries GridRows and ExtRows.
//   - A block of NT threads owns an output strip of TX columns and a chunk of
//     rows (the caller's: chunk_rows of ops/cuda_stencil_2d.py), and marches
//     down the chunk plus K rows of halo at each end; a window row holds
//     WX = TX + 2K columns, dealt linearly over the threads (column
//     q = thread + m * NT). Each thread computes once, at the start, each
//     column's offset in a row of the buffer (periodic columns wrapped there,
//     once) and its flags; the rows read advance by an increment.
//   - Wavefront over the K levels: iteration t brings level 0 of window row t
//     (loaded P rows ahead into registers); then, for s = 0 .. K - 1, level
//     s + 1 of row t - s - 1 is computed from level s of rows t - s - 2,
//     t - s - 1 and t - s. Level K goes from registers to device memory.
//   - Own column in registers: a thread's vertical neighbours are values it
//     computed itself. Level s of window row y lives in register lv[s][y % 3]
//     of the thread that owns its column; the row below the centre is the
//     value the level below has just computed into that same ring. Only the
//     left and right neighbours come from shared memory: each level keeps a
//     ring of two shared rows; level s writes row t - s into one while level
//     s + 1 reads row t - s - 1 from the other, so one barrier per iteration
//     orders them. That is 2 shared loads and 1 store per cell-step, and K * 2
//     shared rows a block.
//   - The row loop is unrolled by kPeriod = 6, the least common multiple of
//     the two slots and the three registers of a level, so that every slot
//     is a constant offset and every register a constant name: no register
//     is moved and no slot computed (with its slots computed per read, the
//     generated march of march_2d.cuh took 1.6-1.8x as long a pass).
//   - Every level computes every window column of every row, valid or not:
//     a value outside a level's light cone (the window's margins, the rows
//     before the wavefront fills, cells outside a bounded axis) never reaches
//     a cell the block writes, so no depth, lag or domain test is run. Shared
//     rows carry one pad cell on each side and a cell for every thread's
//     column, so no read or store leaves them.
//   - Ghosts are formed where they are read: the thread that updates a cell
//     next to a side with ghosts replaces the neighbour beyond it by
//     c + f1*centre + f2*inward, both operands of the same update, at the
//     level being updated (what the TPU kernel writes into its ghost row at
//     every step). No rewrite pass, no barrier. The 5-point stencil never
//     reads corner ghosts, and a cell inside the domain never reads a cell
//     outside it, so those may hold anything. A fully periodic grid compiles
//     no edge test at all (RP and CP are template parameters).
//   - The per-cell update is one __device__ function, affine_update_2d, in
//     the plain version's order of operations, which both kernels call, so a
//     decomposed run equals the serial run bit for bit whatever FMA
//     contraction nvcc chooses.
// Global offsets are 64-bit; a row's offsets 32-bit.
//
// Choices, each timed against the others by scripts/torch_affine2d_sweep.py
// on the H100 (PERF.md), which holds the losers' copies:
// - The plan is the host's (affine_row_plan of ops/cuda_cartesian.py):
//   strips of 256 columns (128 and 512 ran slower), one window column a
//   thread (two: slower), three level-0 rows in flight (one left the small-k
//   passes waiting on device memory), and launch bounds of four blocks per
//   SM in fp32 and two in fp64, which hold the registers of the deep passes
//   where the blocks of 4096^2 fit the card in one wave.
// - Column neighbours from shared memory: warp shuffles, with shared memory
//   only at the warps' edges, ran slower.

#pragma once

#include <cuda_bf16.h>

#include "march_2d.cuh"

namespace pde_tpu_torch {

// Storage types (bf16 storage, ROADMAP B1(f)): the march computes in its
// working type T, in registers and shared rows, and loads and stores the
// buffers in a storage type S: T itself, or __nv_bfloat16 with T = float.
// With S narrower than T each level the march keeps is rounded to S, as
// pde_tpu's kernels hold every level of a bf16 band in bf16; with S = T all
// three are the identity, so those instantiations compile as before.
template <typename T, typename S>
__device__ __forceinline__ T load_as(S v) {
  if constexpr (std::is_same_v<S, T>) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}
template <typename S, typename T>
__device__ __forceinline__ S store_as(T v) {
  if constexpr (std::is_same_v<S, T>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}
template <typename S, typename T>
__device__ __forceinline__ T round_to(T v) {
  return load_as<T>(store_as<S>(v));
}

constexpr int kAffineMaxSteps = 16;
// rows of a column side's per-point table before grid row 0 (and after the
// last): a pass reads window rows up to K past either end of the grid
constexpr int kSidePad = kAffineMaxSteps;
// the window row of a side without ghosts: no iteration's rows reach it
constexpr int kNoRow = -(1 << 30);
// rows of the radial table before grid row 0 (and after the last): a pass
// reads window rows up to 2K before its chunk and K after it
constexpr int kRadialPad = 2 * kAffineMaxSteps;
// the march's update: 5-point anisotropic, isotropic (folded), radial
enum AffineMode : int { kAnisotropic = 0, kIsotropic = 1, kRadial = 2 };

// One step's coefficients in the working type, and the sides' ghost formulas.
template <typename T>
struct AffineRowStep {
  T a, b, sx, sy, bsx;  // bsx = b / dx^2 of an isotropic grid
  int isotropic;
  T side[4][3];  // (c, f1, f2) of the row-low, row-high, column-low and column-high sides
};

// A grid row's factors of the row above (cu) and below (cd), radial mode.
template <typename T>
struct alignas(2 * sizeof(T)) RadialRow {
  T cu, cd;
};

// The radial mode's own arguments: the centre's and the column neighbours'
// factors, a - 2b/dx^2 - 2b/dy^2 and b/dy^2 (radial_constants of
// ops/cuda_cartesian.py), and the device table of the grid rows' factors,
// grid row g's at rows[g + kRadialPad] (radial_rows).
template <typename T>
struct AffineRadial {
  T cc, bsy;
  const RadialRow<T>* rows;
};

// The side inputs of a pass (B1(c)): per side (row-low, row-high,
// column-low, column-high) its per-point consts or nullptr (a row side's
// n_cols of them by grid column; a column side's by grid row g at
// arr[g + kSidePad]), and the t-table, the value each side's const gains at
// each step of the pass (zero where a side has none).
template <typename T>
struct AffineSides {
  const T* arr[4];
  T tt[kAffineMaxSteps][4];
};

// From 16 host doubles: a, b, 1/dx^2, 1/dy^2, then (c, f1, f2) of the
// row-low, row-high, column-low and column-high sides.
template <typename T>
AffineRowStep<T> make_affine_row_step(const double* d) {
  AffineRowStep<T> st;
  st.a = T(d[0]);
  st.b = T(d[1]);
  st.sx = T(d[2]);
  st.sy = T(d[3]);
  st.bsx = T(d[1] * d[2]);
  st.isotropic = d[2] == d[3];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) st.side[i][j] = T(d[4 + 3 * i + j]);
  }
  return st;
}

template <typename T>
__device__ __forceinline__ T side_ghost(const T (&s)[3], T edge, T inward) {
  T g = s[0] + s[1] * edge;
  if (s[2] != T(0)) g = g + s[2] * inward;
  return g;
}

// The one per-cell update of both 2D affine kernels: a*f + b*lap(f) from the
// centre and its row (up, down) and column (left, right) neighbours; ISO is
// st.isotropic, decided once per block.
template <bool ISO, typename T>
__device__ __forceinline__ T affine_update_2d(const AffineRowStep<T>& st, T center, T up, T down,
                                              T left, T right) {
  if constexpr (ISO) {
    return st.a * center + st.bsx * (up + down + left + right - T(4) * center);
  } else {
    const T lap = (up + down - T(2) * center) * st.sx + (left + right - T(2) * center) * st.sy;
    return st.a * center + st.b * lap;
  }
}

// The radial mode's update from its row's factors f, in the order of the
// plain version (_update of ops/cuda_cartesian.py) and of pde_tpu.
template <typename T>
__device__ __forceinline__ T affine_radial_update_2d(const AffineRadial<T>& rad, RadialRow<T> f,
                                                     T center, T up, T down, T left, T right) {
  return f.cu * up + f.cd * down + rad.bsy * (left + right) + rad.cc * center;
}

// Products and sums rounded one by one, as the plain version's torch ops
// round them: nvcc never contracts these into FMAs.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The radial side-input mode's update: affine_radial_update_2d's operations
// in its order, each rounded as the plain version rounds it, so that a pass
// equals its plain version bit for bit on the card (FMA contraction left the
// scalar radial mode 5.96e-8 * k of max|f| off its plain version in fp32).
template <typename T>
__device__ __forceinline__ T affine_radial_update_rn_2d(const AffineRadial<T>& rad,
                                                        RadialRow<T> f, T center, T up, T down,
                                                        T left, T right) {
  T x = add_rn(mul_rn(f.cu, up), mul_rn(f.cd, down));
  x = add_rn(x, mul_rn(rad.bsy, add_rn(left, right)));
  return add_rn(x, mul_rn(rad.cc, center));
}

__host__ __device__ constexpr int residue(int a, int n) { return (a % n + n) % n; }

// The march at K steps over strips of TX columns with NT threads.
template <typename T, int K, int TX, int NT>
struct AffineRowShape {
  static constexpr int kWX = TX + 2 * K;             // a window row
  static constexpr int kCols = (kWX + NT - 1) / NT;  // window columns a thread
  static constexpr int kRow = NT * kCols + 2;        // a shared row: every thread's columns, a pad cell each side
  static constexpr int kSlots = 2;                   // shared rows a level
  static constexpr int kPeriod = 6;                  // lcm of the slots and a level's 3 registers
  static constexpr size_t kSmem = size_t(K) * kSlots * kRow * sizeof(T);
};

// The side inputs' modes of a march: none, the serial kernel's (a row
// side's table read at the column's offset in a grid row, its grid column)
// and the ext kernel's (a row side's table padded by kSidePad columns and
// read at the column's offset in a buffer row plus the block's shift).
enum AffineSideMode : int { kNoSides = 0, kGridSides = 1, kExtSides = 2 };

// Where a march with side inputs (SIDES) finds them: the kernel's parameter,
// the index into a column side's table of window row 0 and, in the ext
// mode, the shift from a column's offset in a buffer row to its index in a
// row side's table; nothing at all in a march without them, so its code is
// what it was before them.
template <typename T, int SIDES>
struct AffineSideRefs {
  __device__ __forceinline__ AffineSideRefs(const AffineSides<T>*, int, int) {}
};
template <typename T>
struct AffineSideRefs<T, kGridSides> {
  const AffineSides<T>* const sides;
  const int side_base;
  __device__ __forceinline__ AffineSideRefs(const AffineSides<T>* sides_, int side_base_, int)
      : sides(sides_), side_base(side_base_) {}
  __device__ __forceinline__ int col_shift() const { return 0; }
};
template <typename T>
struct AffineSideRefs<T, kExtSides> {
  const AffineSides<T>* const sides;
  const int side_base, shift;
  __device__ __forceinline__ AffineSideRefs(const AffineSides<T>* sides_, int side_base_,
                                            int shift_)
      : sides(sides_), side_base(side_base_), shift(shift_) {}
  __device__ __forceinline__ int col_shift() const { return shift; }
};

// One block's march: `geo` maps window cells to the buffers (serial grid or
// extended block); `rows` window rows (the chunk's output rows plus K at each
// end); `edge_lo`/`edge_hi` the window rows next to the row sides with ghosts
// (kNoRow: none); P rows of level 0 in flight. `in` and `out` share a layout
// and hold the storage type ST (T, or __nv_bfloat16 with T = float: bf16
// storage, each level rounded to it; load_as above).
// MODE is the update's; in the radial mode window row w's factors are
// rad.rows[rad_base + w]. With SIDES (AffineSideMode) the ghosts take the
// side inputs `sides`, a column side's const of window row w at
// arr[side_base + w], a row side's of window column m at arr[off[m] +
// col_shift()].
template <int MODE, typename T, int K, int TX, int NT, int P, bool RP, bool CP, class Geo,
          int SIDES = kNoSides, typename ST = T>
struct AffineRowMarch : AffineSideRefs<T, SIDES> {
  using S = AffineRowShape<T, K, TX, NT>;
  // the radial update and ghosts with each product and sum rounded (mul_rn,
  // add_rn): the side-input mode's, and bf16 storage's
  static constexpr bool kRoundEach =
      MODE == kRadial && (SIDES != kNoSides || !std::is_same_v<ST, T>);
  static constexpr int M = S::kCols, WX = S::kWX, PERIOD = S::kPeriod;
  static_assert(PERIOD % P == 0, "the prefetch ring must divide the unroll period");

  Geo& geo;
  const AffineRowStep<T>& st;
  const ST* __restrict__ in;
  ST* __restrict__ out;
  T* const smem;
  const AffineRadial<T> rad;  // the radial mode's (else unused)
  const int tid, rows, edge_lo, edge_hi, rad_base;
  int off[M];
  unsigned flags[M];
  T lv[K][3][M];  // level s of window row y: lv[s][y % 3]
  T next[P][M];   // level 0 of the rows in flight: row y in next[y % P]

  __device__ __forceinline__ AffineRowMarch(Geo& geo_, const AffineRowStep<T>& st_, const ST* in_,
                                            ST* out_, T* smem_, int rows_, int edge_lo_,
                                            int edge_hi_, AffineRadial<T> rad_ = {},
                                            int rad_base_ = 0,
                                            const AffineSides<T>* sides_ = nullptr,
                                            int side_base_ = 0, int col_shift_ = 0)
      : AffineSideRefs<T, SIDES>(sides_, side_base_, col_shift_), geo(geo_), st(st_), in(in_), out(out_),
        smem(smem_), rad(rad_), tid(threadIdx.x), rows(rows_), edge_lo(edge_lo_),
        edge_hi(edge_hi_), rad_base(rad_base_) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = tid + m * NT;
      off[m] = 0;
      flags[m] = 0u;
      if (q < WX) {
        const RowColumn c = geo.column(q, q >= K && q < WX - K);
        off[m] = c.off;
        flags[m] = c.flags;
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
#pragma unroll
        for (int j = 0; j < 3; ++j) lv[s][j][m] = T(0);
      }
    }
  }

  // level s's shared row for window rows of residue y (mod the period): a
  // constant offset
  template <int LEVEL, int Y>
  __device__ __forceinline__ T* slot() const {
    return smem + (LEVEL * S::kSlots + residue(Y, S::kSlots)) * S::kRow + 1;
  }

  // the ghost of side I (row-low, row-high, column-low, column-high) at level
  // L beside window column m of window row w, from the edge cell and the next
  // inward: c + f1*edge + f2*inward; with SIDES its const is the side's
  // scalar or per-point value plus its t-table entry of step L (with
  // kRoundEach each product and sum rounded as the plain version rounds it)
  template <int I, int L>
  __device__ __forceinline__ T ghost(int m, int w, T edge, T inward) const {
    if constexpr (SIDES != kNoSides) {
      T c = st.side[I][0];
      const T* arr = this->sides->arr[I];
      if (arr != nullptr) c = I < 2 ? arr[off[m] + this->col_shift()] : arr[this->side_base + w];
      c = c + this->sides->tt[L][I];
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
  __device__ __forceinline__ void load_row(T (&v)[M]) {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[m] = T(0);
      if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[m] = load_as<T>(in[pl.off + off[m]]);
    }
  }

  // level L in iteration t (residue R): level L + 1 of window row t - L - 1
  template <int R, int L>
  __device__ __forceinline__ void level(int t, long long out_row) {
    if constexpr (L < K) {
      constexpr int w = R - L - 1;  // the residue of the centre row
      const T* row = slot<L, w>();
      RadialRow<T> factors{T(0), T(0)};
      if constexpr (MODE == kRadial) factors = rad.rows[rad_base + t - L - 1];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = tid + m * NT;
        const T center = lv[L][residue(w, 3)][m];
        T up = lv[L][residue(w - 1, 3)][m], down = lv[L][residue(w + 1, 3)][m];
        T left = row[q - 1], right = row[q + 1];  // the column neighbours
        if constexpr (!RP) {
          if (t - L - 1 == edge_lo) up = ghost<0, L>(m, t - L - 1, center, down);
          if (t - L - 1 == edge_hi) down = ghost<1, L>(m, t - L - 1, center, up);
        }
        if constexpr (!CP) {
          if (flags[m] & kLowEdge) left = ghost<2, L>(m, t - L - 1, center, right);
          if (flags[m] & kHighEdge) right = ghost<3, L>(m, t - L - 1, center, left);
        }
        T x;
        if constexpr (kRoundEach) {
          x = affine_radial_update_rn_2d(rad, factors, center, up, down, left, right);
        } else if constexpr (MODE == kRadial) {
          x = affine_radial_update_2d(rad, factors, center, up, down, left, right);
        } else {
          x = affine_update_2d<MODE == kIsotropic>(st, center, up, down, left, right);
        }
        if constexpr (L + 1 < K) {
          x = round_to<ST>(x);  // the level in ST's values
          lv[L + 1][residue(w, 3)][m] = x;
          slot<L + 1, w>()[q] = x;  // level L + 1 of row w, for its column neighbours
        } else if (t >= 2 * K && (flags[m] & kOut)) {
          out[out_row + off[m]] = store_as<ST>(x);
        }
      }
      level<R, L + 1>(t, out_row);
    }
  }

  // iteration t (residue R)
  template <int R>
  __device__ __forceinline__ void advance(int t) {
    const long long out_row = geo.row(t - K).off;  // meaningful once t >= 2K
    T* dst = slot<0, R>();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      lv[0][residue(R, 3)][m] = next[R % P][m];
      dst[tid + m * NT] = next[R % P][m];
    }
    if (t + P < rows) load_row(next[R % P]);
    level<R, 0>(t, out_row);
    __syncthreads();
  }

  // iterations t0 + U, t0 + U + 1, ... up to the period (t0 a multiple of it)
  template <int U>
  __device__ __forceinline__ void iterate(int t0) {
    if constexpr (U < PERIOD) {
      const int t = t0 + U;
      if (t >= rows) return;
      advance<U>(t);
      iterate<U + 1>(t0);
    }
  }

  __device__ __forceinline__ void run() {
#pragma unroll
    for (int p = 0; p < P; ++p) load_row(next[p]);  // rows >= 2K + 1 >= P
    for (int t0 = 0; t0 < rows; t0 += PERIOD) iterate<0>(t0);
  }
};

template <typename T, int K, int TX, int NT, int P, bool RP, bool CP, class Geo, typename ST>
__device__ __forceinline__ void affine_march_2d(Geo& geo, const AffineRowStep<T>& st,
                                                const ST* in, ST* out, int rows, int edge_lo,
                                                int edge_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  if (st.isotropic) {
    AffineRowMarch<kIsotropic, T, K, TX, NT, P, RP, CP, Geo, kNoSides, ST> march(
        geo, st, in, out, smem, rows, edge_lo, edge_hi);
    march.run();
  } else {
    AffineRowMarch<kAnisotropic, T, K, TX, NT, P, RP, CP, Geo, kNoSides, ST> march(
        geo, st, in, out, smem, rows, edge_lo, edge_hi);
    march.run();
  }
}

// The kernels below take the storage type ST last (default T; bf16 storage:
// __nv_bfloat16 with T = float), their launchers likewise.
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_2d_kernel(const ST* __restrict__ in, ST* __restrict__ out, int n_rows,
                             int n_cols, int chunk, AffineRowStep<T> st) {
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<RP, CP> geo(n_rows, n_cols, r0 - K, c0 - K);
  // window row w is grid row r0 - K + w
  const int edge_lo = RP ? kNoRow : K - r0;
  const int edge_hi = RP ? kNoRow : n_rows - 1 + K - r0;
  affine_march_2d<T, K, TX, NT, P, RP, CP>(geo, st, in, out, min(chunk, n_rows - r0) + 2 * K,
                                           edge_lo, edge_hi);
}

// Kernel #1's passes with side inputs (B1(c)): the march above, its ghosts
// formed from `sides` (a __grid_constant__ parameter, read in place).
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_sides_2d_kernel(const ST* __restrict__ in, ST* __restrict__ out, int n_rows,
                                   int n_cols, int chunk, AffineRowStep<T> st,
                                   const __grid_constant__ AffineSides<T> sides) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<RP, CP> geo(n_rows, n_cols, r0 - K, c0 - K);
  const int edge_lo = RP ? kNoRow : K - r0;
  const int edge_hi = RP ? kNoRow : n_rows - 1 + K - r0;
  const int rows = min(chunk, n_rows - r0) + 2 * K;
  // window row w is grid row r0 - K + w
  const int side_base = r0 - K + kSidePad;
  if (st.isotropic) {
    AffineRowMarch<kIsotropic, T, K, TX, NT, P, RP, CP, GridRows<RP, CP>, kGridSides, ST> march(
        geo, st, in, out, smem, rows, edge_lo, edge_hi, {}, 0, &sides, side_base);
    march.run();
  } else {
    AffineRowMarch<kAnisotropic, T, K, TX, NT, P, RP, CP, GridRows<RP, CP>, kGridSides, ST> march(
        geo, st, in, out, smem, rows, edge_lo, edge_hi, {}, 0, &sides, side_base);
    march.run();
  }
}

// The radial mode's kernel: the r axis (rows) bounded, z (columns) periodic
// or not (CP).
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_radial_2d_kernel(const ST* __restrict__ in, ST* __restrict__ out, int n_rows,
                                    int n_cols, int chunk, AffineRowStep<T> st,
                                    AffineRadial<T> rad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<false, CP> geo(n_rows, n_cols, r0 - K, c0 - K);
  // window row w is grid row r0 - K + w, whose factors are kRadialPad rows
  // into the table past it
  AffineRowMarch<kRadial, T, K, TX, NT, P, false, CP, GridRows<false, CP>, kNoSides, ST> march(
      geo, st, in, out, reinterpret_cast<T*>(smem_raw), min(chunk, n_rows - r0) + 2 * K, K - r0,
      n_rows - 1 + K - r0, rad, r0 - K + kRadialPad);
  march.run();
}

// Kernel #1's radial mode with side inputs (B1(c) on a cylinder; pde_tpu's
// make_affine_laplace_2d with radial= and bcs= together): the radial march
// above, its ghosts formed from `sides` as the side-input kernel forms them.
// Window row w is grid row r0 - K + w: its factors at rad.rows[r0 - K +
// kRadialPad + w], a column side's const at arr[r0 - K + kSidePad + w]; a
// row side's (r- or r+, along z) at the column's grid column. The two tables
// have pads of their own (kRadialPad rows, kSidePad rows), each wide enough
// for the rows a pass reads.
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_radial_sides_2d_kernel(const ST* __restrict__ in, ST* __restrict__ out,
                                          int n_rows, int n_cols, int chunk, AffineRowStep<T> st,
                                          AffineRadial<T> rad,
                                          const __grid_constant__ AffineSides<T> sides) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<false, CP> geo(n_rows, n_cols, r0 - K, c0 - K);
  AffineRowMarch<kRadial, T, K, TX, NT, P, false, CP, GridRows<false, CP>, kGridSides, ST> march(
      geo, st, in, out, reinterpret_cast<T*>(smem_raw), min(chunk, n_rows - r0) + 2 * K, K - r0,
      n_rows - 1 + K - r0, rad, r0 - K + kRadialPad, &sides, r0 - K + kSidePad);
  march.run();
}

// The launch grid of a 2D affine pass from its 9 host ints (the grid shape
// (rows, columns), the rows each block marches, then k, the plan (TX, NT, P)
// and the periodicity of each axis); false where they are not this
// instantiation's or the grid does not fit.
template <int K, int TX, int NT, int P, bool RP, bool CP>
bool affine_launch_grid(const int* ints, dim3& blocks) {
  static_assert(K >= 1 && K <= kAffineMaxSteps, "1 <= k <= 16");
  if (ints[3] != K || ints[4] != TX || ints[5] != NT || ints[6] != P || ints[7] != RP ||
      ints[8] != CP) {
    return false;
  }
  const int n_rows = ints[0], n_cols = ints[1], chunk = ints[2];
  if (n_rows < 1 || n_cols < 1 || chunk < 1) return false;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return false;
  blocks = dim3((n_cols + TX - 1) / TX, chunks);
  return true;
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ints` holds the 9 host ints of
// affine_launch_grid, which must be this instantiation's; `doubles` 16 host
// doubles (make_affine_row_step).
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
int launch_affine_2d(const void* in, void* out, const int* ints, const double* doubles,
                     void* stream) {
  dim3 blocks;
  if (!affine_launch_grid<K, TX, NT, P, RP, CP>(ints, blocks)) return cudaErrorInvalidValue;
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_2d_kernel<T, K, TX, NT, P, MINB, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ST*>(in), static_cast<ST*>(out), ints[0], ints[1], ints[2],
      make_affine_row_step<T>(doubles));
  return cudaGetLastError();
}

// The side inputs of a pass from the host: `arrays`, 4 device pointers
// (AffineSides::arr, nullptr where a side has none), and the t-table, k rows
// of four host doubles from doubles[first] on.
template <typename T, int K>
AffineSides<T> make_affine_sides(const void* const* arrays, const double* doubles, int first) {
  AffineSides<T> sides;
  for (int i = 0; i < 4; ++i) sides.arr[i] = static_cast<const T*>(arrays[i]);
  for (int s = 0; s < kAffineMaxSteps; ++s) {
    for (int i = 0; i < 4; ++i) sides.tt[s][i] = s < K ? T(doubles[first + 4 * s + i]) : T(0);
  }
  return sides;
}

// Launches one K-step pass with side inputs, as launch_affine_2d: `arrays`
// holds 4 device pointers (AffineSides::arr, nullptr where a side has none)
// and `doubles` 16 + 4K host doubles, make_affine_row_step's 16 then the
// pass's t-table, row by row.
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
int launch_affine_sides_2d(const void* in, void* out, const void* const* arrays, const int* ints,
                           const double* doubles, void* stream) {
  dim3 blocks;
  if (arrays == nullptr || !affine_launch_grid<K, TX, NT, P, RP, CP>(ints, blocks)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_sides_2d_kernel<T, K, TX, NT, P, MINB, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ST*>(in), static_cast<ST*>(out), ints[0], ints[1], ints[2],
      make_affine_row_step<T>(doubles), make_affine_sides<T, K>(arrays, doubles, 16));
  return cudaGetLastError();
}

// Launches one K-step pass of the radial mode, as launch_affine_2d (the rows
// not periodic); `doubles` holds 18 host doubles, make_affine_row_step's 16
// then AffineRadial's cc and bsy; `rows` the device table of the factors of
// grid rows -kRadialPad .. n_rows + kRadialPad - 1 (radial_rows).
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
int launch_affine_radial_2d(const void* in, void* out, const void* rows, const int* ints,
                            const double* doubles, void* stream) {
  dim3 blocks;
  if (rows == nullptr || !affine_launch_grid<K, TX, NT, P, false, CP>(ints, blocks)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_radial_2d_kernel<T, K, TX, NT, P, MINB, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]),
                            static_cast<const RadialRow<T>*>(rows)};
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ST*>(in), static_cast<ST*>(out), ints[0], ints[1], ints[2],
      make_affine_row_step<T>(doubles), rad);
  return cudaGetLastError();
}

// Launches one K-step pass of the radial mode with side inputs, as
// launch_affine_radial_2d; `arrays` holds 4 device pointers (AffineSides::arr,
// a column side's table padded by kSidePad rows) and `doubles` 18 + 4K host
// doubles, in this order: make_affine_row_step's 16, AffineRadial's cc and
// bsy, then the pass's t-table, row by row (step_doubles of
// ops/cuda_cartesian.py).
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
int launch_affine_radial_sides_2d(const void* in, void* out, const void* rows,
                                  const void* const* arrays, const int* ints,
                                  const double* doubles, void* stream) {
  dim3 blocks;
  if (rows == nullptr || arrays == nullptr ||
      !affine_launch_grid<K, TX, NT, P, false, CP>(ints, blocks)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_radial_sides_2d_kernel<T, K, TX, NT, P, MINB, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]),
                            static_cast<const RadialRow<T>*>(rows)};
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ST*>(in), static_cast<ST*>(out), ints[0], ints[1], ints[2],
      make_affine_row_step<T>(doubles), rad, make_affine_sides<T, K>(arrays, doubles, 18));
  return cudaGetLastError();
}

// -- the ext kernel ---------------------------------------------------------------
//
// The march above on the local blocks of a decomposed grid. A block's field
// lives in an extended buffer of shape (n_rows + 2*halo, n_cols + 2*halo),
// rows `ld` elements apart (ld >= n_cols + 2*halo, so that rows can start on
// 128-byte lines), whose halo ring the caller filled from the neighbouring
// blocks (halo >= K); the window is read from it at offset halo around the
// block (ExtRows), with no index wrap, and the chunk is written into the
// interior of the output buffer. A block's edge flags stand where the serial
// kernel has the grid's non-periodic sides (the same ghosts, through the same
// column flags and edge rows); elsewhere the halo is trusted.

template <typename T>
struct AffineExtBlocks {
  const T* in[kMaxExtBlocks];
  T* out[kMaxExtBlocks];
  int edge[kMaxExtBlocks][4];  // row_lo, row_hi, col_lo, col_hi
};

template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_ext_2d_kernel(AffineExtBlocks<ST> io, int n_rows, int n_cols, int halo, int ld,
                                 int chunk, AffineRowStep<T> st) {
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * TX;
  ExtRows<RP, CP> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - K;
  geo.c0 = c0 - K;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - K;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const int edge_lo = RP || !geo.e[0] ? kNoRow : K - r0;
  const int edge_hi = RP || !geo.e[1] ? kNoRow : n_rows - 1 + K - r0;
  affine_march_2d<T, K, TX, NT, P, RP, CP>(geo, st, io.in[z], io.out[z],
                                           min(chunk, n_rows - r0) + 2 * K, edge_lo, edge_hi);
}

// Launches one K-step ext pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of n_blocks buffer pointers whose rows are `ld`
// elements apart; `edges` holds 4 host ints per block; `ints` 11 host ints:
// the block shape (rows, columns), the buffers' halo and ld, the rows each
// block marches, then k, the plan (TX, NT, P) and the periodicity of each
// axis, which must be this instantiation's; `doubles` 16 host doubles
// (make_affine_row_step). The radial mode has a kernel of its own, below.
// The launch grid of an ext pass over n_blocks blocks from its 11 host ints
// (launch_affine_ext_2d's); false where they are not this instantiation's or
// the blocks do not fit.
template <int K, int TX, int NT, int P, bool RP, bool CP>
bool affine_ext_launch_grid(const int* ints, int n_blocks, dim3& blocks) {
  static_assert(K >= 1 && K <= kAffineMaxSteps, "1 <= k <= 16");
  if (ints[5] != K || ints[6] != TX || ints[7] != NT || ints[8] != P || ints[9] != RP ||
      ints[10] != CP) {
    return false;
  }
  const int n_rows = ints[0], n_cols = ints[1], halo = ints[2], ld = ints[3], chunk = ints[4];
  if (n_blocks < 1 || n_blocks > kMaxExtBlocks || halo < K || n_rows < halo || n_cols < halo ||
      ld < n_cols + 2 * halo || chunk < 1)
    return false;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return false;
  blocks = dim3((n_cols + TX - 1) / TX, chunks, n_blocks);
  return true;
}

template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
int launch_affine_ext_2d(const void* const* ins, void* const* outs, const int* edges,
                         int n_blocks, const int* ints, const double* doubles, void* stream) {
  dim3 blocks;
  if (!affine_ext_launch_grid<K, TX, NT, P, RP, CP>(ints, n_blocks, blocks)) {
    return cudaErrorInvalidValue;
  }
  AffineExtBlocks<ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const ST*>(ins[z]);
    io.out[z] = static_cast<ST*>(outs[z]);
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[4 * z + e];
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_ext_2d_kernel<T, K, TX, NT, P, MINB, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, ints[0], ints[1], ints[2], ints[3], ints[4], make_affine_row_step<T>(doubles));
  return cudaGetLastError();
}

// -- the ext kernel's side inputs (TPU kernel #12's bc_specs, A9.3) ------------------
//
// The ext kernel's march with the serial side-input kernel's ghosts, on the
// blocks of a decomposed grid: every block reads the side tables of the
// GLOBAL grid (the host's AffineSides, made once per window) at its own
// origin, where pde_tpu slices a copy of them per shard
// (pde_tpu/parallel/fused.py:197-215). A column side's table is the serial
// one (grid row g at arr[g + kSidePad]); a block's window row w is its local
// row r0 - K + w, grid row origin_row + r0 - K + w. A row side's table is
// padded by kSidePad columns at either end (wrapped on periodic columns, the
// edge values repeated otherwise), and a window column's offset in a buffer
// row is its local column plus the halo, so the column's entry is
// arr[off + origin_col - halo + kSidePad]; a column the march does not load
// (offset 0) reads an entry that feeds only cells no output depends on. The
// t-table is the pass's, shared by the blocks. At a non-periodic global edge
// the entries past the grid feed only halo cells that the edge flags hold
// out of the domain, as in pde_tpu. The ghosts take the serial kernel's
// operands in its order, so a decomposed run equals the serial side-input
// window bit for bit.
//
// Bound and design: the ext kernel's, plus the serial side-input kernel's
// loads in the edge threads. The side inputs have a kernel of their own, so
// the scalar ext kernel compiles as it did before them.

template <typename T>
struct AffineSideExtBlocks : AffineExtBlocks<T> {
  int origin[kMaxExtBlocks][2];  // the block's first row and column in the grid
};

template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_sides_ext_2d_kernel(AffineSideExtBlocks<ST> io, int n_rows, int n_cols,
                                       int halo, int ld, int chunk, AffineRowStep<T> st,
                                       const __grid_constant__ AffineSides<T> sides) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * TX;
  ExtRows<RP, CP> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - K;
  geo.c0 = c0 - K;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - K;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const int edge_lo = RP || !geo.e[0] ? kNoRow : K - r0;
  const int edge_hi = RP || !geo.e[1] ? kNoRow : n_rows - 1 + K - r0;
  const int rows = min(chunk, n_rows - r0) + 2 * K;
  // window row w is grid row origin_row + r0 - K + w
  const int side_base = io.origin[z][0] + r0 - K + kSidePad;
  const int col_shift = io.origin[z][1] - halo + kSidePad;
  if (st.isotropic) {
    AffineRowMarch<kIsotropic, T, K, TX, NT, P, RP, CP, ExtRows<RP, CP>, kExtSides, ST> march(
        geo, st, io.in[z], io.out[z], smem, rows, edge_lo, edge_hi, {}, 0, &sides, side_base,
        col_shift);
    march.run();
  } else {
    AffineRowMarch<kAnisotropic, T, K, TX, NT, P, RP, CP, ExtRows<RP, CP>, kExtSides, ST> march(
        geo, st, io.in[z], io.out[z], smem, rows, edge_lo, edge_hi, {}, 0, &sides, side_base,
        col_shift);
    march.run();
  }
}

// Launches one K-step ext pass with side inputs over n_blocks blocks, as
// launch_affine_ext_2d: `edges` holds 6 host ints per block, its 4 edge
// flags then its first row and column in the grid; `arrays` 4 device
// pointers (AffineSides::arr, nullptr where a side has none; a row side's
// table padded by kSidePad columns, a column side's by kSidePad rows);
// `doubles` 16 + 4K host doubles, make_affine_row_step's 16 then the pass's
// t-table, row by row.
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP, typename ST = T>
int launch_affine_sides_ext_2d(const void* const* ins, void* const* outs, const int* edges,
                               int n_blocks, const void* const* arrays, const int* ints,
                               const double* doubles, void* stream) {
  dim3 blocks;
  if (arrays == nullptr || !affine_ext_launch_grid<K, TX, NT, P, RP, CP>(ints, n_blocks, blocks) ||
      ints[2] > kSidePad) {
    return cudaErrorInvalidValue;
  }
  AffineSideExtBlocks<ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const ST*>(ins[z]);
    io.out[z] = static_cast<ST*>(outs[z]);
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[6 * z + e];
    io.origin[z][0] = edges[6 * z + 4];
    io.origin[z][1] = edges[6 * z + 5];
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_sides_ext_2d_kernel<T, K, TX, NT, P, MINB, RP, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, ints[0], ints[1], ints[2], ints[3], ints[4], make_affine_row_step<T>(doubles),
      make_affine_sides<T, K>(arrays, doubles, 16));
  return cudaGetLastError();
}

// -- the radial mode's ext kernel (TPU kernel #12's radial mode) --------------------
//
// The radial kernel's march on the blocks of a decomposed cylindrical grid
// (rows r, never periodic; columns z, periodic or not: CP), read from their
// extended buffers as the ext kernel reads them. A row's factors are the
// serial kernel's: the host's table of the GLOBAL grid's rows (radial_rows of
// ops/cuda_cartesian.py, kRadialPad rows either side), read at the block's
// global first row plus the local row, as pde_tpu's kernel computes them at
// flags[4] + local row. A window row past the block is a neighbour's row,
// whose factors are in the table; one past the global edge falls in the pad
// (finite factors), and the edge flags hold it out of the domain and form
// the ghosts there as the serial kernel does at its edge rows. So a
// decomposed run takes the serial run's operands and factors at every cell
// and equals it bit for bit.
//
// Bound and design: the serial radial kernel's (above). The blocks' table
// gains one int per block, its global first row; the Cartesian ext kernel's
// parameters stay as they were.

template <typename T>
struct AffineRadialExtBlocks : AffineExtBlocks<T> {
  int row0[kMaxExtBlocks];  // the block's first row in the grid
};

template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_radial_ext_2d_kernel(AffineRadialExtBlocks<ST> io, int n_rows, int n_cols,
                                        int halo, int ld, int chunk, AffineRowStep<T> st,
                                        AffineRadial<T> rad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * TX;
  ExtRows<false, CP> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - K;
  geo.c0 = c0 - K;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - K;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const int edge_lo = !geo.e[0] ? kNoRow : K - r0;
  const int edge_hi = !geo.e[1] ? kNoRow : n_rows - 1 + K - r0;
  // window row w is local row r0 - K + w, grid row io.row0[z] + r0 - K + w,
  // whose factors are kRadialPad rows into the table past it
  AffineRowMarch<kRadial, T, K, TX, NT, P, false, CP, ExtRows<false, CP>, kNoSides, ST> march(
      geo, st, io.in[z], io.out[z], reinterpret_cast<T*>(smem_raw),
      min(chunk, n_rows - r0) + 2 * K, edge_lo, edge_hi, rad,
      io.row0[z] + r0 - K + kRadialPad);
  march.run();
}

// Launches one K-step ext pass of the radial mode over n_blocks blocks, as
// launch_affine_ext_2d (the rows not periodic); `edges` holds 5 host ints per
// block, its 4 edge flags and its global first row; `rows` the device table
// of the factors of the global grid rows -kRadialPad .. n_grid_rows +
// kRadialPad - 1 (radial_rows); `doubles` 18 host doubles, as
// launch_affine_radial_2d's.
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
int launch_affine_radial_ext_2d(const void* const* ins, void* const* outs, const int* edges,
                                int n_blocks, const void* rows, const int* ints,
                                const double* doubles, void* stream) {
  dim3 blocks;
  if (rows == nullptr || !affine_ext_launch_grid<K, TX, NT, P, false, CP>(ints, n_blocks, blocks)) {
    return cudaErrorInvalidValue;
  }
  AffineRadialExtBlocks<ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const ST*>(ins[z]);
    io.out[z] = static_cast<ST*>(outs[z]);
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[5 * z + e];
    io.row0[z] = edges[5 * z + 4];
    if (io.row0[z] < 0) return cudaErrorInvalidValue;
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_radial_ext_2d_kernel<T, K, TX, NT, P, MINB, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]),
                            static_cast<const RadialRow<T>*>(rows)};
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, ints[0], ints[1], ints[2], ints[3], ints[4], make_affine_row_step<T>(doubles), rad);
  return cudaGetLastError();
}

// -- the radial modes' side inputs on the blocks (TPU kernel #12's radial= with
// bc_specs=) -------------------------------------------------------------------------
//
// The radial ext kernel's march with the side-input ext kernel's ghosts: a
// block's six ints are its four edge flags and its first row and column in
// the grid (AffineSideExtBlocks); the first row places the block's rows both
// in the radial table of the global grid (rad.rows, kRadialPad rows either
// side) and in the column sides' tables (kSidePad rows either side), the
// first column places its columns in the row sides' tables (kSidePad columns
// either side). Every operand and factor is the serial radial side-input
// kernel's, so a decomposed run equals the serial run bit for bit.
//
// Bound and design: the radial ext kernel's, plus the side-input kernel's
// loads in the edge threads; a kernel of its own, so that the radial and
// side-input ext kernels compile as they did before it.

template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_radial_sides_ext_2d_kernel(AffineSideExtBlocks<ST> io, int n_rows, int n_cols,
                                              int halo, int ld, int chunk, AffineRowStep<T> st,
                                              AffineRadial<T> rad,
                                              const __grid_constant__ AffineSides<T> sides) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * TX;
  ExtRows<false, CP> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - K;
  geo.c0 = c0 - K;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - K;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = io.edge[z][e] != 0;
  const int edge_lo = !geo.e[0] ? kNoRow : K - r0;
  const int edge_hi = !geo.e[1] ? kNoRow : n_rows - 1 + K - r0;
  // window row w is grid row io.origin[z][0] + r0 - K + w
  const int row = io.origin[z][0] + r0 - K;
  AffineRowMarch<kRadial, T, K, TX, NT, P, false, CP, ExtRows<false, CP>, kExtSides, ST> march(
      geo, st, io.in[z], io.out[z], reinterpret_cast<T*>(smem_raw),
      min(chunk, n_rows - r0) + 2 * K, edge_lo, edge_hi, rad, row + kRadialPad, &sides,
      row + kSidePad, io.origin[z][1] - halo + kSidePad);
  march.run();
}

// Launches one K-step ext pass of the radial mode with side inputs over
// n_blocks blocks, as launch_affine_radial_ext_2d: `edges` holds 6 host ints
// per block, its 4 edge flags then its first row and column in the grid;
// `rows` the global grid's radial table; `arrays` 4 device pointers (a row
// side's table padded by kSidePad columns, a column side's by kSidePad rows);
// `doubles` 18 + 4K host doubles, as launch_affine_radial_sides_2d's.
template <typename T, int K, int TX, int NT, int P, int MINB, bool CP, typename ST = T>
int launch_affine_radial_sides_ext_2d(const void* const* ins, void* const* outs,
                                      const int* edges, int n_blocks, const void* rows,
                                      const void* const* arrays, const int* ints,
                                      const double* doubles, void* stream) {
  dim3 blocks;
  if (rows == nullptr || arrays == nullptr ||
      !affine_ext_launch_grid<K, TX, NT, P, false, CP>(ints, n_blocks, blocks) ||
      ints[2] > kSidePad) {
    return cudaErrorInvalidValue;
  }
  AffineSideExtBlocks<ST> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const ST*>(ins[z]);
    io.out[z] = static_cast<ST*>(outs[z]);
    for (int e = 0; e < 4; ++e) io.edge[z][e] = edges[6 * z + e];
    io.origin[z][0] = edges[6 * z + 4];
    io.origin[z][1] = edges[6 * z + 5];
    if (io.origin[z][0] < 0 || io.origin[z][1] < 0) return cudaErrorInvalidValue;
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_radial_sides_ext_2d_kernel<T, K, TX, NT, P, MINB, CP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]),
                            static_cast<const RadialRow<T>*>(rows)};
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, ints[0], ints[1], ints[2], ints[3], ints[4], make_affine_row_step<T>(doubles), rad,
      make_affine_sides<T, K>(arrays, doubles, 18));
  return cudaGetLastError();
}

// -- the 9-point corner-weight mode (kernels #1 and #12) ------------------------------
//
// The TPU kernels' lowering of the config key
// operators.cartesian.laplacian_2d_corner_weight = w (pde_tpu/ops/
// pallas_cartesian.py:1096-1108; w = 1/2 Oono-Puri, w = 1/3 Patra-Karttunen)
// on fully periodic grids, k <= 8 steps a pass (their gate):
//     lap9 = (1-w) sx (up + down) + (1-w) sy (left + right)
//          + w/4 (sx + sy) (ul + ur + dl + dr) + (w - 2)(sx + sy) centre,
//     f <- a*centre + b*lap9.
// The diagonal neighbours are the column neighbours of the rows above and
// below, so the march keeps, beside each level's own column (three
// registers), h = left + right of its rows (three registers more): the
// diagonal sum of a cell is h(up) + h(down), values the thread formed itself
// when it read those rows' neighbours. A row's h is read from shared memory
// one iteration after the row was written, so each level lags the one below
// by two rows, not one: in iteration t level L computes level L + 1 of row
// w = t - 2L - 2 from its rows w - 1, w, w + 1, reading only row w + 1 from
// shared memory (the slot written in iteration t - 1; the ring stays two
// rows a level). The levels run from the top down, and level 0 of row t
// enters last, so that a ring of three registers holds each level's rows:
// a level is read before the level below overwrites its oldest row. The
// march takes rows + K iterations (the last K rows finish the wavefront);
// the unroll period stays 6. One shared read pair and one store a
// cell-step, as in the 5-point march. Both kernels call corner_update_2d, so
// a row-cut decomposed run equals the serial run bit for bit. This mode has
// kernels and libraries of their own: the 5-point instantiations compile as
// they did without it.

// A 9-point step's coefficients in the working type: a, b, then (1-w) sx,
// (1-w) sy, w/4 (sx + sy) and (w - 2)(sx + sy), computed in double on the host
// (step_doubles of ops/cuda_cartesian.py, as pde_tpu forms them).
template <typename T>
struct CornerStep {
  T a, b, cud, clr, cdg, cc;
};

// From 20 host doubles: make_affine_row_step's 16, then the four factors.
template <typename T>
CornerStep<T> make_corner_step(const double* d) {
  return CornerStep<T>{T(d[0]), T(d[1]), T(d[16]), T(d[17]), T(d[18]), T(d[19])};
}

// The one per-cell update of both 9-point kernels, in the order of the plain
// version (_update of ops/cuda_cartesian.py): h is left + right of the
// centre's row, hu and hd those of the rows above and below.
template <typename T>
__device__ __forceinline__ T corner_update_2d(const CornerStep<T>& st, T center, T up, T down,
                                              T h, T hu, T hd) {
  const T lap9 = st.cud * (up + down) + st.clr * h + st.cdg * (hu + hd) + st.cc * center;
  return st.a * center + st.b * lap9;
}

// One block's 9-point march on a fully periodic window geometry: `rows`
// window rows (the chunk's output rows plus K at each end), P rows of level 0
// in flight.
template <typename T, int K, int TX, int NT, int P, class Geo>
struct CornerRowMarch {
  using S = AffineRowShape<T, K, TX, NT>;
  static constexpr int M = S::kCols, WX = S::kWX, PERIOD = S::kPeriod;
  static_assert(PERIOD % P == 0, "the prefetch ring must divide the unroll period");
  static_assert(PERIOD % 3 == 0 && PERIOD % S::kSlots == 0, "constant rings need the period");

  Geo& geo;
  const CornerStep<T>& st;
  const T* __restrict__ in;
  T* __restrict__ out;
  T* const smem;
  const int tid, rows;
  int off[M];
  unsigned flags[M];
  T lv[K][3][M];  // level s of window row y at column q: lv[s][y % 3]
  T hv[K][3][M];  // left + right of level s of window row y: hv[s][y % 3]
  T next[P][M];   // level 0 of the rows in flight: row y in next[y % P]

  __device__ __forceinline__ CornerRowMarch(Geo& geo_, const CornerStep<T>& st_, const T* in_,
                                            T* out_, T* smem_, int rows_)
      : geo(geo_), st(st_), in(in_), out(out_), smem(smem_), tid(threadIdx.x), rows(rows_) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = tid + m * NT;
      off[m] = 0;
      flags[m] = 0u;
      if (q < WX) {
        const RowColumn c = geo.column(q, q >= K && q < WX - K);
        off[m] = c.off;
        flags[m] = c.flags;
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          lv[s][j][m] = T(0);
          hv[s][j][m] = T(0);
        }
      }
    }
  }

  template <int LEVEL, int Y>
  __device__ __forceinline__ T* slot() const {
    return smem + (LEVEL * S::kSlots + residue(Y, S::kSlots)) * S::kRow + 1;
  }

  __device__ __forceinline__ void load_row(T (&v)[M]) {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[m] = T(0);
      if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[m] = in[pl.off + off[m]];
    }
  }

  // level L in iteration t (residue R), then the levels below it: level
  // L + 1 of window row t - 2L - 2
  template <int R, int L>
  __device__ __forceinline__ void level(int t, long long out_row) {
    if constexpr (L >= 0) {
      constexpr int w = R - 2 * L - 2;  // the residue of the centre row
      const T* row = slot<L, w + 1>();  // level L of row w + 1, written in iteration t - 1
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = tid + m * NT;
        const T hd = row[q - 1] + row[q + 1];
        hv[L][residue(w + 1, 3)][m] = hd;
        const T x = corner_update_2d(st, lv[L][residue(w, 3)][m], lv[L][residue(w - 1, 3)][m],
                                     lv[L][residue(w + 1, 3)][m], hv[L][residue(w, 3)][m],
                                     hv[L][residue(w - 1, 3)][m], hd);
        if constexpr (L + 1 < K) {
          lv[L + 1][residue(w, 3)][m] = x;
          slot<L + 1, w>()[q] = x;  // level L + 1 of row w, for its column neighbours
        } else if (t >= 3 * K && (flags[m] & kOut)) {
          out[out_row + off[m]] = x;
        }
      }
      level<R, L - 1>(t, out_row);
    }
  }

  // iteration t (residue R): the levels from the top down, then level 0 of
  // window row t
  template <int R>
  __device__ __forceinline__ void advance(int t) {
    const long long out_row = geo.row(t - 2 * K).off;  // meaningful once t >= 3K
    level<R, K - 1>(t, out_row);
    T* dst = slot<0, R>();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      lv[0][residue(R, 3)][m] = next[R % P][m];
      dst[tid + m * NT] = next[R % P][m];
    }
    if (t + P < rows) load_row(next[R % P]);
    __syncthreads();
  }

  template <int U>
  __device__ __forceinline__ void iterate(int t0) {
    if constexpr (U < PERIOD) {
      const int t = t0 + U;
      if (t >= rows + K) return;
      advance<U>(t);
      iterate<U + 1>(t0);
    }
  }

  __device__ __forceinline__ void run() {
#pragma unroll
    for (int p = 0; p < P; ++p) load_row(next[p]);  // rows >= 2K + 1 >= P
    for (int t0 = 0; t0 < rows + K; t0 += PERIOD) iterate<0>(t0);
  }
};

// Kernel #1's 9-point mode on a fully periodic grid.
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_corner_2d_kernel(const T* __restrict__ in, T* __restrict__ out, int n_rows,
                                    int n_cols, int chunk, CornerStep<T> st) {
  static_assert(RP && CP, "the 9-point mode takes fully periodic grids");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<true, true> geo(n_rows, n_cols, r0 - K, c0 - K);
  CornerRowMarch<T, K, TX, NT, P, GridRows<true, true>> march(
      geo, st, in, out, reinterpret_cast<T*>(smem_raw), min(chunk, n_rows - r0) + 2 * K);
  march.run();
}

// Launches one K-step pass of the 9-point mode, as launch_affine_2d; `doubles`
// holds 20 host doubles (make_corner_step).
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP>
int launch_affine_corner_2d(const void* in, void* out, const int* ints, const double* doubles,
                            void* stream) {
  dim3 blocks;
  if (!affine_launch_grid<K, TX, NT, P, RP, CP>(ints, blocks)) return cudaErrorInvalidValue;
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_corner_2d_kernel<T, K, TX, NT, P, MINB, RP, CP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), ints[0], ints[1], ints[2],
      make_corner_step<T>(doubles));
  return cudaGetLastError();
}

// Kernel #12's 9-point mode: the march above on the extended blocks of a
// fully periodic grid cut along its rows (pde_tpu's gate; the port's
// exchange fills both axes' halos, so the kernel reads every neighbour from
// the buffer).
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP>
__global__ void __launch_bounds__(NT, MINB)
    affine_laplace_corner_ext_2d_kernel(AffineExtBlocks<T> io, int n_rows, int n_cols, int halo,
                                        int ld, int chunk, CornerStep<T> st) {
  static_assert(RP && CP, "the 9-point mode takes fully periodic grids");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
  const int c0 = blockIdx.x * TX;
  ExtRows<true, true> geo;
  geo.n_rows = n_rows;
  geo.n_cols = n_cols;
  geo.r0 = r0 - K;
  geo.c0 = c0 - K;
  geo.h = halo;
  geo.ld = ld;
  geo.next = r0 - K;
#pragma unroll
  for (int e = 0; e < 4; ++e) geo.e[e] = false;
  CornerRowMarch<T, K, TX, NT, P, ExtRows<true, true>> march(
      geo, st, io.in[z], io.out[z], reinterpret_cast<T*>(smem_raw),
      min(chunk, n_rows - r0) + 2 * K);
  march.run();
}

// Launches one K-step ext pass of the 9-point mode, as launch_affine_ext_2d
// (`edges`: 4 zero ints per block); `doubles` holds 20 host doubles.
template <typename T, int K, int TX, int NT, int P, int MINB, bool RP, bool CP>
int launch_affine_corner_ext_2d(const void* const* ins, void* const* outs, const int* edges,
                                int n_blocks, const int* ints, const double* doubles,
                                void* stream) {
  dim3 blocks;
  if (!affine_ext_launch_grid<K, TX, NT, P, RP, CP>(ints, n_blocks, blocks)) {
    return cudaErrorInvalidValue;
  }
  AffineExtBlocks<T> io;
  for (int z = 0; z < n_blocks; ++z) {
    io.in[z] = static_cast<const T*>(ins[z]);
    io.out[z] = static_cast<T*>(outs[z]);
    for (int e = 0; e < 4; ++e) {
      io.edge[z][e] = edges[4 * z + e];
      if (io.edge[z][e] != 0) return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = AffineRowShape<T, K, TX, NT>::kSmem;
  auto kernel = affine_laplace_corner_ext_2d_kernel<T, K, TX, NT, P, MINB, RP, CP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, ints[0], ints[1], ints[2], ints[3], ints[4], make_corner_step<T>(doubles));
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
