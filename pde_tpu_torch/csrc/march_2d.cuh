// Temporally blocked k-step window of an arbitrary stencil rhs over n coupled
// 2D fields, for Hopper (sm_90a): a row-marching wavefront, the 2D
// counterpart of march_program_3d (multi_stencil_3d.cuh). Hand-written
// template; the per-rhs part is generated by pde_tpu_torch/ops/cuda_stencil_2d.py
// (serial grids) and pde_tpu_torch/ops/cuda_ext_2d.py (the extended blocks of
// decomposed grids).
//
// Replaces two TPU kernels of pde_tpu/ops/pallas_cartesian.py that compute
// the same function, k explicit Euler steps of one rhs over n field planes:
// `make_fused_multi_stencil_window_2d` (row bands of whole planes) and
// `make_fused_multi_ext_window_2d` (on halo-extended blocks, int32 edge
// flags). The rhs is built from 5-point Laplacians, squared gradients,
// central derivatives and pointwise math (Cahn-Hilliard, Ginzburg-Landau,
// Brusselator, ...).
//
// What the generated program supplies, as a struct P. One Euler step of a
// program of depth D is P::kStages stages: the operand buffers (each stencil
// operand that is not a bare field), grouped by the stencil hops they take
// from the fields, then the next level of every field. A step's volumes are
// its fields (volumes 0 .. kFields - 1) and its buffers.
//   P::kFields, P::kVolumes, P::kDepth, P::kStages, P::kStepSlots;
//   P::kRowsPeriodic, P::kColsPeriodic  the grid's periodicity;
//   P::stage_lag(j)     the rows stage j lags the step's fields (its reach:
//                       the hops it takes; the last stage's is kDepth);
//   P::stage_out(j), P::stage_width(j)  the volumes stage j writes (the last
//                       stage: the fields of the next step);
//   P::volume_slots(v), P::volume_base(v)  the shared-memory rows of volume v
//                       (each stage's reads and lags, reckoned by the
//                       emitter) and the first of them in a step's slots;
//   P::stage<J>(O, q, cf, rf, out)  the per-cell function of stage J: from
//                       the operand rows O (per volume, its rows w - 1, w,
//                       w + 1 at window column q; column neighbours at
//                       q -+ 1), the column flags cf and the row flags rf, the
//                       stage's values into out. Stencil reads substitute the
//                       affine ghost (c + f1*edge + f2*next_inward) of the
//                       operand itself where a flag says the cell is next to a
//                       side with ghosts. Both kernels call the same
//                       functions, so a decomposed run equals the serial run
//                       bit for bit whatever FMA contraction nvcc chooses.
//   P::kRowValues       only in a program with values of a row (the radial
//                       helpers on a cylindrical grid, rows r; the serial
//                       kernel only): that many values of each grid row, in a
//                       device table the march reads once a row (the same
//                       address for every thread of a block; a thread holds
//                       one window column, so a value each thread computed
//                       for its row would be computed once a cell) into O.rv.
//                       The table holds at least K * kDepth rows more on each
//                       side (the host pads it by its deepest pass's halo),
//                       so that no read needs a test; one base pointer a row
//                       serves every stage, each at a constant offset.
//   P::kSideInputs, P::kSidePad, P::side_axis(i), P::side_step(i)  only in a
//                       program whose
//                       ghosts read side inputs (B2(b); the serial kernel
//                       only): per-point consts and factors of a side, and
//                       values per step (and RK4 stage) of time-dependent
//                       ones, from device tables the host fills (a row
//                       side's along the columns, a column side's along the
//                       rows, each padded by kSidePad cells before the grid
//                       and kSidePad + 256 after it; a step's row `step`
//                       elements after the last's: side_step(i), or where it
//                       is -1 (a table along a side that varies in time) the
//                       host's stride). side_axis(i) says where input i is
//                       read: 0 one value a step, 1 at the cell's column
//                       (O.sp[i][q]), 2 at the row's (O.sp[i][0]); the march
//                       points O.sp[i] at the step's row, the block's first
//                       window column or the row's entry, from the tables'
//                       pointers by value (kernel parameters).
//
// Design. A block of NT threads owns an output strip of TX columns and a
// chunk of rows, and marches down the chunk plus H = K * D rows of halo at
// each end; the strip carries H columns of halo on each side, so a window
// row holds WX = TX + 2H cells. Threads hold window columns dealt linearly
// (column q = thread + m * NT), so neighbouring threads hold neighbouring
// columns and only the row's last lanes idle. Each thread computes once, at
// the start, each column's offset in a row of the buffer (periodic columns
// wrapped there, once), its depth in the window and its flags; the rows read
// advance by an increment and a compare. Iteration t brings level 0 of window
// row t (loaded one row ahead, into registers), then, for each step s and
// stage j, computes row t - L of that stage, L = s * D + stage_lag(j): each
// stage lags its operands by at least one row where it reads them through a
// stencil, so the rows it needs exist, and it reads other threads' cells (the
// column neighbours) only on rows written in an earlier iteration. One
// barrier per iteration. A stage computes the columns of depth L and more
// (its valid region); cells outside the domain get zero. Each stored volume
// (the fields at each level below K, each buffer at each step) keeps its rows
// in a ring of volume_slots(v) shared-memory rows, as many as the rows between
// its newest and the oldest its readers still need, so no store overwrites a
// row read in the same iteration. Level K goes from registers to device
// memory.
//
// Choices, each timed against the others by scripts/torch_multi2d_sweep.py on
// the H100 (PERF.md):
// - The row loop is unrolled by S::period(), the least common multiple of the
//   rings' lengths, so that every slot a stage touches is a constant offset:
//   with the slot computed per read (a remainder per row and volume) the
//   integer work outnumbered the arithmetic and a pass took 1.6-1.8x as long
//   (two calls on the same card model).
// - One window column a thread (two: within 1 %), strips of 256 columns (128:
//   7-11 % slower).
// - Level 0 through registers: cp.async straight into the slot (one ring row
//   more for the fields of step 0) ran 5-10 % slower at the production passes
//   (2 % faster only at Cahn-Hilliard k = 8).
// - The chunk of rows a block marches is the caller's (chunk_rows of
//   ops/cuda_stencil_2d.py: the longest that gives two blocks per SM; 4096^2:
//   128 rows, where 256 rows ran 9 % slower and 512 rows 80 %; floored at 16
//   rows for small grids, 1024^2: 16 rows beat 8 and 32).
//
// bf16 storage (ROADMAP B1(f)): pde_tpu's #8 takes bf16 planes where the mesh
// cuts the columns (pde_tpu/ops/pallas_cartesian.py:4121-4127). The ext
// kernels take a storage type ST last (T by default): with ST =
// __nv_bfloat16 and T = float (a generated source that includes cuda_bf16.h)
// they load and store bf16 through its conversions, and the generated
// program's last stage rounds each field's next level to bf16 (an RK4 step's
// stage values stay float; an AB2 window's rate planes are fields, so bf16
// too). Their libraries are of their own, built as the float ones are.
//
// What bounds it on this card. One pass reads and writes every field once,
// so device-memory bytes per cell-update fall as 1/K; a block keeps a few
// rows per volume in shared memory, not a (TX + 2H)^2 window per plane. The
// instructions issued per cell-step then set the pace: the rhs's arithmetic
// on the recomputed halo (a factor (TX + 2H) / TX along columns and
// 1 + 2H / chunk along rows), the shared-memory reads of its stencils, and the
// lag and domain tests. Past K = 4 (Cahn-Hilliard) or 8 (one-step-deep rhs)
// the halo grows faster than the bytes fall.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace pde_tpu_torch {

// Local blocks one launch of the ext kernel covers (blockIdx.z runs over them).
constexpr int kMaxExtBlocks = 8;

// Flags of a window column or of a window row.
enum : unsigned {
  kLoad = 1u,       // read from the input buffer (else it enters as zero)
  kDomain = 2u,     // in the domain (else every level holds zero there)
  kLowEdge = 4u,    // the cell next to a low side with ghosts
  kHighEdge = 8u,   // ... next to a high side
  kOut = 16u,       // a column of the output strip that lies in the grid
};
constexpr int kDepthShift = 8;  // a column's depth in the window, plus one, above the flags

struct RowColumn {
  int off;  // offset of the column in a row of the buffer
  unsigned flags;
};

struct MarchRow {
  long long off;  // offset of the row in the buffer
  unsigned flags;
};

__device__ __forceinline__ int wrap_column(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The window geometry of one block of the serial kernel: window cell (0, 0)
// is grid cell (r0, c0); periodic axes wrap (columns once per column at the
// start, the rows read by increment), cells outside a non-periodic axis are
// outside the domain.
template <bool RP, bool CP>
struct GridRows {
  static constexpr bool kBounded = !(RP && CP);
  int n_rows, n_cols;
  int r0, c0;
  int next;  // global row of the next row load_next() reads
  int wrap;  // ... wrapped into the grid (periodic rows)

  __device__ __forceinline__ GridRows(int n_rows_, int n_cols_, int r0_, int c0_)
      : n_rows(n_rows_), n_cols(n_cols_), r0(r0_), c0(c0_), next(r0_),
        wrap(RP ? wrap_column(r0_, n_rows_) : 0) {}

  __device__ __forceinline__ RowColumn column(int q, bool tile) const {
    const int gc = c0 + q;
    RowColumn c{0, 0u};
    if (CP || (gc >= 0 && gc < n_cols)) {
      c.off = CP ? wrap_column(gc, n_cols) : gc;
      c.flags = kLoad | kDomain;
      if (!CP && gc == 0) c.flags |= kLowEdge;
      if (!CP && gc == n_cols - 1) c.flags |= kHighEdge;
      if (tile && gc < n_cols) c.flags |= kOut;
    }
    return c;
  }

  // the rows read, in order: window row t at the t-th call
  __device__ __forceinline__ MarchRow load_next() {
    MarchRow p{0, 0u};
    if (RP || (next >= 0 && next < n_rows)) {
      p.off = static_cast<long long>(RP ? wrap : next) * n_cols;
      p.flags = kLoad;
    }
    ++next;
    if (RP && ++wrap == n_rows) wrap = 0;
    return p;
  }

  // the grid row and column of window cell (0, 0), where the side inputs'
  // tables are read
  __device__ __forceinline__ int side_r0() const { return r0; }
  __device__ __forceinline__ int side_c0() const { return c0; }

  // a row computed, with its offset in the output (meaningful in the grid)
  __device__ __forceinline__ MarchRow row(int w) const {
    const int gr = r0 + w;
    MarchRow p{static_cast<long long>(gr) * n_cols, 0u};
    if (RP || (gr >= 0 && gr < n_rows)) {
      p.flags = kDomain;
      if (!RP && gr == 0) p.flags |= kLowEdge;
      if (!RP && gr == n_rows - 1) p.flags |= kHighEdge;
    }
    return p;
  }
};

// Whether local index g along an axis of n cells lies in the domain: only a
// flagged side has an outside, and a periodic axis (P) has none.
template <bool P>
__device__ __forceinline__ bool ext_in(int g, int n, bool lo_edge, bool hi_edge) {
  return P || ((!lo_edge || g >= 0) && (!hi_edge || g < n));
}

// The window geometry of one strip and chunk of one extended block: window
// cell (0, 0) is local cell (r0, c0); the buffer holds local cells [-h, n + h)
// of each axis, rows ld elements apart. A block's edge flags (row low, row
// high, column low, column high) stand where the serial geometry has the
// grid's non-periodic sides; cells past the buffer (beyond the output's light
// cone) enter as zero.
template <bool RP, bool CP>
struct ExtRows {
  static constexpr bool kBounded = !(RP && CP);
  int n_rows, n_cols;
  int r0, c0;
  int h, ld;
  bool e[4];
  int next;

  __device__ __forceinline__ RowColumn column(int q, bool tile) const {
    const int gc = c0 + q;
    RowColumn c{0, 0u};
    if (ext_in<CP>(gc, n_cols, e[2], e[3])) {
      c.flags = kDomain;
      if (gc < n_cols + h) {
        c.off = gc + h;
        c.flags |= kLoad;
      }
      if (!CP && e[2] && gc == 0) c.flags |= kLowEdge;
      if (!CP && e[3] && gc == n_cols - 1) c.flags |= kHighEdge;
      if (tile && gc < n_cols) c.flags |= kOut;
    }
    return c;
  }

  __device__ __forceinline__ MarchRow load_next() {
    MarchRow p{static_cast<long long>(next + h) * ld, 0u};
    if (ext_in<RP>(next, n_rows, e[0], e[1]) && next < n_rows + h) p.flags = kLoad;
    ++next;
    return p;
  }

  __device__ __forceinline__ MarchRow row(int w) const {
    const int gr = r0 + w;
    MarchRow p{static_cast<long long>(gr + h) * ld, 0u};
    if (ext_in<RP>(gr, n_rows, e[0], e[1])) {
      p.flags = kDomain;
      if (!RP && e[0] && gr == 0) p.flags |= kLowEdge;
      if (!RP && e[1] && gr == n_rows - 1) p.flags |= kHighEdge;
    }
    return p;
  }
};

// ExtRows of a block that reads the side inputs' tables of the global grid:
// its first row and column in the grid place its window there.
template <bool RP, bool CP>
struct ExtSideRows : ExtRows<RP, CP> {
  int row0, col0;
  __device__ __forceinline__ int side_r0() const { return row0 + this->r0; }
  __device__ __forceinline__ int side_c0() const { return col0 + this->c0; }
};

// A program's values of one row (NR of them; none in most programs), and its
// table of them, row-major by grid row.
template <typename T, int NR>
struct RowValues {
  T rv[NR];
};
template <typename T>
struct RowValues<T, 0> {};

template <typename T, int NR>
struct RowTable {
  const T* rows;
};
template <typename T>
struct RowTable<T, 0> {};

// A program's side inputs at one stage's row (NS of them; none in most
// programs): each input's values where the stage reads them (P::side_axis).
template <typename T, int NS>
struct SideOperands {
  const T* sp[NS];
};
template <typename T>
struct SideOperands<T, 0> {};

// The device tables of a program's side inputs: each input's first row for
// the pass and its stride from one step's row to the next (0: constant).
template <typename T, int NS>
struct SideTable {
  const T* p[NS];
  long long step[NS];
};
template <typename T>
struct SideTable<T, 0> {};

// The operand rows of one stage at window row w, per volume of the step: its
// rows w - 1 (lo), w (c) and w + 1 (hi), in shared memory; the program's
// values of row w (rv), where it has any; and its side inputs (sp), where it
// has any.
template <typename T, int NV, int NR = 0, int NS = 0>
struct RowOperands : RowValues<T, NR>, SideOperands<T, NS> {
  const T* lo[NV];
  const T* c[NV];
  const T* hi[NV];
};

// P::kRowValues where the program declares it, else 0.
template <class P, class = void>
struct RowValueCount : std::integral_constant<int, 0> {};
template <class P>
struct RowValueCount<P, std::void_t<decltype(P::kRowValues)>>
    : std::integral_constant<int, P::kRowValues> {};

// P::kSideInputs where the program declares it, else 0.
template <class P, class = void>
struct SideInputCount : std::integral_constant<int, 0> {};
template <class P>
struct SideInputCount<P, std::void_t<decltype(P::kSideInputs)>>
    : std::integral_constant<int, P::kSideInputs> {};

// The march of a program at K steps over strips of TX columns with NT
// threads: its window row and shared-memory rows.
template <class P, typename T, int K, int TX, int NT>
struct RowShape {
  static constexpr int kHalo = K * P::kDepth;
  static constexpr int kWX = TX + 2 * kHalo;
  static constexpr int kCols = (kWX + NT - 1) / NT;  // columns per thread
  static constexpr int kRows = K * P::kStepSlots;
  static constexpr size_t kSmem = size_t(kRows) * kWX * sizeof(T);

  // the least common multiple of every ring's length: rows this many apart
  // share their slots, so the march unrolls its row loop by it
  __host__ __device__ static constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }
  __host__ __device__ static constexpr int period() {
    int p = 1;
    for (int v = 0; v < P::kVolumes; ++v) p = p / gcd(p, P::volume_slots(v)) * P::volume_slots(v);
    return p;
  }
};

// One block's march: `geo` maps window cells to the buffers; `rows` window
// rows (the chunk's output rows plus H at each end). `in` and `out` hold the
// P::kFields planes, which share a layout, in the storage type ST (T, or
// __nv_bfloat16 with T = float: its conversions load and store them, and a
// bf16 program's last stage rounds the fields' next level to bf16). The row
// loop is unrolled by S::period(), the least common multiple of the rings'
// lengths, so that every slot a stage reads or writes is a constant offset
// into shared memory.
template <class P, typename T, int K, int TX, int NT, class Geo, typename ST = T>
struct RowMarch {
  using S = RowShape<P, T, K, TX, NT>;
  static constexpr int NF = P::kFields, NV = P::kVolumes, D = P::kDepth, H = K * D;
  static constexpr int NR = RowValueCount<P>::value;
  static constexpr int NS = SideInputCount<P>::value;
  static constexpr int M = S::kCols, WX = S::kWX;

  Geo& geo;
  const ST* const (&in)[NF];
  ST* const (&out)[NF];
  T* const smem;
  const RowTable<T, NR> table;  // the program's values of each row, where it has any
  const SideTable<T, NS> sides;  // its side inputs, where it has any
  const int tid;
  int off[M];
  unsigned flags[M];

  __device__ __forceinline__ RowMarch(Geo& geo_, const ST* const (&in_)[NF],
                                      ST* const (&out_)[NF], T* smem_, RowTable<T, NR> table_ = {},
                                      SideTable<T, NS> sides_ = {})
      : geo(geo_), in(in_), out(out_), smem(smem_), table(table_), sides(sides_),
        tid(threadIdx.x) {
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

  // volume v of step s, its slot for a window row of residue r (mod the
  // period); called with constant arguments, so it folds to a constant offset
  __device__ __forceinline__ T* slot(int s, int v, int r) const {
    const int n = P::volume_slots(v);
    return smem + (s * P::kStepSlots + P::volume_base(v) + (r % n + n) % n) * WX;
  }

  // level 0 of the next window row, into registers
  __device__ __forceinline__ void load_row(T (&v)[NF][M]) {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        v[f][m] = T(0);
        if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[f][m] = in[f][pl.off + off[m]];
      }
    }
  }

  // stage J of step SX in iteration t (residue R): row t - lag
  template <int R, int SX, int J>
  __device__ __forceinline__ void stage(int t) {
    constexpr int lag = SX * D + P::stage_lag(J);
    constexpr bool output = J + 1 == P::kStages;  // the next level of every field
    constexpr int first = P::stage_out(J), width = P::stage_width(J);
    constexpr int wr = R - lag;  // the residue of row w
    if (t < 2 * lag) return;  // row t - lag lies outside the stage's valid region
    const int w = t - lag;
    const MarchRow pl = geo.row(w);
    RowOperands<T, NV, NR, NS> ops;
    if constexpr (NR > 0) {  // the row's values, once a row
      const T* base = table.rows + (geo.r0 + t) * NR;  // window row t's: one for every stage
#pragma unroll
      for (int i = 0; i < NR; ++i) ops.rv[i] = base[i - lag * NR];
    }
    if constexpr (NS > 0) {  // the side inputs: step SX's row, at this block or row
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const long long step = P::side_step(i) >= 0 ? P::side_step(i) : sides.step[i];
        const T* p = sides.p[i] + SX * step;
        if (P::side_axis(i) == 1) p += P::kSidePad + geo.side_c0();
        if (P::side_axis(i) == 2) p += P::kSidePad + geo.side_r0() + w;
        ops.sp[i] = p;
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ops.lo[v] = slot(SX, v, wr - 1);
      ops.c[v] = slot(SX, v, wr);
      ops.hi[v] = slot(SX, v, wr + 1);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const unsigned f = flags[m];
      const int q = tid + m * NT;
      if ((f >> kDepthShift) <= unsigned(lag)) continue;
      T val[width];
      bool inside = true;
      if constexpr (Geo::kBounded) inside = (f & kDomain) && (pl.flags & kDomain);
      if (inside) {
        P::template stage<J>(ops, q, f, pl.flags, val);
      } else {
#pragma unroll
        for (int i = 0; i < width; ++i) val[i] = T(0);
      }
      if constexpr (output && SX + 1 == K) {
        if (f & kOut) {
#pragma unroll
          for (int i = 0; i < width; ++i) out[i][pl.off + off[m]] = val[i];
        }
      } else {
        constexpr int step = output ? SX + 1 : SX;
#pragma unroll
        for (int i = 0; i < width; ++i) slot(step, first + i, wr)[q] = val[i];
      }
    }
  }

  // every stage of every step, in order (I = step * kStages + stage)
  template <int R, int I>
  __device__ __forceinline__ void stages(int t) {
    if constexpr (I < K * P::kStages) {
      stage<R, I / P::kStages, I % P::kStages>(t);
      stages<R, I + 1>(t);
    }
  }

  // iteration t (residue R) with level 0 of row t in v0
  template <int R>
  __device__ __forceinline__ void advance(int t, const T (&v0)[NF][M]) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {  // level 0 of row t, for its readers
      T* dst = slot(0, f, R);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (flags[m] >> kDepthShift) dst[tid + m * NT] = v0[f][m];
      }
    }
    stages<R, 0>(t);
    __syncthreads();
  }

  // iterations t0 + U, t0 + U + 1, ... up to the period (t0 a multiple of it)
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
    T next[NF][M];  // level 0 of the row after, in flight (registers)
    load_row(next);
    for (int t0 = 0; t0 < rows; t0 += S::period()) iterate<0>(t0, rows, next);
  }
};

template <class P, typename T, int K, int TX, int NT, class Geo, typename ST>
__device__ __forceinline__ void march_program_2d(
    Geo& geo, const ST* const (&in)[P::kFields], ST* const (&out)[P::kFields], int rows,
    RowTable<T, RowValueCount<P>::value> table = {},
    SideTable<T, SideInputCount<P>::value> sides = {}) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowMarch<P, T, K, TX, NT, Geo, ST> march(geo, in, out, reinterpret_cast<T*>(smem_raw), table,
                                           sides);
  march.run(rows);
}

// The planes of a pass, and the program's row table (RowTable), where it has one.
template <typename T, int NF, int NR = 0>
struct RowFieldPtrs : RowTable<T, NR> {
  const T* in[NF];
  T* out[NF];
};

template <class P, typename T, int K, int TX, int NT>
__global__ void __launch_bounds__(NT)
    multi_stencil_2d_kernel(RowFieldPtrs<T, P::kFields, RowValueCount<P>::value> io, int n_rows,
                            int n_cols, int chunk) {
  constexpr int H = K * P::kDepth;
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<P::kRowsPeriodic, P::kColsPeriodic> geo(n_rows, n_cols, r0 - H, c0 - H);
  const T* in[P::kFields];
  T* out[P::kFields];
#pragma unroll
  for (int f = 0; f < P::kFields; ++f) {
    in[f] = io.in[f];
    out[f] = io.out[f];
  }
  march_program_2d<P, T, K, TX, NT>(geo, in, out, min(chunk, n_rows - r0) + 2 * H, io);
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ins` and `outs` are host arrays of
// P::kFields device pointers (`ins` then, in a program with values of a row,
// the device table of them: P::kRowValues a grid row, row-major, at grid row
// 0's, padded as P::kRowValues says); each block marches `chunk` output rows.
template <class P, typename T, int K, int TX, int NT>
int launch_2d(const void* const* ins, void* const* outs, int n_rows, int n_cols, int chunk,
              void* stream) {
  constexpr int NR = RowValueCount<P>::value;
  if (n_rows < 1 || n_cols < 1 || chunk < 1) return cudaErrorInvalidValue;
  const int strips = (n_cols + TX - 1) / TX;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  RowFieldPtrs<T, P::kFields, NR> io;
  for (int f = 0; f < P::kFields; ++f) {
    io.in[f] = static_cast<const T*>(ins[f]);
    io.out[f] = static_cast<T*>(outs[f]);
  }
  if constexpr (NR > 0) {
    io.rows = static_cast<const T*>(ins[P::kFields]);
    if (io.rows == nullptr) return cudaErrorInvalidValue;
  }
  constexpr size_t smem = RowShape<P, T, K, TX, NT>::kSmem;
  auto kernel = multi_stencil_2d_kernel<P, T, K, TX, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks), NT, smem, static_cast<cudaStream_t>(stream)>>>(io, n_rows, n_cols,
                                                                                chunk);
  return cudaGetLastError();
}

// The serial kernel of a program whose ghosts read side inputs (B2(b)): the
// same march, with the input tables' pointers and strides among the kernel's
// parameters.
template <typename T, int NF, int NR, int NS>
struct RowSidePtrs : RowFieldPtrs<T, NF, NR> {
  SideTable<T, NS> sides;
};

template <class P, typename T, int K, int TX, int NT>
__global__ void __launch_bounds__(NT) multi_stencil_sides_2d_kernel(
    RowSidePtrs<T, P::kFields, RowValueCount<P>::value, P::kSideInputs> io,
    int n_rows, int n_cols, int chunk) {
  constexpr int H = K * P::kDepth;
  const int r0 = blockIdx.y * chunk;  // first output row of this block
  const int c0 = blockIdx.x * TX;
  GridRows<P::kRowsPeriodic, P::kColsPeriodic> geo(n_rows, n_cols, r0 - H, c0 - H);
  const T* in[P::kFields];
  T* out[P::kFields];
#pragma unroll
  for (int f = 0; f < P::kFields; ++f) {
    in[f] = io.in[f];
    out[f] = io.out[f];
  }
  march_program_2d<P, T, K, TX, NT>(geo, in, out, min(chunk, n_rows - r0) + 2 * H, io,
                                    io.sides);
}

// Launches one K-step pass of a program with side inputs, as launch_2d:
// `sides` holds P::kSideInputs device pointers, each input's first row for
// the pass, and `steps` each one's stride from a step's row to the next
// (P::side_step(i) where it is not -1).
template <class P, typename T, int K, int TX, int NT>
int launch_sides_2d(const void* const* ins, void* const* outs, int n_rows, int n_cols, int chunk,
                    const void* const* sides, const long long* steps, void* stream) {
  constexpr int NR = RowValueCount<P>::value, NS = P::kSideInputs;
  if (n_rows < 1 || n_cols < 1 || chunk < 1 || sides == nullptr || steps == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int strips = (n_cols + TX - 1) / TX;
  const int chunks = (n_rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  RowSidePtrs<T, P::kFields, NR, NS> io;
  for (int f = 0; f < P::kFields; ++f) {
    io.in[f] = static_cast<const T*>(ins[f]);
    io.out[f] = static_cast<T*>(outs[f]);
  }
  if constexpr (NR > 0) {
    io.rows = static_cast<const T*>(ins[P::kFields]);
    if (io.rows == nullptr) return cudaErrorInvalidValue;
  }
  for (int i = 0; i < NS; ++i) {
    io.sides.p[i] = static_cast<const T*>(sides[i]);
    io.sides.step[i] = steps[i];
    if (io.sides.p[i] == nullptr || (P::side_step(i) >= 0 && steps[i] != P::side_step(i))) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = RowShape<P, T, K, TX, NT>::kSmem;
  auto kernel = multi_stencil_sides_2d_kernel<P, T, K, TX, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks), NT, smem, static_cast<cudaStream_t>(stream)>>>(io, n_rows,
                                                                                n_cols, chunk);
  return cudaGetLastError();
}

// -- the ext kernel ---------------------------------------------------------------
//
// The march above on the local blocks of a decomposed grid. Every field of a
// block lives in an extended buffer of shape (n_rows + 2*halo, n_cols +
// 2*halo), rows `ld` elements apart (ld >= n_cols + 2*halo, so that rows can
// start on 128-byte lines), whose halo ring the caller filled from the
// neighbouring blocks (halo >= K*kDepth); the window is read from it at offset
// halo around the block (ExtRows), with no index wrap, and the chunk is
// written into the interior of the output buffers. A block's edge flags
// replace the periodicity of the non-periodic axes: beyond a flagged side the
// cells are held at zero and the operands' affine ghosts are substituted
// (through the same column and row flags as in the serial kernel), elsewhere
// the halo is trusted. One launch covers up to kMaxExtBlocks blocks of one
// device: blockIdx.z indexes a table of pointers and flags. The buffers hold
// the storage type ST (bf16 storage: __nv_bfloat16 with T = float, each
// field's every level rounded to it by the program's last stage); the shared rows and the
// program's tables hold T.

template <typename T, int NF>
struct ExtRowPtrs {
  const T* in[kMaxExtBlocks][NF];
  T* out[kMaxExtBlocks][NF];
  int edge[kMaxExtBlocks][4];  // row_lo, row_hi, col_lo, col_hi
};

template <class P, typename T, int K, int TX, int NT, typename ST = T>
__global__ void __launch_bounds__(NT)
    multi_stencil_ext_2d_kernel(ExtRowPtrs<ST, P::kFields> io, int n_rows, int n_cols, int halo,
                                int ld, int chunk) {
  constexpr int H = K * P::kDepth;
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
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
  march_program_2d<P, T, K, TX, NT>(geo, in, out, min(chunk, n_rows - r0) + 2 * H);
}

// Launches one K-step ext pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of n_blocks * P::kFields buffer pointers (block
// major) whose rows are `ld` elements apart; `edges` holds 4 host ints per
// block; each block marches `chunk` output rows.
template <class P, typename T, int K, int TX, int NT, typename ST = T>
int launch_ext_2d(const void* const* ins, void* const* outs, const int* edges, int n_blocks,
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
  auto kernel = multi_stencil_ext_2d_kernel<P, T, K, TX, NT, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks, n_blocks), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, n_rows, n_cols, halo, ld, chunk);
  return cudaGetLastError();
}

// The ext kernel of a program whose ghosts read side inputs (A9.3, TPU
// kernel #8's bc_inputs): the ext march on ExtSideRows, every block reading
// the side tables of the GLOBAL grid (the serial kernel's, padded by
// P::kSidePad cells before the grid and past its end) at its own origin,
// where pde_tpu slices a copy of them per shard
// (pde_tpu/parallel/fused.py:476-516). A block's window cell (0, 0) is its
// local cell (r0 - H, c0 - H), grid cell (origin_row + r0 - H, origin_col +
// c0 - H); the tables' pointers and strides are the pass's, shared by the
// blocks. At a non-periodic global edge the entries past the grid feed only
// cells that the edge flags hold out of the domain. The stage functions are
// the serial kernel's, so a decomposed run equals the serial side-input
// window bit for bit; the kernel without side inputs compiles as before.
template <typename T, int NF, int NS, typename ST = T>
struct ExtSidePtrs : ExtRowPtrs<ST, NF> {
  int origin[kMaxExtBlocks][2];  // the block's first row and column in the grid
  SideTable<T, NS> sides;
};

template <class P, typename T, int K, int TX, int NT, typename ST = T>
__global__ void __launch_bounds__(NT)
    multi_stencil_sides_ext_2d_kernel(ExtSidePtrs<T, P::kFields, P::kSideInputs, ST> io,
                                      int n_rows, int n_cols, int halo, int ld, int chunk) {
  constexpr int H = K * P::kDepth;
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * chunk;  // first output row of this block (local)
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
  march_program_2d<P, T, K, TX, NT>(geo, in, out, min(chunk, n_rows - r0) + 2 * H, {},
                                    io.sides);
}

// Launches one K-step ext pass of a program with side inputs over n_blocks
// blocks, as launch_ext_2d: `edges` holds 6 host ints per block, its 4 edge
// flags then its first row and column in the grid; `sides` and `steps` the
// pass's tables as launch_sides_2d takes them.
template <class P, typename T, int K, int TX, int NT, typename ST = T>
int launch_ext_sides_2d(const void* const* ins, void* const* outs, const int* edges,
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
  auto kernel = multi_stencil_sides_ext_2d_kernel<P, T, K, TX, NT, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks, n_blocks), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      io, n_rows, n_cols, halo, ld, chunk);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
