// Temporally blocked k-step window of an arbitrary stencil rhs over n coupled
// 3D fields, for Hopper (sm_90a): an x-marching (2.5D) wavefront on the window
// geometry of march_3d.cuh. Hand-written template; the per-rhs part is
// generated by pde_tpu_torch/ops/cuda_stencil_3d.py (serial grids) and
// pde_tpu_torch/ops/cuda_ext_3d.py (the extended blocks of decomposed grids).
//
// Replaces three TPU kernels of pde_tpu/ops/pallas_cartesian.py that compute
// the same function, k explicit Euler steps of one rhs over n field volumes:
// `make_fused_multi_stencil_window_3d` (x bands of whole (y, z) planes),
// `_make_ychunk_multi_window_3d` (x bands by y chunks, for planes past 96 KB
// of VMEM; its `ext_x` mode on x-cut blocks) and
// `make_fused_multi_ext_window_3d` (on halo-extended blocks). The split
// between them is a VMEM matter; one march serves all of them. The rhs is
// built from 7-point Laplacians, squared gradients, central derivatives
// along x, y and z, and pointwise math (Allen-Cahn, Cahn-Hilliard,
// Brusselator, ...).
//
// What the generated program supplies, as a struct P. One Euler step of a
// program of depth D is P::kStages stages: the operand buffers (each stencil
// operand that is not a bare field), grouped by the stencil hops they take
// from the fields, then the next level of every field. A step's volumes are
// its fields (volumes 0 .. kFields - 1) and its buffers.
//   P::kFields, P::kVolumes, P::kDepth, P::kStages, P::kStepSlots;
//   P::kXPeriodic, P::kYPeriodic, P::kZPeriodic  the grid's periodicity;
//   P::stage_lag(j)     the planes stage j lags the step's fields (its reach:
//                       the hops it takes; the last stage's is kDepth);
//   P::stage_out(j), P::stage_width(j)  the volumes stage j writes (the last
//                       stage: the fields of the next step);
//   P::volume_slots(v), P::volume_base(v)  the shared-memory planes of
//                       volume v (each stage's reads and lags, reckoned by the
//                       emitter) and the first of them in a step's slots;
//   P::stage<J, WZ>(O, q, cf, pf, out)  the per-cell function of stage J:
//                       from the operand planes O (per volume, its planes
//                       w - 1, w, w + 1 at window cell q; y neighbours at
//                       q -+ WZ, z at q -+ 1), the column flags cf and the
//                       plane flags pf, the stage's values into out. Stencil
//                       reads substitute the affine ghost (c + f1*edge +
//                       f2*next_inward) of the operand itself where a flag
//                       says the cell is next to a face with ghosts. Both
//                       kernels call the same functions, so a decomposed run
//                       equals the serial run bit for bit whatever FMA
//                       contraction nvcc chooses.
//   P::kSideInputs, P::kSidePad, P::side_axis(i), P::side_step(i)  only in a
//                       program whose ghosts read side inputs (per-face
//                       values and factors, values and factors varying in
//                       time, values varying over a face and in time): their
//                       count; the cells each face table holds before the
//                       grid along each of its axes (the deepest pass's
//                       halo); each input's kind, 0 a value per step (and
//                       RK4 stage), 3, 4, 5 a face of x, y or z, its table
//                       over the other two axes, row-major (the host gives
//                       each table's line stride); and its stride from one
//                       step's table to the next (-1: the host's). The stage
//                       functions read input i's value at the cell as
//                       O.sv[i], which the side-input kernels load for a
//                       plane's columns with the plane, before its cells.
//   P::kInputs, P::kOutputs, P::kExtent  only in a pass of a cut step (one
//                       step a launch, K = 1): the volumes the pass reads
//                       (volumes 0 .. kInputs - 1: the step's fields, then
//                       the values of earlier passes it reads) and writes
//                       (its last stage's), where every other program reads
//                       and writes its kFields fields; and, in a pass of the
//                       ext kernel, the cells it computes past its block on
//                       every side (what the later passes of the step still
//                       read there; 0 in the serial kernel).
//
// Design. A block of kMarchThreads threads owns a TY x TZ column tile and a
// chunk of CX x planes and marches along x through the chunk plus H = K * D
// planes of x halo on each side; y and z carry H-deep halos. Iteration t
// brings level 0 of window plane t (from registers, loaded one plane ahead),
// then, for each step s and stage j, computes plane t - L of that stage, with
// L = s * D + stage_lag(j): each stage lags its operands by at least one
// plane where it reads them through a stencil, so the planes it needs
// exist, and it reads other threads' cells (the y and z neighbours) only on
// planes written in an earlier iteration. One barrier per iteration. A stage
// computes the columns of ring depth L and more (its valid region); cells
// outside the domain get zero. Each stored volume (the fields at each level
// below K, each buffer at each step) keeps its planes in a ring of
// volume_slots(v) shared-memory planes, as many as the planes between its
// newest and the oldest its readers still need, so no store overwrites a
// plane read in the same iteration. Level K goes from registers to device
// memory. Global offsets are 64-bit; a plane's offsets 32-bit.
//
// The passes of a cut step. An RK4 step of a two-deep rhs is eight planes of
// halo and 11-15 volumes in one march, whose rings fit one block an SM only
// (221 KB fp32) and whose eight stages wait on each other at every barrier;
// pde_tpu marches the whole step in one kernel (#5, #6). Here the step is
// cut at its RK stages into passes of their own (ops/cuda_stencil_3d.py's
// `cut_step`), each a one-step march of the rhs's depth: the rings of a pass
// fit two blocks an SM, its halo is the rhs's depth, and the values a later
// pass reads (k1, k2 and k1 + 2 k2, ...) go to device memory between passes.
// A pass's stages read its inputs, which differ from its outputs; stages of
// lag 0 compute the pointwise values of the inputs that a stencil reads (y +
// dt/2 k1). On a decomposed grid a step keeps its one exchange of 4 x depth
// cells: the ext kernel's pass i computes its block and kExtent cells around
// it (RegionGeo), what the passes after it still read there.

#pragma once

#include <type_traits>

#include "march_3d.cuh"

namespace pde_tpu_torch {

// A program's side inputs at one cell (NS of them; none in most programs).
template <typename T, int NS>
struct FaceValues {
  T sv[NS];
};
template <typename T>
struct FaceValues<T, 0> {};

// The operand planes of one stage at window plane w, per volume of the step:
// its planes w - 1 (lo), w (c) and w + 1 (hi), in shared memory; and the
// program's side inputs at the cell, where it has any.
template <typename T, int NV, int NS = 0>
struct MarchOperands : FaceValues<T, NS> {
  const T* lo[NV];
  const T* c[NV];
  const T* hi[NV];
};

// The device tables of a program's side inputs: each input's table for the
// pass, its stride from one step's table to the next and from one line of a
// face's table to the next, and the grid cell of the block's local cell
// (0, 0, 0) (zero in the serial kernel), where a block reads the tables.
template <typename T, int NS>
struct FaceTable {
  const T* p[NS];
  long long step[NS];
  long long row[NS];
  int origin[3];
};
template <typename T>
struct FaceTable<T, 0> {};

// A plane's side-input values at each of a thread's columns.
template <typename T, int NS, int M>
struct FaceLoads {
  T v[NS][M];
};
template <typename T, int M>
struct FaceLoads<T, 0, M> {};

// P::kSideInputs where the program declares it, else 0.
template <class P, class = void>
struct FaceInputCount : std::integral_constant<int, 0> {};
template <class P>
struct FaceInputCount<P, std::void_t<decltype(P::kSideInputs)>>
    : std::integral_constant<int, P::kSideInputs> {};

// P::kInputs and P::kOutputs where the program declares them (a pass of a
// cut step), else P::kFields both; P::kExtent likewise, else 0.
template <class P, class = void>
struct InputCount : std::integral_constant<int, P::kFields> {};
template <class P>
struct InputCount<P, std::void_t<decltype(P::kInputs)>>
    : std::integral_constant<int, P::kInputs> {};
template <class P, class = void>
struct OutputCount : std::integral_constant<int, P::kFields> {};
template <class P>
struct OutputCount<P, std::void_t<decltype(P::kOutputs)>>
    : std::integral_constant<int, P::kOutputs> {};
template <class P, class = void>
struct IsPass : std::false_type {};
template <class P>
struct IsPass<P, std::void_t<decltype(P::kExtent)>> : std::true_type {};
template <class P, class = void>
struct ExtentOf : std::integral_constant<int, 0> {};
template <class P>
struct ExtentOf<P, std::void_t<decltype(P::kExtent)>>
    : std::integral_constant<int, P::kExtent> {};

template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// The march of a program at K steps: its window and shared memory.
template <class P, typename T, int K, int TY, int TZ>
struct ProgramShape : MarchWindow<K * P::kDepth, TY, TZ> {
  using MarchWindow<K * P::kDepth, TY, TZ>::kPlane;
  static constexpr size_t kSmem = size_t(K) * P::kStepSlots * kPlane * sizeof(T);
};

// Blocks of a kernel resident on an SM, which caps its registers:
// P::kMinBlocks where the program declares it (a pass of a cut step), else
// `Default` (one for the kernels without side inputs; kSideMinBlocks for the
// side-input kernels, whose face values a plane's columns hold push them past
// two blocks' share otherwise).
constexpr int kSideMinBlocks = 2;
template <class P, int Default, class = void>
struct MinBlocks : std::integral_constant<int, Default> {};
template <class P, int Default>
struct MinBlocks<P, Default, std::void_t<decltype(P::kMinBlocks)>>
    : std::integral_constant<int, P::kMinBlocks> {};

// One block's march: `geo` maps window cells to the buffers; `planes` level-0
// planes (the chunk's output planes plus H per side). `in` holds the
// program's InputCount volumes and `out` its OutputCount volumes, each with
// the buffers' layout; `sides` the program's side inputs, where it has any.
template <class P, typename T, int K, int TY, int TZ, class Geo>
__device__ __forceinline__ void march_program_3d(
    const Geo& geo, const T* const (&in)[InputCount<P>::value],
    T* const (&out)[OutputCount<P>::value], int planes,
    FaceTable<T, FaceInputCount<P>::value> sides = {}) {
  constexpr int NI = InputCount<P>::value, NO = OutputCount<P>::value;
  constexpr int NV = P::kVolumes, D = P::kDepth, H = K * D;
  constexpr int NS = FaceInputCount<P>::value;
  static_assert(K == 1 || NI == NO, "a pass whose inputs are not its outputs takes one step");
  using S = ProgramShape<P, T, K, TY, TZ>;
  constexpr int M = S::kCols, WZ = S::kWZ, PLANE = S::kPlane, NT = kMarchThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;

  // volume v of step s, its slot for window plane w (w >= -1)
  auto slot = [&](auto s_, auto v_, int w) -> T* {
    constexpr int s = decltype(s_)::value, v = decltype(v_)::value;
    constexpr int n = P::volume_slots(v);
    return smem + (s * P::kStepSlots + P::volume_base(v) + (w + n) % n) * PLANE;
  };

  int off[M];
  unsigned flags[M];
  march_columns<H, TY, TZ>(geo, off, flags);

  auto load_plane = [&](int w, T(&v)[NI][M]) {  // level 0 of window plane w, into registers
    const MarchPlane pl = geo.load(w);
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int f = 0; f < NI; ++f) {
        v[f][m] = T(0);
        if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[f][m] = in[f][pl.off + off[m]];
      }
    }
  };

  auto advance = [&](int t, const T(&v0)[NI][M]) {
    static_for<0, NI>([&](auto f_) {  // level 0 of plane t, for its readers
      T* dst = slot(std::integral_constant<int, 0>{}, f_, t);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (flags[m] >> kDepthShift) dst[tid + m * NT] = v0[decltype(f_)::value][m];
      }
    });
    static_for<0, K>([&](auto s_) {
      constexpr int s = decltype(s_)::value;
      static_for<0, P::kStages>([&](auto j_) {
        constexpr int j = decltype(j_)::value;
        constexpr int lag = s * D + P::stage_lag(j);
        constexpr bool output = j + 1 == P::kStages;  // the next level of every field
        constexpr int first = P::stage_out(j), width = P::stage_width(j);
        if (t < 2 * lag) return;  // plane t - lag lies outside the stage's valid region
        const int w = t - lag;
        const MarchPlane pl = geo.plane(w);
        MarchOperands<T, NV, NS> ops;
        static_for<0, NV>([&](auto v_) {
          constexpr int v = decltype(v_)::value;
          ops.lo[v] = slot(s_, v_, w - 1);
          ops.c[v] = slot(s_, v_, w);
          ops.hi[v] = slot(s_, v_, w + 1);
        });
        FaceLoads<T, NS, M> fv;
        if constexpr (NS > 0) {
          // step s's side inputs at this plane's columns, loaded together
          // before any cell: a face's only where a cell next to it reads it
          const int gx = sides.origin[0] + geo.g0[0] + w + P::kSidePad;
          const int gy = sides.origin[1] + geo.g0[1] + P::kSidePad;
          const int gz = sides.origin[2] + geo.g0[2] + P::kSidePad;
          static_for<0, NS>([&](auto i_) {
            constexpr int i = decltype(i_)::value, kind = P::side_axis(i);
            const T* p = sides.p[i] + s * (P::side_step(i) >= 0 ? P::side_step(i) : sides.step[i]);
            if constexpr (kind == 0) {  // a value per step
              const T v = p[0];
#pragma unroll
              for (int m = 0; m < M; ++m) fv.v[i][m] = v;
            } else {
              // an x face's table line is the column's y; a y or z face's is the plane's x
              const T* line = kind == 3 ? p : p + static_cast<long long>(gx) * sides.row[i];
              const unsigned face = kind == 3 ? ((pl.flags & (kLowEdge | kHighEdge)) ? ~0u : 0u)
                                    : kind == 4 ? (kLowEdge | kHighEdge)
                                                : (kLowEdgeZ | kHighEdgeZ);
#pragma unroll
              for (int m = 0; m < M; ++m) {
                const unsigned f = flags[m];
                const int q = tid + m * NT;
                const int y = q / WZ, z = q - (q / WZ) * WZ;
                fv.v[i][m] = T(0);
                if ((f >> kDepthShift) > unsigned(lag) && (f & face)) {
                  if constexpr (kind == 3) {
                    fv.v[i][m] = line[static_cast<long long>(gy + y) * sides.row[i] + gz + z];
                  } else if constexpr (kind == 4) {
                    fv.v[i][m] = line[gz + z];
                  } else {
                    fv.v[i][m] = line[gy + y];
                  }
                }
              }
            }
          });
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const unsigned f = flags[m];
          const int q = tid + m * NT;
          if ((f >> kDepthShift) <= unsigned(lag)) continue;
          T val[width];
          bool inside = true;
          if constexpr (Geo::kBounded) inside = (f & kDomain) && (pl.flags & kDomain);
          if constexpr (NS > 0) {
#pragma unroll
            for (int i = 0; i < NS; ++i) ops.sv[i] = fv.v[i][m];
          }
          if (inside) {
            P::template stage<j, WZ>(ops, q, f, pl.flags, val);
          } else {
#pragma unroll
            for (int i = 0; i < width; ++i) val[i] = T(0);
          }
          if constexpr (output && s + 1 == K) {
            if (f & kOut) {
#pragma unroll
              for (int i = 0; i < width; ++i) out[i][pl.off + off[m]] = val[i];
            }
          } else {
            constexpr int step = output ? s + 1 : s;
            static_for<0, width>([&](auto i_) {
              constexpr int v = first + decltype(i_)::value;
              slot(std::integral_constant<int, step>{}, std::integral_constant<int, v>{}, w)[q] =
                  val[decltype(i_)::value];
            });
          }
        }
      });
    });
    __syncthreads();
  };

  T next[NI][M];  // level 0 of the plane after, in flight
  load_plane(0, next);
  for (int t = 0; t < planes; ++t) {
    T v0[NI][M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int f = 0; f < NI; ++f) v0[f][m] = next[f][m];
    }
    if (t + 1 < planes) load_plane(t + 1, next);
    advance(t, v0);
  }
}

template <typename T, int NI, int NO = NI>
struct FieldPtrs3D {
  const T* in[NI];
  T* out[NO];
};

template <class P, typename T>
using ProgramPtrs3D = FieldPtrs3D<T, InputCount<P>::value, OutputCount<P>::value>;

// Copies a launch's host arrays of device pointers into the kernel's table.
template <class P, typename T, class Ptrs>
void fill_ptrs(Ptrs& io, const void* const* ins, void* const* outs) {
  for (int f = 0; f < InputCount<P>::value; ++f) io.in[f] = static_cast<const T*>(ins[f]);
  for (int f = 0; f < OutputCount<P>::value; ++f) io.out[f] = static_cast<T*>(outs[f]);
}

template <class P, typename T, int K, int CX, int TY, int TZ>
__global__ void __launch_bounds__(kMarchThreads, MinBlocks<P, 1>::value)
    multi_stencil_3d_kernel(ProgramPtrs3D<P, T> io, int nx, int ny, int nz) {
  constexpr int H = K * P::kDepth;
  const int x0 = blockIdx.z * CX;  // first output cell of this block
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  const GridGeo<P::kXPeriodic, P::kYPeriodic, P::kZPeriodic> geo{{nx, ny, nz},
                                                                 {x0 - H, y0 - H, z0 - H}};
  const T* in[InputCount<P>::value];
  T* out[OutputCount<P>::value];
#pragma unroll
  for (int f = 0; f < InputCount<P>::value; ++f) in[f] = io.in[f];
#pragma unroll
  for (int f = 0; f < OutputCount<P>::value; ++f) out[f] = io.out[f];
  march_program_3d<P, T, K, TY, TZ>(geo, in, out, min(CX, nx - x0) + 2 * H);
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ins` and `outs` are host arrays of the
// program's InputCount and OutputCount device pointers.
template <class P, typename T, int K, int CX, int TY, int TZ>
int launch_3d(const void* const* ins, void* const* outs, int nx, int ny, int nz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || static_cast<long long>(ny) * nz > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  ProgramPtrs3D<P, T> io;
  fill_ptrs<P, T>(io, ins, outs);
  constexpr size_t smem = ProgramShape<P, T, K, TY, TZ>::kSmem;
  auto kernel = multi_stencil_3d_kernel<P, T, K, CX, TY, TZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + CX - 1) / CX);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(io, nx, ny, nz);
  return cudaGetLastError();
}

// The serial kernel of a program whose ghosts read side inputs: the same
// march, with the input tables among the kernel's parameters. The kernel
// without side inputs compiles as before.
template <typename T, int NI, int NO, int NS>
struct FieldSidePtrs3D : FieldPtrs3D<T, NI, NO> {
  FaceTable<T, NS> sides;
};
template <class P, typename T>
using ProgramSidePtrs3D =
    FieldSidePtrs3D<T, InputCount<P>::value, OutputCount<P>::value, P::kSideInputs>;

template <class P, typename T, int K, int CX, int TY, int TZ>
__global__ void __launch_bounds__(kMarchThreads, MinBlocks<P, kSideMinBlocks>::value)
    multi_stencil_sides_3d_kernel(ProgramSidePtrs3D<P, T> io, int nx, int ny, int nz) {
  constexpr int H = K * P::kDepth;
  const int x0 = blockIdx.z * CX;  // first output cell of this block
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  const GridGeo<P::kXPeriodic, P::kYPeriodic, P::kZPeriodic> geo{{nx, ny, nz},
                                                                 {x0 - H, y0 - H, z0 - H}};
  const T* in[InputCount<P>::value];
  T* out[OutputCount<P>::value];
#pragma unroll
  for (int f = 0; f < InputCount<P>::value; ++f) in[f] = io.in[f];
#pragma unroll
  for (int f = 0; f < OutputCount<P>::value; ++f) out[f] = io.out[f];
  march_program_3d<P, T, K, TY, TZ>(geo, in, out, min(CX, nx - x0) + 2 * H, io.sides);
}

// Fills a launch's side-input tables from the host arrays: `sides` holds
// P::kSideInputs device pointers (each input's table for the pass), `steps`
// each one's stride from a step's table to the next (P::side_step(i) where
// it is not -1), then each one's line stride. Returns false where they do
// not fit the program.
template <class P, typename T>
bool face_table(const void* const* sides, const long long* steps,
                FaceTable<T, P::kSideInputs>& table) {
  constexpr int NS = P::kSideInputs;
  if (sides == nullptr || steps == nullptr) return false;
  for (int i = 0; i < NS; ++i) {
    table.p[i] = static_cast<const T*>(sides[i]);
    table.step[i] = steps[i];
    table.row[i] = steps[NS + i];
    if (table.p[i] == nullptr || (P::side_step(i) >= 0 && steps[i] != P::side_step(i)) ||
        (P::side_axis(i) != 0 && table.row[i] < 1)) {
      return false;
    }
  }
  for (int a = 0; a < 3; ++a) table.origin[a] = 0;
  return true;
}

// Launches one K-step pass of a program with side inputs, as launch_3d;
// `sides` and `steps` as face_table takes them.
template <class P, typename T, int K, int CX, int TY, int TZ>
int launch_sides_3d(const void* const* ins, void* const* outs, int nx, int ny, int nz,
                    const void* const* sides, const long long* steps, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || static_cast<long long>(ny) * nz > 0x7fffffffLL ||
      K * P::kDepth > P::kSidePad) {
    return cudaErrorInvalidValue;
  }
  ProgramSidePtrs3D<P, T> io;
  fill_ptrs<P, T>(io, ins, outs);
  if (!face_table<P, T>(sides, steps, io.sides)) return cudaErrorInvalidValue;
  constexpr size_t smem = ProgramShape<P, T, K, TY, TZ>::kSmem;
  auto kernel = multi_stencil_sides_3d_kernel<P, T, K, CX, TY, TZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + CX - 1) / CX);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(io, nx, ny, nz);
  return cudaGetLastError();
}

// -- the ext kernel ---------------------------------------------------------------
//
// The march above on the local blocks of a decomposed grid. Every field of a
// block lives in a contiguous extended buffer of shape (nx + 2*halo,
// ny + 2*halo, nz + 2*halo) whose halo shell the caller filled from the
// neighbouring blocks (halo >= K*kDepth); the window is read from it at offset
// halo around the block (ExtGeo), with no index wrap, and the chunk is written
// into the interior of the output buffers. A block's face flags replace the
// periodicity of the non-periodic axes: beyond a flagged face the cells are
// held at zero and the operands' affine ghosts are substituted (through the
// same column and plane flags as in the serial kernel), elsewhere the halo is
// trusted. One launch covers up to kMaxExt3DBlocks blocks of one device:
// blockIdx.z runs over (block, x chunk) and indexes a table of pointers and
// flags. A pass of a cut step computes E = P::kExtent cells past its block on
// every side (halo >= K*kDepth + E): its chunks and column tiles cover local
// cells [-E, n + E) of each axis (RegionGeo), all written, zero beyond a
// flagged face.

template <typename T, int NI, int NO = NI>
struct ExtFieldPtrs3D {
  const T* in[kMaxExt3DBlocks][NI];
  T* out[kMaxExt3DBlocks][NO];
  int edge[kMaxExt3DBlocks][6];  // x_lo, x_hi, y_lo, y_hi, z_lo, z_hi
};
template <class P, typename T>
using ProgramExtPtrs3D = ExtFieldPtrs3D<T, InputCount<P>::value, OutputCount<P>::value>;

// ExtGeo of a pass that computes E cells past its block on every side: the
// window origin E cells further out (ext_geo at a halo of H + E), and every
// column of the tile within [-E, n + E) an output column, its offset in the
// buffer reckoned inside the domain or not.
template <bool PX, bool PY, bool PZ, int E>
struct RegionGeo : ExtGeo<PX, PY, PZ> {
  __device__ __forceinline__ MarchColumn column(int y, int z, bool tile) const {
    MarchColumn c = ExtGeo<PX, PY, PZ>::column(y, z, false);
    const int gy = this->g0[1] + y, gz = this->g0[2] + z;
    if (tile && gy < this->n[1] + E && gz < this->n[2] + E) {
      c.off = (gy + this->h) * this->ez + gz + this->h;
      c.flags |= kOut;
    }
    return c;
  }
};

// The geometry of the chunk that blockIdx selects in block `blk`: ExtGeo, or
// RegionGeo in a pass of a cut step.
template <class P, int H, int CX, int TY, int TZ>
__device__ __forceinline__ auto pass_geo(const ExtShape3D& shape,
                                         const int (&edges)[kMaxExt3DBlocks][6], int blk) {
  constexpr bool PX = P::kXPeriodic, PY = P::kYPeriodic, PZ = P::kZPeriodic;
  if constexpr (IsPass<P>::value) {
    constexpr int E = ExtentOf<P>::value;
    RegionGeo<PX, PY, PZ, E> geo;
    static_cast<ExtGeo<PX, PY, PZ>&>(geo) = ext_geo<PX, PY, PZ, H + E, CX, TY, TZ>(shape, edges,
                                                                                    blk);
    return geo;
  } else {
    return ext_geo<PX, PY, PZ, H, CX, TY, TZ>(shape, edges, blk);
  }
}

// The shape checks of an ext launch of a program at K steps, as ext_shape:
// a pass of a cut step takes a halo of K*kDepth + E and chunks over n + 2E.
template <class P, int K, int CX>
ExtShape3D program_shape(const int* n, int halo, int n_blocks, bool& ok) {
  constexpr int E = ExtentOf<P>::value;
  ExtShape3D shape = ext_shape<K * P::kDepth + E, CX>(n, halo, n_blocks, ok);
  if (ok && E > 0) {
    shape.chunks_x = (n[0] + 2 * E + CX - 1) / CX;
    ok = static_cast<long long>(shape.chunks_x) * n_blocks <= 65535;
  }
  return shape;
}

template <class P, typename T, int K, int CX, int TY, int TZ>
__global__ void __launch_bounds__(kMarchThreads, MinBlocks<P, 1>::value)
    multi_stencil_ext_3d_kernel(ProgramExtPtrs3D<P, T> io, ExtShape3D shape) {
  constexpr int H = K * P::kDepth, E = ExtentOf<P>::value;
  const int blk = blockIdx.z / shape.chunks_x;
  const int x0 = (blockIdx.z % shape.chunks_x) * CX;  // first output cell of this chunk, from -E
  const auto geo = pass_geo<P, H, CX, TY, TZ>(shape, io.edge, blk);
  const T* in[InputCount<P>::value];
  T* out[OutputCount<P>::value];
#pragma unroll
  for (int f = 0; f < InputCount<P>::value; ++f) in[f] = io.in[blk][f];
#pragma unroll
  for (int f = 0; f < OutputCount<P>::value; ++f) out[f] = io.out[blk][f];
  march_program_3d<P, T, K, TY, TZ>(geo, in, out, min(CX, shape.n[0] + 2 * E - x0) + 2 * H);
}

// Copies an ext launch's host arrays into the kernel's table: `ins` and
// `outs` hold n_blocks * InputCount and n_blocks * OutputCount pointers
// (block major), `edges` `stride` host ints per block, its 6 face flags first.
template <class P, typename T, class Ptrs>
void fill_ext_ptrs(Ptrs& io, const void* const* ins, void* const* outs, const int* edges,
                   int n_blocks, int stride) {
  constexpr int NI = InputCount<P>::value, NO = OutputCount<P>::value;
  for (int b = 0; b < n_blocks; ++b) {
    for (int f = 0; f < NI; ++f) io.in[b][f] = static_cast<const T*>(ins[b * NI + f]);
    for (int f = 0; f < NO; ++f) io.out[b][f] = static_cast<T*>(outs[b * NO + f]);
    for (int e = 0; e < 6; ++e) io.edge[b][e] = edges[stride * b + e];
  }
}

// Launches one K-step ext pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of the blocks' pointers (block major, see
// fill_ext_ptrs) to contiguous extended buffers; `edges` holds 6 host ints
// per block.
template <class P, typename T, int K, int CX, int TY, int TZ>
int launch_ext_3d(const void* const* ins, void* const* outs, const int* edges, int n_blocks,
                  int nx, int ny, int nz, int halo, void* stream) {
  constexpr int E = ExtentOf<P>::value;
  const int n[3] = {nx, ny, nz};
  bool ok = false;
  const ExtShape3D shape = program_shape<P, K, CX>(n, halo, n_blocks, ok);
  if (!ok) return cudaErrorInvalidValue;
  ProgramExtPtrs3D<P, T> io;
  fill_ext_ptrs<P, T>(io, ins, outs, edges, n_blocks, 6);
  constexpr size_t smem = ProgramShape<P, T, K, TY, TZ>::kSmem;
  auto kernel = multi_stencil_ext_3d_kernel<P, T, K, CX, TY, TZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + 2 * E + TZ - 1) / TZ, (ny + 2 * E + TY - 1) / TY,
                  shape.chunks_x * n_blocks);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(io, shape);
  return cudaGetLastError();
}

// The ext kernel of a program whose ghosts read side inputs (TPU kernel #6's
// bc_inputs): the ext march, every block reading the face tables of the
// GLOBAL grid (the serial kernel's, padded by P::kSidePad cells before the
// grid and past its end) at its own origin, where pde_tpu slices a copy of
// them per shard (pde_tpu/parallel/fused.py:597-700). A block's window cell
// (0, 0, 0) is its local cell (x0 - H, y0 - H, z0 - H) (less E in a pass of a
// cut step), grid cell origin + that; the tables are the pass's, shared by the
// blocks. At a non-periodic global face the entries past the grid feed only
// cells that the face flags hold out of the domain. The stage functions are
// the serial kernel's, so a decomposed run equals the serial side-input
// window bit for bit; the kernel without side inputs compiles as before.
template <typename T, int NI, int NO, int NS>
struct ExtSidePtrs3D : ExtFieldPtrs3D<T, NI, NO> {
  int origin[kMaxExt3DBlocks][3];  // the block's first cell in the grid
  FaceTable<T, NS> sides;
};
template <class P, typename T>
using ProgramExtSidePtrs3D =
    ExtSidePtrs3D<T, InputCount<P>::value, OutputCount<P>::value, P::kSideInputs>;

template <class P, typename T, int K, int CX, int TY, int TZ>
__global__ void __launch_bounds__(kMarchThreads, MinBlocks<P, kSideMinBlocks>::value)
    multi_stencil_sides_ext_3d_kernel(ProgramExtSidePtrs3D<P, T> io, ExtShape3D shape) {
  constexpr int H = K * P::kDepth, E = ExtentOf<P>::value;
  const int blk = blockIdx.z / shape.chunks_x;
  const int x0 = (blockIdx.z % shape.chunks_x) * CX;  // first output cell of this chunk, from -E
  const auto geo = pass_geo<P, H, CX, TY, TZ>(shape, io.edge, blk);
  const T* in[InputCount<P>::value];
  T* out[OutputCount<P>::value];
#pragma unroll
  for (int f = 0; f < InputCount<P>::value; ++f) in[f] = io.in[blk][f];
#pragma unroll
  for (int f = 0; f < OutputCount<P>::value; ++f) out[f] = io.out[blk][f];
  FaceTable<T, P::kSideInputs> sides = io.sides;
#pragma unroll
  for (int a = 0; a < 3; ++a) sides.origin[a] = io.origin[blk][a];
  march_program_3d<P, T, K, TY, TZ>(geo, in, out, min(CX, shape.n[0] + 2 * E - x0) + 2 * H,
                                    sides);
}

// Launches one K-step ext pass of a program with side inputs over n_blocks
// blocks, as launch_ext_3d: `edges` holds 9 host ints per block, its 6 face
// flags then its first cell in the grid; `sides` and `steps` the pass's
// tables as face_table takes them.
template <class P, typename T, int K, int CX, int TY, int TZ>
int launch_ext_sides_3d(const void* const* ins, void* const* outs, const int* edges,
                        int n_blocks, int nx, int ny, int nz, int halo,
                        const void* const* sides, const long long* steps, void* stream) {
  constexpr int E = ExtentOf<P>::value;
  const int n[3] = {nx, ny, nz};
  bool ok = false;
  const ExtShape3D shape = program_shape<P, K, CX>(n, halo, n_blocks, ok);
  if (!ok || K * P::kDepth + E > P::kSidePad) return cudaErrorInvalidValue;
  ProgramExtSidePtrs3D<P, T> io;
  fill_ext_ptrs<P, T>(io, ins, outs, edges, n_blocks, 9);
  for (int b = 0; b < n_blocks; ++b) {
    for (int a = 0; a < 3; ++a) io.origin[b][a] = edges[9 * b + 6 + a];
  }
  if (!face_table<P, T>(sides, steps, io.sides)) return cudaErrorInvalidValue;
  constexpr size_t smem = ProgramShape<P, T, K, TY, TZ>::kSmem;
  auto kernel = multi_stencil_sides_ext_3d_kernel<P, T, K, CX, TY, TZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + 2 * E + TZ - 1) / TZ, (ny + 2 * E + TY - 1) / TY,
                  shape.chunks_x * n_blocks);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(io, shape);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
