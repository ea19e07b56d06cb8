// Temporally blocked affine Laplacian on a 3D Cartesian grid, for Hopper (sm_90a).
// Hand-written template; its entry points, one instantiation per (k, dtype)
// with the plan the host picks, for one periodicity of the three axes, are
// generated by pde_tpu_torch/ops/cuda_cartesian_3d.py. The march core below is
// shared with the halo-extended kernel of decomposed runs
// (affine_laplace_ext_3d.cuh).
//
// Replaces the TPU kernel `make_affine_laplace_3d` of
// pde_tpu/ops/pallas_cartesian.py: one pass over device memory computes
//     f <- (a*I + b*lap)^k f,   1 <= k <= 4,
// with the 7-point Laplacian and per-axis spacing, periodic axes, and constant
// affine ghost cells on non-periodic faces, ghost = c + f1*edge +
// f2*next_inward (Dirichlet, Neumann, Robin and curvature conditions).
//
// What bounds it on this card. A pass reads and writes every cell once: 8 B
// per fp32 cell, so one 256^3 fp32 pass moves at least 134 MB and takes at
// least 40 us at the data sheet's 3.35 TB/s, whatever k; its ~10 flops per
// update and step stay far below the 67 TFLOP/s fp32 rate for any k here, so
// the bound is the bytes. Temporal blocking divides those bytes per step by
// k; its price is the halo a block recomputes, and the shared-memory traffic
// of the stencil reads.
//
// Design: an x-marching (2.5D) wavefront, as the TPU kernel bands x, on the
// window geometry of march_3d.cuh. A block of kMarchThreads threads owns a
// TY x TZ output column tile in (y, z) and a chunk of CX x planes. It marches along x through the chunk and k planes of x halo
// on each side, so only y and z carry k-deep halos and the x halo costs
// (CX + 2k) / CX. TZ is 64 cells, so 256-cell rows take no ragged tile.
//   - Each thread owns fixed window columns (y, z), dealt linearly over the
//     (TY + 2k) x (TZ + 2k) window plane so that neighbouring threads hold
//     neighbouring z; per column it computes once, at the start, the column's
//     offset in the buffer (periodic axes wrapped there, once: an index
//     table in registers), its ring depth in the window and its flags
//     (loaded, in the domain, on a face with ghosts, in the output tile).
//   - Wavefront over the k levels: iteration t brings level 0 of window plane
//     t; then level s + 1 of plane t - s - 1 is computed from level s of planes
//     t - s - 2, t - s - 1 and t - s, which all exist, for s = 0 .. k - 1.
//     Level k goes from registers straight to device memory. One barrier per
//     iteration: level s + 1 reads its y and z neighbours only from level s of
//     plane t - s - 1, written in an earlier iteration, and each level keeps
//     the planes that are still read in two shared-memory slots: the upper x
//     neighbour is the plane a thread has just computed, in a register, and
//     every other operand is read from shared memory. Each level's new
//     plane is stored only after the level above has read its operands, so
//     a thread reads its own column's lower x neighbour from the slot that it
//     then overwrites; other threads read that slot only before the last
//     barrier. 512 threads a block; at up to 64 registers a thread two blocks
//     fit on an SM. The launch bounds ask for one block per SM here, where
//     ptxas stays within 64 registers at every k in fp32 and the k = 2 pass
//     ran slower under a bound of two blocks or of none; the ext kernel asks
//     for two, since it took 72 registers at k = 3 and 4 under one (one
//     block per SM, and slower).
//   - Level 0 streams in one plane ahead of use, its loads held in registers.
//     (PERF.md keeps the times of the layouts, prefetch depths, cp.async
//     copies and block sizes that lost to this design.)
//   - Ghosts: the ghost of a non-periodic face at level s is
//     c + f1*edge + f2*next_inward of level s, the value the TPU kernel writes
//     into its ghost plane at every step; here it is formed where it is read,
//     by the thread that updates the edge cell, from that cell (the centre)
//     and its inward neighbour, both operands of the same update. No rewrite
//     pass, no barrier. Cells outside the domain hold zero at every
//     level; the 7-point stencil reads face neighbours only, so edge and
//     corner ghosts are never read.
//   - The per-cell update is one __device__ function, affine_update, which
//     both kernels call, so a decomposed run equals the serial run bit for
//     bit whatever FMA contraction nvcc chooses.
// Global offsets are 64-bit; a plane's offsets 32-bit.

#pragma once

#include "march_3d.cuh"

namespace pde_tpu_torch {

constexpr int kMaxSteps = 4;

struct Side {
  double c, f1, f2;  // ghost = c + f1 * edge + f2 * next_inward
};

// One step's coefficients in the working type, and the faces' ghost formulas.
template <typename T>
struct AffineStep {
  T a, b, sx, sy, sz, bsx;  // bsx = b / dx^2 of an isotropic grid
  int isotropic;
  Side lo[3], hi[3];  // low and high face of x, y and z
};

// From 23 host doubles: a, b, 1/dx^2 per axis, then (c, f1, f2) of the low
// and high face of x, y and z.
template <typename T>
AffineStep<T> make_affine_step(const double* d) {
  AffineStep<T> st;
  st.a = T(d[0]);
  st.b = T(d[1]);
  st.sx = T(d[2]);
  st.sy = T(d[3]);
  st.sz = T(d[4]);
  st.bsx = T(d[1] * d[2]);
  st.isotropic = d[2] == d[3] && d[3] == d[4];
  for (int a = 0; a < 3; ++a) {
    const double* s = d + 5 + 6 * a;
    st.lo[a] = Side{s[0], s[1], s[2]};
    st.hi[a] = Side{s[3], s[4], s[5]};
  }
  return st;
}

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

// The one per-cell update of both 3D affine kernels: a*f + b*lap(f) from the
// centre and its x (up, down), y (north, south) and z (west, east) neighbours;
// ISO is st.isotropic, decided once per block.
template <bool ISO, typename T>
__device__ __forceinline__ T affine_update(const AffineStep<T>& st, T center, T up, T down, T north,
                                           T south, T west, T east) {
  if constexpr (ISO) {
    return st.a * center + st.bsx * (up + down + north + south + west + east - T(6) * center);
  } else {
    const T lap = (up + down - T(2) * center) * st.sx + (north + south - T(2) * center) * st.sy +
                  (west + east - T(2) * center) * st.sz;
    return st.a * center + st.b * lap;
  }
}

// The march of the affine kernels: k levels of two shared-memory planes each.
template <typename T, int K, int TY, int TZ>
struct MarchShape : MarchWindow<K, TY, TZ> {
  using MarchWindow<K, TY, TZ>::kPlane;
  static constexpr int kSlots = 2;  // shared-memory planes per level
  static constexpr size_t kSmem = size_t(K) * kSlots * kPlane * sizeof(T);
};

// One block's march: `geo` maps window cells to the buffers (serial grid or
// extended block) and says which lie in the domain (`load` for the planes
// read, wrapped; `plane` for the planes computed, whose offsets serve only the
// chunk's own planes); `planes` level-0 planes (the chunk's output planes
// plus k per side). `in` and `out` share a layout.
template <bool ISO, typename T, int K, int TY, int TZ, class Geo>
__device__ __forceinline__ void march_3d(const Geo& geo, const AffineStep<T>& st,
                                         const T* __restrict__ in, T* __restrict__ out,
                                         int planes) {
  using S = MarchShape<T, K, TY, TZ>;
  constexpr int M = S::kCols, WZ = S::kWZ, PLANE = S::kPlane, NT = kMarchThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;

  // level s's slot for window plane w
  auto level = [&](int s, int w) -> T* {
    const unsigned u = w;  // w >= 0
    return smem + (s * S::kSlots + u % S::kSlots) * PLANE;
  };

  // this thread's columns: q = tid + m * NT of the window plane
  int off[M];
  unsigned flags[M];
  march_columns<K, TY, TZ>(geo, off, flags);

  auto load_plane = [&](int w, T(&v)[M]) {  // level 0 of window plane w, into registers
    const MarchPlane pl = geo.load(w);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[m] = T(0);
      if ((pl.flags & kLoad) && (flags[m] & kLoad)) v[m] = in[pl.off + off[m]];
    }
  };

  // iteration t: level 0 of plane t enters as v0; then levels 1 .. K. Level s
  // of plane t - s goes into its slot only after level s + 1 has read its
  // operands, so that a thread may read its own column's lower x neighbour
  // from the slot that this store overwrites.
  auto advance = [&](int t, T(&v0)[M]) {
    T nw[M];  // level s of plane t - s
#pragma unroll
    for (int m = 0; m < M; ++m) nw[m] = v0[m];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      T nx[M];  // level s + 1 of plane w = t - s - 1
      const int w = t - s - 1;
      if (t >= 2 * s + 2) {
        const MarchPlane pl = geo.plane(w);
        const T* cur = level(s, w);       // level s of plane w
        const T* prev = level(s, w - 1);  // level s of plane w - 1
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const unsigned f = flags[m];
          const int q = tid + m * NT;
          T v = T(0);
          if ((f >> kDepthShift) > unsigned(s + 1)) {
            bool inside = true;
            if constexpr (Geo::kBounded) inside = (f & kDomain) && (pl.flags & kDomain);
            if (inside) {
              T center = cur[q], up = prev[q], down = nw[m];
              T north = cur[q - WZ], south = cur[q + WZ];
              T west = cur[q - 1], east = cur[q + 1];
              if constexpr (Geo::kGhostX) {
                if (pl.flags & kLowEdge) up = ghost_value(st.lo[0], center, down);
                if (pl.flags & kHighEdge) down = ghost_value(st.hi[0], center, up);
              }
              if constexpr (Geo::kGhostY) {
                if (f & kLowEdge) north = ghost_value(st.lo[1], center, south);
                if (f & kHighEdge) south = ghost_value(st.hi[1], center, north);
              }
              if constexpr (Geo::kGhostZ) {
                if (f & kLowEdgeZ) west = ghost_value(st.lo[2], center, east);
                if (f & kHighEdgeZ) east = ghost_value(st.hi[2], center, west);
              }
              v = affine_update<ISO>(st, center, up, down, north, south, west, east);
            }
            if (s + 1 == K && (f & kOut)) out[pl.off + off[m]] = v;
          }
          nx[m] = v;
        }
      }
      if (t >= 2 * s) {  // level s of plane t - s, for its readers
        T* dst = level(s, t - s);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if ((flags[m] >> kDepthShift) > unsigned(s)) dst[tid + m * NT] = nw[m];
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) nw[m] = nx[m];
    }
    __syncthreads();
  };

  T next[M];  // level 0 of the plane after, in flight
  load_plane(0, next);
  for (int t = 0; t < planes; ++t) {
    T v0[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v0[m] = next[m];
    if (t + 1 < planes) load_plane(t + 1, next);
    advance(t, v0);
  }
}

template <typename T, int K, int CX, int TY, int TZ, bool PX, bool PY, bool PZ>
__global__ void __launch_bounds__(kMarchThreads, 1)
    affine_laplace_3d_kernel(const T* __restrict__ in, T* __restrict__ out, int nx, int ny, int nz,
                             AffineStep<T> st) {
  const int x0 = blockIdx.z * CX;  // first output cell of this block
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  const GridGeo<PX, PY, PZ> geo{{nx, ny, nz}, {x0 - K, y0 - K, z0 - K}};
  const int planes = min(CX, nx - x0) + 2 * K;
  if (st.isotropic) {
    march_3d<true, T, K, TY, TZ>(geo, st, in, out, planes);
  } else {
    march_3d<false, T, K, TY, TZ>(geo, st, in, out, planes);
  }
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ints` holds 10 host ints: the grid
// shape (x, y, z), the plan (CX, TY, TZ), k, and the periodicity of each
// axis, all of which but the shape must be this instantiation's. `doubles`
// holds 23 host doubles: a, b, 1/dx^2 per axis, then (c, f1, f2) of the low
// and high face of x, y and z.
template <typename T, int K, int CX, int TY, int TZ, bool PX, bool PY, bool PZ>
int launch_affine_3d(const void* in, void* out, const int* ints, const double* doubles,
                     void* stream) {
  static_assert(K >= 1 && K <= kMaxSteps, "1 <= k <= 4");
  if (ints[3] != CX || ints[4] != TY || ints[5] != TZ || ints[6] != K || ints[7] != PX ||
      ints[8] != PY || ints[9] != PZ) {
    return cudaErrorInvalidValue;
  }
  const int nx = ints[0], ny = ints[1], nz = ints[2];
  if (nx < 1 || ny < 1 || nz < 1 || static_cast<long long>(ny) * nz > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const AffineStep<T> st = make_affine_step<T>(doubles);
  constexpr size_t smem = MarchShape<T, K, TY, TZ>::kSmem;
  auto kernel = affine_laplace_3d_kernel<T, K, CX, TY, TZ, PX, PY, PZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + CX - 1) / CX);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), nx, ny, nz, st);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
