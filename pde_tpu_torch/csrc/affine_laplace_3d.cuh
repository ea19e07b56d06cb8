// Temporally blocked affine Laplacian on a 3D Cartesian grid, for Hopper (sm_90a).
// Hand-written template; its entry points, one instantiation per (k, dtype)
// with the tile the host picks, for one periodicity of the three axes, are
// generated by pde_tpu_torch/ops/cuda_cartesian_3d.py.
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
// k; the price is the halo: every tile recomputes the cells of a k-deep shell
// that its neighbours own, a factor prod_i (T_i + 2k) / T_i of the updates,
// which grows fast with k in 3D. Past small k the shared-memory traffic (seven
// loads and one store per update) and that factor set the pace.
//
// Design. The TPU kernel keeps (y, z) planes in VMEM and bands x; a Hopper
// block has 227 KB of shared memory, so here each block owns a TX x TY x TZ
// output tile and loads a window with k-deep halos on all six faces. z is the
// contiguous axis and the window is one warp (32 cells) wide along it, so its
// rows load coalesced: TZ = 32 - 2k. The host picks TX = TY from a
// shared-memory budget per (k, dtype); k, the tile and the axes' periodicity
// are template parameters, so the window's extents and the domain checks of
// periodic axes are compile-time constants. Periodic halos
// wrap by index, ((i % n) + n) % n, so grids smaller than the halo wrap more
// than once. The k steps run in shared memory, ping-ponging two buffers; the
// valid region shrinks by one cell per face per step, and only the centre tile
// is written back. At every step the single ghost plane at a non-periodic
// global face is rewritten from the current level's edge and next-inward
// cells, over the cells whose other two coordinates lie in the domain; cells
// further out lie outside the light cone of the tile and are held at zero. The
// 7-point stencil reads face neighbours only, so edge and corner ghosts (a
// cell outside two non-periodic faces) are never read and stay zero.
// Global offsets are 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pde_tpu_torch {

constexpr int kBlockX = 32;  // threads along z
constexpr int kBlockY = 8;   // threads along y
constexpr int kMaxSteps = 4;
constexpr int kLoadBatch = 8;  // x planes whose loads a thread has in flight at once

struct Side {
  double c, f1, f2;  // ghost = c + f1 * edge + f2 * next_inward
};

struct Params {
  int n[3];     // grid shape (x, y, z); z is contiguous
  int tile[3];  // output tile
  int w[3];     // window: tile + 2k
  int k;
  int periodic[3];
  double a, b, s[3];  // s = 1/dx^2 per axis
  Side lo[3], hi[3];  // low and high face of each axis
};

__device__ __forceinline__ int wrap_index(int i, int n) { return ((i % n) + n) % n; }

template <typename T>
__device__ __forceinline__ T ghost_value(const Side& s, T edge, T inward) {
  T g = T(s.c) + T(s.f1) * edge;
  if (s.f2 != 0.0) g = g + T(s.f2) * inward;
  return g;
}

// Whether global index g of an axis of n cells, periodic when P, lies in the domain.
template <bool P>
__device__ __forceinline__ bool axis_in(int g, int n) {
  return P || (g >= 0 && g < n);
}

// Whether window index i of `axis` stands for a cell of the domain.
__device__ __forceinline__ bool in_domain(const Params& p, const int* g0, int axis, int i) {
  const int g = g0[axis] + i;
  return p.periodic[axis] || (g >= 0 && g < p.n[axis]);
}

// Rewrites the ghost cells of level s on the low and high face of AXIS, over
// the valid region [lo, hi[a]) of the two other axes (U, V), for cells whose
// U and V coordinates lie in the domain.
template <int AXIS, typename T>
__device__ __forceinline__ void rewrite_faces(T* cur, const Params& p, const int* g0, int lo,
                                              const int* hi) {
  if (p.periodic[AXIS]) return;
  constexpr int U = AXIS == 0 ? 1 : 0;
  constexpr int V = AXIS == 2 ? 1 : 2;
  const int stride[3] = {p.w[1] * p.w[2], p.w[2], 1};
  const int glo = -1 - g0[AXIS], ghi = p.n[AXIS] - g0[AXIS];
  const bool do_lo = glo >= lo && glo + 2 < hi[AXIS];
  const bool do_hi = ghi - 2 >= lo && ghi < hi[AXIS];
  if (!do_lo && !do_hi) return;
  const int nu = hi[U] - lo, nv = hi[V] - lo;
  const int s = stride[AXIS];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int q = tid; q < nu * nv; q += kBlockX * kBlockY) {
    const int iu = lo + q / nv, iv = lo + q % nv;
    if (!in_domain(p, g0, U, iu) || !in_domain(p, g0, V, iv)) continue;
    const int base = iu * stride[U] + iv * stride[V];
    if (do_lo) {
      const int g = base + glo * s;
      cur[g] = ghost_value(p.lo[AXIS], cur[g + s], cur[g + 2 * s]);
    }
    if (do_hi) {
      const int g = base + ghi * s;
      cur[g] = ghost_value(p.hi[AXIS], cur[g - s], cur[g - 2 * s]);
    }
  }
}

template <typename T, int K, int TX, int TY, int TZ, bool PX, bool PY, bool PZ>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    affine_laplace_3d_kernel(const T* __restrict__ in, T* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int wx = TX + 2 * K, wy = TY + 2 * K, wz = TZ + 2 * K;
  constexpr int plane = wy * wz;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + wx * plane;

  const int x0 = blockIdx.z * TX;  // first output cell of this tile
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  constexpr int k = K;
  const int g0[3] = {x0 - k, y0 - k, z0 - k};  // global cell of window cell 0
  const int tx = threadIdx.x, ty = threadIdx.y;

  // load the window; cells outside a non-periodic domain start at zero. A
  // thread owns (y, z) columns and starts the loads of kLoadBatch x planes
  // before it stores them, so that their latencies overlap.
  const size_t x_stride = static_cast<size_t>(p.n[1]) * p.n[2];
  for (int j = ty; j < wy; j += kBlockY) {
    const bool y_in = axis_in<PY>(g0[1] + j, p.n[1]);
    const int ry = PY ? wrap_index(g0[1] + j, p.n[1]) : g0[1] + j;
    for (int l = tx; l < wz; l += kBlockX) {
      const bool yz_in = y_in && axis_in<PZ>(g0[2] + l, p.n[2]);
      const int rz = PZ ? wrap_index(g0[2] + l, p.n[2]) : g0[2] + l;
      const size_t column = static_cast<size_t>(ry) * p.n[2] + rz;
#pragma unroll
      for (int i0 = 0; i0 < wx; i0 += kLoadBatch) {
        T v[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int i = i0 + u;
          v[u] = T(0);
          if (i < wx && yz_in && axis_in<PX>(g0[0] + i, p.n[0])) {
            const int rx = PX ? wrap_index(g0[0] + i, p.n[0]) : g0[0] + i;
            v[u] = in[rx * x_stride + column];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          if (i0 + u < wx) cur[(i0 + u) * plane + j * wz + l] = v[u];
        }
      }
    }
  }
  __syncthreads();

  const T a = T(p.a), b = T(p.b);
  const T sx = T(p.s[0]), sy = T(p.s[1]), sz = T(p.s[2]);
  const T bsx = T(p.b * p.s[0]);
  const bool isotropic = p.s[0] == p.s[1] && p.s[1] == p.s[2];

#pragma unroll
  for (int s = 0; s < k; ++s) {
    const int lo = s;  // level s is valid on [lo, hi[a]) along each axis
    const int hi[3] = {wx - s, wy - s, wz - s};
    if constexpr (!(PX && PY && PZ)) {
      rewrite_faces<0>(cur, p, g0, lo, hi);
      rewrite_faces<1>(cur, p, g0, lo, hi);
      rewrite_faces<2>(cur, p, g0, lo, hi);
      __syncthreads();
    }

    // level s+1 on [lo+1, hi-1)^3
    for (int i = lo + 1; i < hi[0] - 1; ++i) {
      const bool x_in = axis_in<PX>(g0[0] + i, p.n[0]);
      for (int j = lo + 1 + ty; j < hi[1] - 1; j += kBlockY) {
        const bool y_in = axis_in<PY>(g0[1] + j, p.n[1]);
        for (int l = lo + 1 + tx; l < hi[2] - 1; l += kBlockX) {
          const int idx = i * plane + j * wz + l;
          T v = T(0);
          if (x_in && y_in && axis_in<PZ>(g0[2] + l, p.n[2])) {
            const T center = cur[idx];
            const T up = cur[idx - plane], down = cur[idx + plane];
            const T north = cur[idx - wz], south = cur[idx + wz];
            const T west = cur[idx - 1], east = cur[idx + 1];
            if (isotropic) {
              v = a * center + bsx * (up + down + north + south + west + east - T(6) * center);
            } else {
              const T lap = (up + down - T(2) * center) * sx + (north + south - T(2) * center) * sy +
                            (west + east - T(2) * center) * sz;
              v = a * center + b * lap;
            }
          }
          nxt[idx] = v;
        }
      }
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // write the centre tile
  for (int i = 0; i < TX && x0 + i < p.n[0]; ++i) {
    for (int j = ty; j < TY && y0 + j < p.n[1]; j += kBlockY) {
      for (int l = tx; l < TZ && z0 + l < p.n[2]; l += kBlockX) {
        const size_t dst = (static_cast<size_t>(x0 + i) * p.n[1] + y0 + j) * p.n[2] + z0 + l;
        out[dst] = cur[(i + k) * plane + (j + k) * wz + l + k];
      }
    }
  }
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ints` holds 10 host ints: the grid
// shape (x, y, z), the output tile (x, y, z), k, and the periodicity of each
// axis, all of which must be this instantiation's. `doubles` holds 23 host
// doubles: a, b, 1/dx^2 per axis, then (c, f1, f2) of the low and high face of
// x, y and z.
template <typename T, int K, int TX, int TY, int TZ, bool PX, bool PY, bool PZ>
int launch_affine_3d(const void* in, void* out, const int* ints, const double* doubles,
                     void* stream) {
  static_assert(K >= 1 && K <= kMaxSteps, "1 <= k <= 4");
  if (ints[3] != TX || ints[4] != TY || ints[5] != TZ || ints[6] != K || ints[7] != PX ||
      ints[8] != PY || ints[9] != PZ) {
    return cudaErrorInvalidValue;
  }
  Params p;
  for (int a = 0; a < 3; ++a) {
    p.n[a] = ints[a];
    p.tile[a] = ints[3 + a];
    p.periodic[a] = ints[7 + a];
    if (p.n[a] < 1) return cudaErrorInvalidValue;
    p.w[a] = p.tile[a] + 2 * K;
  }
  p.k = K;
  p.a = doubles[0];
  p.b = doubles[1];
  for (int a = 0; a < 3; ++a) {
    p.s[a] = doubles[2 + a];
    const double* lo = doubles + 5 + 6 * a;
    p.lo[a] = Side{lo[0], lo[1], lo[2]};
    p.hi[a] = Side{lo[3], lo[4], lo[5]};
  }
  const size_t smem = 2 * static_cast<size_t>(p.w[0]) * p.w[1] * p.w[2] * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(affine_laplace_3d_kernel<T, K, TX, TY, TZ, PX, PY, PZ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n[2] + TZ - 1) / TZ, (p.n[1] + TY - 1) / TY, (p.n[0] + TX - 1) / TX);
  const dim3 block(kBlockX, kBlockY);
  affine_laplace_3d_kernel<T, K, TX, TY, TZ, PX, PY, PZ>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(in),
                                                                 static_cast<T*>(out), p);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
