// Temporally blocked affine Laplacian on halo-extended 3D blocks, for Hopper
// (sm_90a): the 3D kernel (affine_laplace_3d.cuh) fed from the buffers of a
// decomposed grid. Hand-written template; its entry points, one instantiation
// per (k, dtype) with the tile the host picks, for one periodicity of the
// three axes, are generated by pde_tpu_torch/ops/cuda_ext_3d.py.
//
// Replaces the TPU kernel `make_affine_laplace_ext_3d` of
// pde_tpu/ops/pallas_cartesian.py: for each local block of shape (nx, ny, nz),
// held in a contiguous extended buffer of shape (nx + 2h, ny + 2h, nz + 2h)
// whose halo shell was filled from the neighbouring blocks, one pass computes
//     f <- (a*I + b*lap)^k f,   1 <= k <= h, k <= 4,
// on the block's interior and writes it into the interior of another buffer
// of the same shape. Edge flags (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi) say which
// faces of the block lie on a non-periodic global face; there the cells
// beyond the face are held at zero and the single ghost plane is rewritten at
// every step from the current level, ghost = c + f1*edge + f2*next_inward, as
// the serial kernel does at the global faces. Elsewhere the halo is trusted:
// it holds the neighbour's (or, on a periodic axis with one block, the
// block's own wrapped) cells.
//
// What bounds it on this card. As the serial kernel: one pass reads each
// buffer cell once (the interior and the halo shell, a factor
// prod_i (n_i + 2h) / n_i of the block) and writes each interior cell once, so
// the bytes per cell-update fall as 1/k; past small k the shared-memory
// traffic and the recomputed tile halos set the pace.
//
// Design. The serial kernel's tiling and per-cell arithmetic, unchanged, so a
// decomposed run equals the serial run bit for bit: each block of threads
// owns a TX x TY x TZ output tile, one warp wide along the contiguous z axis
// (TZ = 32 - 2k), loads a window with k-deep halos on all six faces and runs
// the k steps in shared memory, ping-ponging two buffers. The window is read
// from the extended buffer at offset h - k around the tile, with no index
// wrap. The serial kernel's test of a non-periodic axis becomes the runtime
// flag of that face; a periodic axis never carries a flag, so its test stays
// a compile-time constant. The 7-point stencil reads face neighbours only, so
// edge and corner ghosts (a cell beyond two flagged faces) stay zero and are
// never read. One launch covers up to kMaxExt3DBlocks local blocks of one
// device, which share a shape: blockIdx.z runs over (block, x tile), and a
// table of pointers and flags is passed by value. Buffer offsets are 64-bit.

#pragma once

#include "affine_laplace_3d.cuh"

namespace pde_tpu_torch {

constexpr int kMaxExt3DBlocks = 8;

struct ExtParams3D {
  int n[3];     // block shape (x, y, z)
  int halo;     // halo width of the extended buffers
  int tiles_x;  // output tiles along x per block
  double a, b, s[3];
  Side lo[3], hi[3];
};

template <typename T>
struct ExtBlocks3D {
  const T* in[kMaxExt3DBlocks];
  T* out[kMaxExt3DBlocks];
  int edge[kMaxExt3DBlocks][6];  // x_lo, x_hi, y_lo, y_hi, z_lo, z_hi
};

// Whether local index g along an axis of n cells lies in the domain: only a
// flagged face has an outside, and a periodic axis (P) has none.
template <bool P>
__device__ __forceinline__ bool ext_in(int g, int n, bool lo_edge, bool hi_edge) {
  return P || ((!lo_edge || g >= 0) && (!hi_edge || g < n));
}

// Rewrites the ghost cells of level s on the flagged low and high face of
// AXIS, over the valid region [lo, hi[a]) of the two other axes (U, V), for
// cells whose U and V coordinates lie in the domain.
template <int AXIS, bool PX, bool PY, bool PZ, typename T>
__device__ __forceinline__ void rewrite_ext_faces(T* cur, const ExtParams3D& p, const bool* e,
                                                  const int* g0, const int* w, int lo,
                                                  const int* hi) {
  constexpr bool P = AXIS == 0 ? PX : (AXIS == 1 ? PY : PZ);
  if constexpr (P) {
    return;
  } else {
    constexpr int U = AXIS == 0 ? 1 : 0;
    constexpr int V = AXIS == 2 ? 1 : 2;
    constexpr bool PU = U == 0 ? PX : PY;
    constexpr bool PV = V == 1 ? PY : PZ;
    const int stride[3] = {w[1] * w[2], w[2], 1};
    const int glo = -1 - g0[AXIS], ghi = p.n[AXIS] - g0[AXIS];
    const bool do_lo = e[2 * AXIS] && glo >= lo && glo + 2 < hi[AXIS];
    const bool do_hi = e[2 * AXIS + 1] && ghi - 2 >= lo && ghi < hi[AXIS];
    if (!do_lo && !do_hi) return;
    const int nu = hi[U] - lo, nv = hi[V] - lo;
    const int s = stride[AXIS];
    const int tid = threadIdx.y * kBlockX + threadIdx.x;
    for (int q = tid; q < nu * nv; q += kBlockX * kBlockY) {
      const int iu = lo + q / nv, iv = lo + q % nv;
      if (!ext_in<PU>(g0[U] + iu, p.n[U], e[2 * U], e[2 * U + 1]) ||
          !ext_in<PV>(g0[V] + iv, p.n[V], e[2 * V], e[2 * V + 1]))
        continue;
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
}

template <typename T, int K, int TX, int TY, int TZ, bool PX, bool PY, bool PZ>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    affine_laplace_ext_3d_kernel(ExtBlocks3D<T> blocks, ExtParams3D p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int wx = TX + 2 * K, wy = TY + 2 * K, wz = TZ + 2 * K;
  constexpr int plane = wy * wz;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + wx * plane;

  const int blk = blockIdx.z / p.tiles_x;
  const T* __restrict__ in = blocks.in[blk];
  T* __restrict__ out = blocks.out[blk];
  bool e[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) e[f] = blocks.edge[blk][f] != 0;
  const int x0 = (blockIdx.z % p.tiles_x) * TX;  // first output cell of this tile (local)
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  constexpr int k = K;
  const int g0[3] = {x0 - k, y0 - k, z0 - k};  // local cell of window cell 0
  const int w[3] = {wx, wy, wz};
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int h = p.halo;
  const int ez = p.n[2] + 2 * h;  // extended extents: the buffers' strides
  const size_t x_stride = static_cast<size_t>(p.n[1] + 2 * h) * ez;

  // load the window; cells beyond a flagged face start at zero, cells past the
  // buffer (beyond the tiles' light cone) too. A thread owns (y, z) columns
  // and starts the loads of kLoadBatch x planes before it stores them.
  for (int j = ty; j < wy; j += kBlockY) {
    const int gy = g0[1] + j;
    const bool y_in = ext_in<PY>(gy, p.n[1], e[2], e[3]) && gy < p.n[1] + h;
    for (int l = tx; l < wz; l += kBlockX) {
      const int gz = g0[2] + l;
      const bool yz_in = y_in && ext_in<PZ>(gz, p.n[2], e[4], e[5]) && gz < p.n[2] + h;
      const size_t column = static_cast<size_t>(gy + h) * ez + gz + h;
#pragma unroll
      for (int i0 = 0; i0 < wx; i0 += kLoadBatch) {
        T v[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int gx = g0[0] + i0 + u;
          v[u] = T(0);
          if (i0 + u < wx && yz_in && ext_in<PX>(gx, p.n[0], e[0], e[1]) && gx < p.n[0] + h) {
            v[u] = in[static_cast<size_t>(gx + h) * x_stride + column];
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
  const bool any_edge = e[0] || e[1] || e[2] || e[3] || e[4] || e[5];

#pragma unroll
  for (int s = 0; s < k; ++s) {
    const int lo = s;  // level s is valid on [lo, hi[a]) along each axis
    const int hi[3] = {wx - s, wy - s, wz - s};
    if (any_edge) {
      rewrite_ext_faces<0, PX, PY, PZ>(cur, p, e, g0, w, lo, hi);
      rewrite_ext_faces<1, PX, PY, PZ>(cur, p, e, g0, w, lo, hi);
      rewrite_ext_faces<2, PX, PY, PZ>(cur, p, e, g0, w, lo, hi);
      __syncthreads();
    }

    // level s+1 on [lo+1, hi-1)^3: the serial kernel's arithmetic
    for (int i = lo + 1; i < hi[0] - 1; ++i) {
      const bool x_in = ext_in<PX>(g0[0] + i, p.n[0], e[0], e[1]);
      for (int j = lo + 1 + ty; j < hi[1] - 1; j += kBlockY) {
        const bool y_in = ext_in<PY>(g0[1] + j, p.n[1], e[2], e[3]);
        for (int l = lo + 1 + tx; l < hi[2] - 1; l += kBlockX) {
          const int idx = i * plane + j * wz + l;
          T v = T(0);
          if (x_in && y_in && ext_in<PZ>(g0[2] + l, p.n[2], e[4], e[5])) {
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

  // write the centre tile into the interior of the output buffer
  for (int i = 0; i < TX && x0 + i < p.n[0]; ++i) {
    for (int j = ty; j < TY && y0 + j < p.n[1]; j += kBlockY) {
      for (int l = tx; l < TZ && z0 + l < p.n[2]; l += kBlockX) {
        const size_t dst = static_cast<size_t>(x0 + i + h) * x_stride +
                           static_cast<size_t>(y0 + j + h) * ez + z0 + l + h;
        out[dst] = cur[(i + k) * plane + (j + k) * wz + l + k];
      }
    }
  }
}

// Launches one K-step pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of n_blocks device pointers to contiguous
// (nx + 2h, ny + 2h, nz + 2h) buffers; `edges` holds 6 host ints per block.
// `ints` holds 12 host ints: n_blocks, the block shape (x, y, z), the halo h,
// the output tile (x, y, z), k, and the periodicity of each axis, all of which
// must be this instantiation's. `doubles` holds 23 host doubles: a, b, 1/dx^2
// per axis, then (c, f1, f2) of the low and high face of x, y and z.
template <typename T, int K, int TX, int TY, int TZ, bool PX, bool PY, bool PZ>
int launch_affine_ext_3d(const void* const* ins, void* const* outs, const int* edges,
                         const int* ints, const double* doubles, void* stream) {
  static_assert(K >= 1 && K <= kMaxSteps, "1 <= k <= 4");
  const int n_blocks = ints[0];
  if (ints[5] != TX || ints[6] != TY || ints[7] != TZ || ints[8] != K || ints[9] != PX ||
      ints[10] != PY || ints[11] != PZ || n_blocks < 1 || n_blocks > kMaxExt3DBlocks) {
    return cudaErrorInvalidValue;
  }
  ExtParams3D p;
  p.halo = ints[4];
  for (int a = 0; a < 3; ++a) {
    p.n[a] = ints[1 + a];
    if (p.n[a] < p.halo) return cudaErrorInvalidValue;
  }
  if (p.halo < K) return cudaErrorInvalidValue;
  p.tiles_x = (p.n[0] + TX - 1) / TX;
  if (static_cast<long long>(p.tiles_x) * n_blocks > 65535) return cudaErrorInvalidValue;
  p.a = doubles[0];
  p.b = doubles[1];
  for (int a = 0; a < 3; ++a) {
    p.s[a] = doubles[2 + a];
    const double* lo = doubles + 5 + 6 * a;
    p.lo[a] = Side{lo[0], lo[1], lo[2]};
    p.hi[a] = Side{lo[3], lo[4], lo[5]};
  }
  ExtBlocks3D<T> blocks;
  for (int z = 0; z < n_blocks; ++z) {
    blocks.in[z] = static_cast<const T*>(ins[z]);
    blocks.out[z] = static_cast<T*>(outs[z]);
    for (int f = 0; f < 6; ++f) blocks.edge[z][f] = edges[6 * z + f];
  }
  constexpr size_t smem = 2 * static_cast<size_t>(TX + 2 * K) * (TY + 2 * K) * (TZ + 2 * K) *
                          sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(affine_laplace_ext_3d_kernel<T, K, TX, TY, TZ, PX, PY, PZ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n[2] + TZ - 1) / TZ, (p.n[1] + TY - 1) / TY, p.tiles_x * n_blocks);
  const dim3 block(kBlockX, kBlockY);
  affine_laplace_ext_3d_kernel<T, K, TX, TY, TZ, PX, PY, PZ>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(blocks, p);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
