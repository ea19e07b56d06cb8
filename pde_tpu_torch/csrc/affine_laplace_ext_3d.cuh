// Temporally blocked affine Laplacian on halo-extended 3D blocks, for Hopper
// (sm_90a): the 3D kernel's march (affine_laplace_3d.cuh) fed from the
// buffers of a decomposed grid. Hand-written template; its entry points, one
// instantiation per (k, dtype) with the plan the host picks, for one
// periodicity of the three axes, are generated by
// pde_tpu_torch/ops/cuda_ext_3d.py.
//
// Replaces the TPU kernel `make_affine_laplace_ext_3d` of
// pde_tpu/ops/pallas_cartesian.py: for each local block of shape (nx, ny, nz),
// held in a contiguous extended buffer of shape (nx + 2h, ny + 2h, nz + 2h)
// whose halo shell was filled from the neighbouring blocks, one pass computes
//     f <- (a*I + b*lap)^k f,   1 <= k <= h, k <= 4,
// on the block's interior and writes it into the interior of another buffer
// of the same shape. Edge flags (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi) say which
// faces of the block lie on a non-periodic global face; there the cells
// beyond the face are held at zero and the ghost of the face is formed from
// the current level at every step, ghost = c + f1*edge + f2*next_inward, as
// the serial kernel does at the global faces. Elsewhere the halo is trusted:
// it holds the neighbour's (or, on a periodic axis with one block, the
// block's own wrapped) cells.
//
// What bounds it on this card. As the serial kernel: one pass reads each
// buffer cell once (the interior and the halo shell, a factor
// prod_i (n_i + 2h) / n_i of the block) and writes each interior cell once, so
// the bytes per cell-update fall as 1/k.
//
// Design. The serial kernel's march, plan and per-cell update (march_3d,
// affine_update), unchanged, so a decomposed run equals the serial run bit
// for bit; only the window geometry differs. A window cell is read from the
// extended buffer at offset h around the block, with no index wrap; cells
// past the buffer (beyond the chunk's light cone) enter as zero. The serial
// kernel's test of a non-periodic axis becomes the runtime flag of that face;
// a periodic axis never carries a flag, so its test stays a compile-time
// constant. One launch covers up to kMaxExt3DBlocks local blocks of one
// device, which share a shape: blockIdx.z runs over (block, x chunk), and a
// table of pointers and flags is passed by value. Buffer offsets are 64-bit.

#pragma once

#include "affine_laplace_3d.cuh"

namespace pde_tpu_torch {

constexpr int kMaxExt3DBlocks = 8;

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

// The window geometry of one chunk of one extended block: window cell 0 is
// local cell g0; the buffer holds local cells [-h, n + h) of each axis.
template <bool PX, bool PY, bool PZ>
struct ExtGeo {
  static constexpr bool kBounded = !(PX && PY && PZ);
  static constexpr bool kGhostX = !PX, kGhostY = !PY, kGhostZ = !PZ;
  int n[3];
  int g0[3];
  int h;
  int ez;               // z extent of the buffer
  long long x_stride;   // cells per x plane of the buffer
  bool e[6];

  __device__ __forceinline__ MarchColumn column(int y, int z, bool tile) const {
    const int gy = g0[1] + y, gz = g0[2] + z;
    MarchColumn c{0, 0u};
    if (ext_in<PY>(gy, n[1], e[2], e[3]) && ext_in<PZ>(gz, n[2], e[4], e[5])) {
      c.flags = kDomain;
      if (gy < n[1] + h && gz < n[2] + h) {
        c.off = (gy + h) * ez + gz + h;
        c.flags |= kLoad;
      }
      if (!PY && e[2] && gy == 0) c.flags |= kLowEdge;
      if (!PY && e[3] && gy == n[1] - 1) c.flags |= kHighEdge;
      if (!PZ && e[4] && gz == 0) c.flags |= kLowEdgeZ;
      if (!PZ && e[5] && gz == n[2] - 1) c.flags |= kHighEdgeZ;
      if (tile && gy < n[1] && gz < n[2]) c.flags |= kOut;
    }
    return c;
  }

  __device__ __forceinline__ MarchPlane load(int x) const {
    const int gx = g0[0] + x;
    MarchPlane p{static_cast<long long>(gx + h) * x_stride, 0u};
    if (ext_in<PX>(gx, n[0], e[0], e[1]) && gx < n[0] + h) p.flags = kLoad;
    return p;
  }

  __device__ __forceinline__ MarchPlane plane(int x) const {
    const int gx = g0[0] + x;
    MarchPlane p{static_cast<long long>(gx + h) * x_stride, 0u};
    if (ext_in<PX>(gx, n[0], e[0], e[1])) {
      p.flags = kDomain;
      if (!PX && e[0] && gx == 0) p.flags |= kLowEdge;
      if (!PX && e[1] && gx == n[0] - 1) p.flags |= kHighEdge;
    }
    return p;
  }
};

struct ExtShape3D {
  int n[3];      // block shape (x, y, z)
  int halo;      // halo width of the extended buffers
  int chunks_x;  // x chunks per block
};

// Two blocks per SM: 64 registers a thread at most (see affine_laplace_3d.cuh).
template <typename T, int K, int CX, int TY, int TZ, bool PX, bool PY, bool PZ>
__global__ void __launch_bounds__(kMarchThreads, 2)
    affine_laplace_ext_3d_kernel(ExtBlocks3D<T> blocks, ExtShape3D shape, AffineStep<T> st) {
  const int blk = blockIdx.z / shape.chunks_x;
  const int x0 = (blockIdx.z % shape.chunks_x) * CX;  // first output cell of this chunk (local)
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  const int h = shape.halo;
  const int ez = shape.n[2] + 2 * h;
  ExtGeo<PX, PY, PZ> geo;
  for (int a = 0; a < 3; ++a) geo.n[a] = shape.n[a];
  geo.g0[0] = x0 - K;
  geo.g0[1] = y0 - K;
  geo.g0[2] = z0 - K;
  geo.h = h;
  geo.ez = ez;
  geo.x_stride = static_cast<long long>(shape.n[1] + 2 * h) * ez;
#pragma unroll
  for (int f = 0; f < 6; ++f) geo.e[f] = blocks.edge[blk][f] != 0;
  const int planes = min(CX, shape.n[0] - x0) + 2 * K;
  if (st.isotropic) {
    march_3d<true, T, K, TY, TZ>(geo, st, blocks.in[blk], blocks.out[blk], planes);
  } else {
    march_3d<false, T, K, TY, TZ>(geo, st, blocks.in[blk], blocks.out[blk], planes);
  }
}

// Launches one K-step pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of n_blocks device pointers to contiguous
// (nx + 2h, ny + 2h, nz + 2h) buffers; `edges` holds 6 host ints per block.
// `ints` holds 12 host ints: n_blocks, the block shape (x, y, z), the halo h,
// the plan (CX, TY, TZ), k, and the periodicity of each axis, all of which but
// the shapes must be this instantiation's. `doubles` holds 23 host doubles:
// a, b, 1/dx^2 per axis, then (c, f1, f2) of the low and high face of x, y
// and z.
template <typename T, int K, int CX, int TY, int TZ, bool PX, bool PY, bool PZ>
int launch_affine_ext_3d(const void* const* ins, void* const* outs, const int* edges,
                         const int* ints, const double* doubles, void* stream) {
  static_assert(K >= 1 && K <= kMaxSteps, "1 <= k <= 4");
  const int n_blocks = ints[0];
  if (ints[5] != CX || ints[6] != TY || ints[7] != TZ || ints[8] != K || ints[9] != PX ||
      ints[10] != PY || ints[11] != PZ || n_blocks < 1 || n_blocks > kMaxExt3DBlocks) {
    return cudaErrorInvalidValue;
  }
  ExtShape3D shape;
  shape.halo = ints[4];
  for (int a = 0; a < 3; ++a) {
    shape.n[a] = ints[1 + a];
    if (shape.n[a] < shape.halo) return cudaErrorInvalidValue;
  }
  if (shape.halo < K) return cudaErrorInvalidValue;
  if (static_cast<long long>(shape.n[1] + 2 * shape.halo) * (shape.n[2] + 2 * shape.halo) >
      0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  shape.chunks_x = (shape.n[0] + CX - 1) / CX;
  if (static_cast<long long>(shape.chunks_x) * n_blocks > 65535) return cudaErrorInvalidValue;
  const AffineStep<T> st = make_affine_step<T>(doubles);
  ExtBlocks3D<T> blocks;
  for (int z = 0; z < n_blocks; ++z) {
    blocks.in[z] = static_cast<const T*>(ins[z]);
    blocks.out[z] = static_cast<T*>(outs[z]);
    for (int f = 0; f < 6; ++f) blocks.edge[z][f] = edges[6 * z + f];
  }
  constexpr size_t smem = MarchShape<T, K, TY, TZ>::kSmem;
  auto kernel = affine_laplace_ext_3d_kernel<T, K, CX, TY, TZ, PX, PY, PZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((shape.n[2] + TZ - 1) / TZ, (shape.n[1] + TY - 1) / TY,
                  shape.chunks_x * n_blocks);
  kernel<<<grid, kMarchThreads, smem, static_cast<cudaStream_t>(stream)>>>(blocks, shape, st);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
