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
// for bit; only the window geometry differs (ExtGeo of march_3d.cuh). A window cell is read from the
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

template <typename T>
struct ExtBlocks3D {
  const T* in[kMaxExt3DBlocks];
  T* out[kMaxExt3DBlocks];
  int edge[kMaxExt3DBlocks][6];  // x_lo, x_hi, y_lo, y_hi, z_lo, z_hi
};

// Two blocks per SM: 64 registers a thread at most (see affine_laplace_3d.cuh).
template <typename T, int K, int CX, int TY, int TZ, bool PX, bool PY, bool PZ>
__global__ void __launch_bounds__(kMarchThreads, 2)
    affine_laplace_ext_3d_kernel(ExtBlocks3D<T> blocks, ExtShape3D shape, AffineStep<T> st) {
  const int blk = blockIdx.z / shape.chunks_x;
  const int x0 = (blockIdx.z % shape.chunks_x) * CX;  // first output cell of this chunk (local)
  const ExtGeo<PX, PY, PZ> geo = ext_geo<PX, PY, PZ, K, CX, TY, TZ>(shape, blocks.edge, blk);
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
      ints[10] != PY || ints[11] != PZ) {
    return cudaErrorInvalidValue;
  }
  bool ok = false;
  const ExtShape3D shape = ext_shape<K, CX>(ints + 1, ints[4], n_blocks, ok);
  if (!ok) return cudaErrorInvalidValue;
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
