// Temporally blocked k-step window of an arbitrary stencil rhs over n coupled
// 3D fields, for Hopper (sm_90a). Hand-written template; the per-rhs part is
// generated by pde_tpu_torch/ops/cuda_stencil_3d.py.
//
// Replaces two TPU kernels of pde_tpu/ops/pallas_cartesian.py that compute
// the same function, k explicit Euler steps of one rhs over n field volumes:
// `make_fused_multi_stencil_window_3d` (x bands of whole (y, z) planes) and
// `_make_ychunk_multi_window_3d` (x bands by y chunks, for planes past 96 KB
// of VMEM). The split between them is a VMEM artefact; a Hopper block has to
// tile all three axes anyway, so one template with 3D tiles serves both. The
// rhs is built from 7-point Laplacians, squared gradients, central
// derivatives along x, y and z, and pointwise math (Allen-Cahn, Cahn-Hilliard,
// Brusselator, ...).
//
// What the generated program supplies, as a struct P (the contract of
// multi_stencil_2d.cuh, with a third axis):
//   P::kFields, P::kBuffers, P::kDepth           field volumes, operand buffers,
//                                                halo cells consumed per step;
//   P::kXPeriodic, P::kYPeriodic, P::kZPeriodic  the grid's periodicity;
//   template <class T> static void P::level(const Level3D<T, ...>& L, int h)
//     one Euler step on the current field buffers, valid on the window region
//     of halo h: it fills the operand buffers (each stencil operator's operand
//     that is not a bare field, over the region it is needed on, with
//     __syncthreads() between groups) and writes the next level of every field
//     over halo h - kDepth into L.nxt. Stencil reads substitute the affine
//     ghost value (c + f1*edge + f2*next_inward) of the operand itself where
//     the cell sits on a non-periodic global face; stencils read face
//     neighbours only, so a cell outside two non-periodic faces is never read.
//
// Design. Each block owns a TX x TY x TZ output tile and loads a window of
// every field with halos of H0 = K * kDepth cells on all six faces into shared
// memory. z is the contiguous axis; the window is one warp (32 cells) wide
// along it (TZ = 32 - 2*H0), so its rows load coalesced. Periodic halos wrap
// by index (more than once on small grids), cells outside a non-periodic
// domain are held at zero, and the window shrinks by kDepth cells per face per
// step. Every buffer shares the window's layout, so one index addresses all
// volumes. The field volumes are ping-ponged; the input is never written. K
// and the tile are chosen on the host from a shared-memory budget per
// (volumes, depth, dtype), so that two blocks fit on one SM. Global offsets
// are 64-bit.
//
// What bounds it on this card. One pass reads and writes every field once, so
// device-memory bytes per cell-update fall as 1/K (8 B per fp32 field at
// K = 1). The recomputed halo shell costs a factor prod_i (T_i + 2*H0) / T_i
// of the updates at the first step, which grows fast with K in 3D; with the
// rhs arithmetic and the shared-memory traffic of its stencil reads it sets
// the pace past small K.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pde_tpu_torch {

constexpr int kBlock3X = 32;    // threads along z
constexpr int kBlock3Y = 8;     // threads along y
constexpr int kLoadBatch3 = 8;  // x planes whose loads a thread has in flight at once

// The field and operand volumes of one level, in shared memory.
template <typename T, int NF, int NB>
struct Level3D {
  T* cur[NF];
  T* nxt[NF];
  T* buf[NB > 0 ? NB : 1];
  int wy, wz;   // window extents along y and z (strides: wy * wz per x, wz per y)
  int h0;       // halo of the window on the first level
  int tile[3];  // output tile
  int g0[3];    // global cell of window cell (0, 0, 0)
  int n[3];     // grid shape (a block's shape in the ext kernel)
  int edge[6];  // ext kernel: x_lo, x_hi, y_lo, y_hi, z_lo, z_hi global-face flags
};

template <typename T, int NF>
struct FieldPtrs3D {
  const T* in[NF];
  T* out[NF];
};

__device__ __forceinline__ int wrap_index_3d(int i, int n) { return ((i % n) + n) % n; }

// Calls body(idx, gx, gy, gz, inside) for every cell of the window region with
// halo h: window index, global coordinates, and whether it lies in the domain.
template <bool PX, bool PY, bool PZ, typename L, class F>
__device__ __forceinline__ void for_each_cell_3d(const L& lv, int h, F&& body) {
  const int lo = lv.h0 - h;
  const int hx = lv.h0 + lv.tile[0] + h;
  const int hy = lv.h0 + lv.tile[1] + h;
  const int hz = lv.h0 + lv.tile[2] + h;
  const int plane = lv.wy * lv.wz;
  for (int i = lo; i < hx; ++i) {
    const int gx = lv.g0[0] + i;
    const bool x_in = PX || (gx >= 0 && gx < lv.n[0]);
    for (int j = lo + static_cast<int>(threadIdx.y); j < hy; j += kBlock3Y) {
      const int gy = lv.g0[1] + j;
      const bool y_in = PY || (gy >= 0 && gy < lv.n[1]);
      for (int l = lo + static_cast<int>(threadIdx.x); l < hz; l += kBlock3X) {
        const int gz = lv.g0[2] + l;
        const bool z_in = PZ || (gz >= 0 && gz < lv.n[2]);
        body(i * plane + j * lv.wz + l, gx, gy, gz, x_in && y_in && z_in);
      }
    }
  }
}

// for_each_cell_3d of the ext kernel: a cell is outside the domain only beyond
// a face whose global-face flag is set (local coordinates gx, gy, gz of the
// block). A periodic axis never carries a flag, so PX/PY/PZ drop its test at
// compile time.
template <bool PX, bool PY, bool PZ, typename L, class F>
__device__ __forceinline__ void for_each_cell_ext_3d(const L& lv, int h, F&& body) {
  const int lo = lv.h0 - h;
  const int hx = lv.h0 + lv.tile[0] + h;
  const int hy = lv.h0 + lv.tile[1] + h;
  const int hz = lv.h0 + lv.tile[2] + h;
  const int plane = lv.wy * lv.wz;
  for (int i = lo; i < hx; ++i) {
    const int gx = lv.g0[0] + i;
    const bool x_in = PX || ((!lv.edge[0] || gx >= 0) && (!lv.edge[1] || gx < lv.n[0]));
    for (int j = lo + static_cast<int>(threadIdx.y); j < hy; j += kBlock3Y) {
      const int gy = lv.g0[1] + j;
      const bool y_in = PY || ((!lv.edge[2] || gy >= 0) && (!lv.edge[3] || gy < lv.n[1]));
      for (int l = lo + static_cast<int>(threadIdx.x); l < hz; l += kBlock3X) {
        const int gz = lv.g0[2] + l;
        const bool z_in = PZ || ((!lv.edge[4] || gz >= 0) && (!lv.edge[5] || gz < lv.n[2]));
        body(i * plane + j * lv.wz + l, gx, gy, gz, x_in && y_in && z_in);
      }
    }
  }
}

template <class P, typename T, int K, int TX, int TY, int TZ>
__global__ void __launch_bounds__(kBlock3X * kBlock3Y)
    multi_stencil_3d_kernel(FieldPtrs3D<T, P::kFields> io, int nx, int ny, int nz) {
  constexpr int NF = P::kFields;
  constexpr int NB = P::kBuffers;
  constexpr int H0 = K * P::kDepth;
  constexpr int WX = TX + 2 * H0;
  constexpr int WY = TY + 2 * H0;
  constexpr int WZ = TZ + 2 * H0;
  constexpr int WV = WX * WY * WZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  Level3D<T, NF, NB> lv;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    lv.cur[f] = smem + f * WV;
    lv.nxt[f] = smem + (NF + f) * WV;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) lv.buf[b] = smem + (2 * NF + b) * WV;
  const int x0 = blockIdx.z * TX;  // first output cell of this tile
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  lv.wy = WY;
  lv.wz = WZ;
  lv.h0 = H0;
  lv.tile[0] = TX;
  lv.tile[1] = TY;
  lv.tile[2] = TZ;
  lv.g0[0] = x0 - H0;
  lv.g0[1] = y0 - H0;
  lv.g0[2] = z0 - H0;
  lv.n[0] = nx;
  lv.n[1] = ny;
  lv.n[2] = nz;

  // load the window of every field; cells outside a non-periodic domain are
  // zero. A thread owns (y, z) columns and starts the loads of kLoadBatch3 x
  // planes before it stores them, so that their latencies overlap.
  const size_t x_stride = static_cast<size_t>(ny) * nz;
  for (int j = threadIdx.y; j < WY; j += kBlock3Y) {
    const int gy = lv.g0[1] + j;
    const bool y_in = P::kYPeriodic || (gy >= 0 && gy < ny);
    const int ry = P::kYPeriodic ? wrap_index_3d(gy, ny) : gy;
    for (int l = threadIdx.x; l < WZ; l += kBlock3X) {
      const int gz = lv.g0[2] + l;
      const bool yz_in = y_in && (P::kZPeriodic || (gz >= 0 && gz < nz));
      const int rz = P::kZPeriodic ? wrap_index_3d(gz, nz) : gz;
      const size_t column = static_cast<size_t>(ry) * nz + rz;
#pragma unroll
      for (int i0 = 0; i0 < WX; i0 += kLoadBatch3) {
        T v[NF][kLoadBatch3];
#pragma unroll
        for (int u = 0; u < kLoadBatch3; ++u) {
          const int gx = lv.g0[0] + i0 + u;
          const bool inside =
              i0 + u < WX && yz_in && (P::kXPeriodic || (gx >= 0 && gx < nx));
          const int rx = P::kXPeriodic ? wrap_index_3d(gx, nx) : gx;
#pragma unroll
          for (int f = 0; f < NF; ++f) v[f][u] = inside ? io.in[f][rx * x_stride + column] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch3; ++u) {
          if (i0 + u < WX) {
#pragma unroll
            for (int f = 0; f < NF; ++f) lv.cur[f][((i0 + u) * WY + j) * WZ + l] = v[f][u];
          }
        }
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < K; ++s) {
    P::template level<T>(lv, (K - s) * P::kDepth);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T* tmp = lv.cur[f];
      lv.cur[f] = lv.nxt[f];
      lv.nxt[f] = tmp;
    }
  }

  // write the centre tile of every field
  for (int i = 0; i < TX && x0 + i < nx; ++i) {
    for (int j = threadIdx.y; j < TY && y0 + j < ny; j += kBlock3Y) {
      for (int l = threadIdx.x; l < TZ && z0 + l < nz; l += kBlock3X) {
        const size_t dst = (static_cast<size_t>(x0 + i) * ny + y0 + j) * nz + z0 + l;
        const int src = ((i + H0) * WY + j + H0) * WZ + l + H0;
#pragma unroll
        for (int f = 0; f < NF; ++f) io.out[f][dst] = lv.cur[f][src];
      }
    }
  }
}

// Launches one K-step pass on `stream` without synchronising; returns the CUDA
// error of the launch (0 on success). `ins` and `outs` are host arrays of
// P::kFields device pointers.
template <class P, typename T, int K, int TX, int TY, int TZ>
int launch_3d(const void* const* ins, void* const* outs, int nx, int ny, int nz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  constexpr int NF = P::kFields;
  constexpr int H0 = K * P::kDepth;
  constexpr size_t WV = static_cast<size_t>(TX + 2 * H0) * (TY + 2 * H0) * (TZ + 2 * H0);
  FieldPtrs3D<T, NF> io;
  for (int f = 0; f < NF; ++f) {
    io.in[f] = static_cast<const T*>(ins[f]);
    io.out[f] = static_cast<T*>(outs[f]);
  }
  const size_t smem = static_cast<size_t>(2 * NF + P::kBuffers) * WV * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(multi_stencil_3d_kernel<P, T, K, TX, TY, TZ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  const dim3 block(kBlock3X, kBlock3Y);
  multi_stencil_3d_kernel<P, T, K, TX, TY, TZ>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(io, nx, ny, nz);
  return cudaGetLastError();
}

// -- the ext kernel ---------------------------------------------------------------
//
// Replaces the TPU kernel `make_fused_multi_ext_window_3d` (and the `ext_x`
// mode of `_make_ychunk_multi_window_3d`, its x-cut form for large planes; the
// split is a VMEM matter): the window above on the local blocks of a
// decomposed grid. Every field of a block lives in a contiguous extended
// buffer of shape (nx + 2*halo, ny + 2*halo, nz + 2*halo) whose halo shell the
// caller filled from the neighbouring blocks (halo >= K*kDepth); the window is
// read from it at offset (halo - K*kDepth) around the tile, with no index
// wrap, and the tile is written into the interior of the output buffers. A
// block's face flags replace the periodicity of the non-periodic axes: beyond
// a flagged face the cells are held at zero and the operands' affine ghosts
// are substituted, elsewhere the halo is trusted. The generated program of an
// ext kernel reads Level3D::edge (its ghost tests are `L.edge[s] && gx == 0`,
// ...) and sweeps with for_each_cell_ext_3d. One launch covers up to
// kMaxExt3DBlocks blocks of one device: blockIdx.z runs over (block, x tile)
// and indexes a table of pointers and flags. Buffer offsets are 64-bit.

constexpr int kMaxExt3DBlocks = 8;

template <typename T, int NF>
struct ExtFieldPtrs3D {
  const T* in[kMaxExt3DBlocks][NF];
  T* out[kMaxExt3DBlocks][NF];
  int edge[kMaxExt3DBlocks][6];
};

template <class P, typename T, int K, int TX, int TY, int TZ>
__global__ void __launch_bounds__(kBlock3X * kBlock3Y)
    multi_stencil_ext_3d_kernel(ExtFieldPtrs3D<T, P::kFields> io, int nx, int ny, int nz,
                                int halo, int tiles_x) {
  constexpr int NF = P::kFields;
  constexpr int NB = P::kBuffers;
  constexpr int H0 = K * P::kDepth;
  constexpr int WX = TX + 2 * H0;
  constexpr int WY = TY + 2 * H0;
  constexpr int WZ = TZ + 2 * H0;
  constexpr int WV = WX * WY * WZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int blk = blockIdx.z / tiles_x;

  Level3D<T, NF, NB> lv;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    lv.cur[f] = smem + f * WV;
    lv.nxt[f] = smem + (NF + f) * WV;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) lv.buf[b] = smem + (2 * NF + b) * WV;
  const int x0 = (blockIdx.z % tiles_x) * TX;  // first output cell of this tile (local)
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  lv.wy = WY;
  lv.wz = WZ;
  lv.h0 = H0;
  lv.tile[0] = TX;
  lv.tile[1] = TY;
  lv.tile[2] = TZ;
  lv.g0[0] = x0 - H0;
  lv.g0[1] = y0 - H0;
  lv.g0[2] = z0 - H0;
  lv.n[0] = nx;
  lv.n[1] = ny;
  lv.n[2] = nz;
#pragma unroll
  for (int e = 0; e < 6; ++e) lv.edge[e] = io.edge[blk][e];

  // load the window of every field; cells beyond a flagged face, and past the
  // buffer (beyond the tiles' light cone), are zero. A thread owns (y, z)
  // columns and starts the loads of kLoadBatch3 x planes before it stores them.
  const int ez = nz + 2 * halo;  // extended extents: the buffers' strides
  const size_t x_stride = static_cast<size_t>(ny + 2 * halo) * ez;
  for (int j = threadIdx.y; j < WY; j += kBlock3Y) {
    const int gy = lv.g0[1] + j;
    const bool y_in =
        (P::kYPeriodic || ((!lv.edge[2] || gy >= 0) && (!lv.edge[3] || gy < ny))) &&
        gy < ny + halo;
    for (int l = threadIdx.x; l < WZ; l += kBlock3X) {
      const int gz = lv.g0[2] + l;
      const bool yz_in =
          y_in && (P::kZPeriodic || ((!lv.edge[4] || gz >= 0) && (!lv.edge[5] || gz < nz))) &&
          gz < nz + halo;
      const size_t column = static_cast<size_t>(gy + halo) * ez + gz + halo;
#pragma unroll
      for (int i0 = 0; i0 < WX; i0 += kLoadBatch3) {
        T v[NF][kLoadBatch3];
#pragma unroll
        for (int u = 0; u < kLoadBatch3; ++u) {
          const int gx = lv.g0[0] + i0 + u;
          const bool inside =
              i0 + u < WX && yz_in &&
              (P::kXPeriodic || ((!lv.edge[0] || gx >= 0) && (!lv.edge[1] || gx < nx))) &&
              gx < nx + halo;
          const size_t src = static_cast<size_t>(gx + halo) * x_stride + column;
#pragma unroll
          for (int f = 0; f < NF; ++f) v[f][u] = inside ? io.in[blk][f][src] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch3; ++u) {
          if (i0 + u < WX) {
#pragma unroll
            for (int f = 0; f < NF; ++f) lv.cur[f][((i0 + u) * WY + j) * WZ + l] = v[f][u];
          }
        }
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < K; ++s) {
    P::template level<T>(lv, (K - s) * P::kDepth);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T* tmp = lv.cur[f];
      lv.cur[f] = lv.nxt[f];
      lv.nxt[f] = tmp;
    }
  }

  // write the centre tile of every field into the output buffers' interiors
  for (int i = 0; i < TX && x0 + i < nx; ++i) {
    for (int j = threadIdx.y; j < TY && y0 + j < ny; j += kBlock3Y) {
      for (int l = threadIdx.x; l < TZ && z0 + l < nz; l += kBlock3X) {
        const size_t dst = static_cast<size_t>(x0 + i + halo) * x_stride +
                           static_cast<size_t>(y0 + j + halo) * ez + z0 + l + halo;
        const int src = ((i + H0) * WY + j + H0) * WZ + l + H0;
#pragma unroll
        for (int f = 0; f < NF; ++f) io.out[blk][f][dst] = lv.cur[f][src];
      }
    }
  }
}

// Launches one K-step ext pass over n_blocks blocks on `stream` without
// synchronising; returns the CUDA error of the launch (0 on success). `ins`
// and `outs` are host arrays of n_blocks * P::kFields pointers (block major)
// to contiguous extended buffers; `edges` holds 6 host ints per block.
template <class P, typename T, int K, int TX, int TY, int TZ>
int launch_ext_3d(const void* const* ins, void* const* outs, const int* edges, int n_blocks,
                  int nx, int ny, int nz, int halo, void* stream) {
  constexpr int NF = P::kFields;
  constexpr int H0 = K * P::kDepth;
  constexpr size_t WV = static_cast<size_t>(TX + 2 * H0) * (TY + 2 * H0) * (TZ + 2 * H0);
  if (n_blocks < 1 || n_blocks > kMaxExt3DBlocks || halo < H0 || nx < halo || ny < halo ||
      nz < halo)
    return cudaErrorInvalidValue;
  const int tiles_x = (nx + TX - 1) / TX;
  if (static_cast<long long>(tiles_x) * n_blocks > 65535) return cudaErrorInvalidValue;
  ExtFieldPtrs3D<T, NF> io;
  for (int z = 0; z < n_blocks; ++z) {
    for (int f = 0; f < NF; ++f) {
      io.in[z][f] = static_cast<const T*>(ins[z * NF + f]);
      io.out[z][f] = static_cast<T*>(outs[z * NF + f]);
    }
    for (int e = 0; e < 6; ++e) io.edge[z][e] = edges[6 * z + e];
  }
  const size_t smem = static_cast<size_t>(2 * NF + P::kBuffers) * WV * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(multi_stencil_ext_3d_kernel<P, T, K, TX, TY, TZ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, tiles_x * n_blocks);
  const dim3 block(kBlock3X, kBlock3Y);
  multi_stencil_ext_3d_kernel<P, T, K, TX, TY, TZ>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(io, nx, ny, nz, halo, tiles_x);
  return cudaGetLastError();
}

}  // namespace pde_tpu_torch
