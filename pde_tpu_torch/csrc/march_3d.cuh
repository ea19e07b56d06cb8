// The window geometry of the x-marching (2.5D) 3D kernels, for Hopper (sm_90a):
// shared by the affine Laplacian kernels (affine_laplace_3d.cuh,
// affine_laplace_ext_3d.cuh) and the generated multi-field kernels
// (multi_stencil_3d.cuh).
//
// A march block of kMarchThreads threads owns a TY x TZ output column tile in
// (y, z) and a chunk of x planes; its window plane carries H cells of halo
// on each side of the tile along y and z, and the block marches through the
// chunk plus H planes of x halo on each side. Each thread owns fixed window
// columns (y, z), dealt linearly over the window plane so that neighbouring
// threads hold neighbouring z, and computes once, at the start, each
// column's offset in a plane of the buffer (periodic axes wrapped there,
// once), its ring depth in the window and its flags. A geometry (GridGeo for
// a serial grid, ExtGeo for an extended block of a decomposed grid) answers
// three questions: `column(y, z, tile)`, `load(x)` for the planes read, and
// `plane(x)` for the planes computed, whose offsets serve only the chunk's
// own planes. Cells outside the domain hold zero at every level; a face with
// ghosts is flagged on the cell next to it (kLowEdge, ...), where the
// kernels form the ghost from that cell and its inward neighbour.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace pde_tpu_torch {

// Threads of a march block.
constexpr int kMarchThreads = 512;
// Local blocks one launch of an ext kernel covers (blockIdx.z runs over them).
constexpr int kMaxExt3DBlocks = 8;

__device__ __forceinline__ int wrap_index(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Flags of a window column (y, z) or of a window plane (x).
enum : unsigned {
  kLoad = 1u,         // read from the input buffer (else it enters as zero)
  kDomain = 2u,       // in the domain (else every level holds zero there)
  kLowEdge = 4u,      // the cell next to a low face with ghosts (x of a plane, y of a column)
  kHighEdge = 8u,     // ... next to a high face
  kLowEdgeZ = 16u,    // z of a column
  kHighEdgeZ = 32u,
  kOut = 64u,         // a column of the output tile that lies in the grid
};
constexpr int kDepthShift = 8;  // a column's ring depth in the window, plus one, above the flags

struct MarchColumn {
  int off;  // offset of the column in a plane of the buffer
  unsigned flags;
};

struct MarchPlane {
  long long off;  // offset of the plane in the buffer (of a plane in the grid, for `plane`)
  unsigned flags;
};

// The window plane of a march with H cells of halo around a TY x TZ column tile.
template <int H, int TY, int TZ>
struct MarchWindow {
  static constexpr int kWY = TY + 2 * H, kWZ = TZ + 2 * H, kPlane = kWY * kWZ;
  static constexpr int kCols = (kPlane + kMarchThreads - 1) / kMarchThreads;  // columns per thread
};

// This thread's columns, q = threadIdx.x + m * kMarchThreads of the window
// plane: the column's offset, and its flags with its ring depth plus one above
// kDepthShift (0 past the plane); a column at depth H or more is in the tile.
template <int H, int TY, int TZ, class Geo>
__device__ __forceinline__ void march_columns(const Geo& geo,
                                              int (&off)[MarchWindow<H, TY, TZ>::kCols],
                                              unsigned (&flags)[MarchWindow<H, TY, TZ>::kCols]) {
  using W = MarchWindow<H, TY, TZ>;
#pragma unroll
  for (int m = 0; m < W::kCols; ++m) {
    const int q = threadIdx.x + m * kMarchThreads;
    off[m] = 0;
    flags[m] = 0u;
    if (q < W::kPlane) {
      const int y = q / W::kWZ, z = q - (q / W::kWZ) * W::kWZ;
      const int depth = min(min(y, W::kWY - 1 - y), min(z, W::kWZ - 1 - z));
      const MarchColumn c = geo.column(y, z, depth >= H);
      off[m] = c.off;
      flags[m] = c.flags | (unsigned(depth + 1) << kDepthShift);
    }
  }
}

// The window geometry of one block of a serial kernel: window cell 0 is grid
// cell g0; periodic axes wrap (once per column or plane), cells outside a
// non-periodic axis are outside the domain.
template <bool PX, bool PY, bool PZ>
struct GridGeo {
  static constexpr bool kBounded = !(PX && PY && PZ);
  static constexpr bool kGhostX = !PX, kGhostY = !PY, kGhostZ = !PZ;
  int n[3];
  int g0[3];

  __device__ __forceinline__ MarchColumn column(int y, int z, bool tile) const {
    const int gy = g0[1] + y, gz = g0[2] + z;
    MarchColumn c{0, 0u};
    if ((PY || (gy >= 0 && gy < n[1])) && (PZ || (gz >= 0 && gz < n[2]))) {
      const int ry = PY ? wrap_index(gy, n[1]) : gy;
      const int rz = PZ ? wrap_index(gz, n[2]) : gz;
      c.off = ry * n[2] + rz;
      c.flags = kLoad | kDomain;
      if (!PY && gy == 0) c.flags |= kLowEdge;
      if (!PY && gy == n[1] - 1) c.flags |= kHighEdge;
      if (!PZ && gz == 0) c.flags |= kLowEdgeZ;
      if (!PZ && gz == n[2] - 1) c.flags |= kHighEdgeZ;
      if (tile && gy < n[1] && gz < n[2]) c.flags |= kOut;
    }
    return c;
  }

  __device__ __forceinline__ MarchPlane load(int x) const {
    const int gx = g0[0] + x;
    MarchPlane p{0, 0u};
    if (PX || (gx >= 0 && gx < n[0])) {
      p.off = static_cast<long long>(PX ? wrap_index(gx, n[0]) : gx) * n[1] * n[2];
      p.flags = kLoad;
    }
    return p;
  }

  __device__ __forceinline__ MarchPlane plane(int x) const {
    const int gx = g0[0] + x;
    MarchPlane p{static_cast<long long>(gx) * n[1] * n[2], 0u};
    if (PX || (gx >= 0 && gx < n[0])) {
      p.flags = kDomain;
      if (!PX && gx == 0) p.flags |= kLowEdge;
      if (!PX && gx == n[0] - 1) p.flags |= kHighEdge;
    }
    return p;
  }
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

// The ExtGeo of the chunk that blockIdx selects (blockIdx.z runs over
// (block, x chunk)), for a march with H cells of halo and chunks of CX planes
// by TY x TZ column tiles; `edges` holds each block's six face flags.
template <bool PX, bool PY, bool PZ, int H, int CX, int TY, int TZ>
__device__ __forceinline__ ExtGeo<PX, PY, PZ> ext_geo(const ExtShape3D& shape,
                                                      const int (&edges)[kMaxExt3DBlocks][6],
                                                      int blk) {
  const int x0 = (blockIdx.z % shape.chunks_x) * CX;  // first output cell of this chunk (local)
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.x * TZ;
  ExtGeo<PX, PY, PZ> geo;
  for (int a = 0; a < 3; ++a) geo.n[a] = shape.n[a];
  geo.g0[0] = x0 - H;
  geo.g0[1] = y0 - H;
  geo.g0[2] = z0 - H;
  geo.h = shape.halo;
  geo.ez = shape.n[2] + 2 * shape.halo;
  geo.x_stride = static_cast<long long>(shape.n[1] + 2 * shape.halo) * geo.ez;
#pragma unroll
  for (int f = 0; f < 6; ++f) geo.e[f] = edges[blk][f] != 0;
  return geo;
}

// The shape checks of an ext launch at halo H: returns the shape (chunks of
// CX planes) or sets `ok` to false.
template <int H, int CX>
ExtShape3D ext_shape(const int* n, int halo, int n_blocks, bool& ok) {
  ExtShape3D shape;
  shape.halo = halo;
  ok = n_blocks >= 1 && n_blocks <= kMaxExt3DBlocks && halo >= H;
  for (int a = 0; a < 3; ++a) {
    shape.n[a] = n[a];
    ok = ok && n[a] >= halo;
  }
  ok = ok && static_cast<long long>(n[1] + 2 * halo) * (n[2] + 2 * halo) <= 0x7fffffffLL;
  shape.chunks_x = ok ? (n[0] + CX - 1) / CX : 1;
  ok = ok && static_cast<long long>(shape.chunks_x) * n_blocks <= 65535;
  return shape;
}

}  // namespace pde_tpu_torch
