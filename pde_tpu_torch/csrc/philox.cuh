// Philox4x32-10 and the Euler-Maruyama increment laws, for the in-kernel
// noise of the SDE window (Hopper, sm_90a). Hand-written.
//
// Replaces the TPU hardware generator of `_make_kernel_noise_gen` in
// pde_tpu/ops/pallas_cartesian.py (used by the kernel
// `make_fused_sde_kernel_noise_window_2d`). A GPU has no such generator, so the
// kernel runs a counter-based one: Philox4x32-10 (Salmon et al., SC'11; the
// Random123 constants), keyed by the window's two seed words, with the counter
// (global step, global row, global column, 0). The stream is thus a pure
// function of the global cell: every tile that recomputes a halo cell adds the
// same increment, whatever the tile and the steps per pass. (The TPU kernel
// buys the same property by reseeding per 8-row granule.)
//
// pde_tpu_torch/ops/philox.py computes the same words and floats with torch
// integer tensors; it is this stream's plain version. From words to floats,
// the same in both files, in the working type T (float or double):
//   uniform      T(w >> 8) * 2^-24, the top 24 bits (exact in both types;
//                double uses the same 24 bits);
//   normal       Box-Muller on words 0 and 1:
//                sqrt(-2 log(max(u0, 2^-24))) * cos(2 pi u1);
//   irwin4       (((u0 + u1) + u2) + u3 - 2) * sqrt(3), summed in that order;
//   rademacher   1 - 2 * (w0 >> 31).
// The increment is that unit value times the scale sqrt(dt var / cell_volume),
// multiplied with round-to-nearest intrinsics so that the compiler cannot fuse
// it into the add that follows.
//
// What bounds it on this card: ten rounds of two 32-bit multiply-highs, two
// multiplies and a key schedule per cell and step, on the integer pipe, and no
// device-memory traffic at all (the staged variant reads one extra plane per
// step instead).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pde_tpu_torch {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

enum IncrementLaw { kNormal = 0, kIrwin4 = 1, kRademacher = 2 };

template <typename T>
__device__ __forceinline__ T uniform24(uint32_t w) {
  return T(w >> 8) * T(5.9604644775390625e-08);  // 2^-24
}

template <typename T, int LAW>
__device__ __forceinline__ T unit_increment(uint4 w) {
  if constexpr (LAW == kNormal) {
    const T two_m24 = T(5.9604644775390625e-08);
    const T u0 = uniform24<T>(w.x);
    const T u1 = u0 > two_m24 ? u0 : two_m24;
    const T u2 = uniform24<T>(w.y);
    return sqrt(T(-2) * log(u1)) * cos(T(6.283185307179586) * u2);
  } else if constexpr (LAW == kIrwin4) {
    T total = uniform24<T>(w.x) + uniform24<T>(w.y);
    total = total + uniform24<T>(w.z);
    total = total + uniform24<T>(w.w);
    return (total - T(2)) * T(1.7320508075688772);
  } else {
    return T(1) - T(2) * T(w.x >> 31);
  }
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Noise policy of the Euler-Maruyama window (sde_window_2d_kernel in
// multi_stencil_2d.cuh, beside StagedNoise): the increment of pass step s at
// the global cell (r, c), drawn in the kernel where it is added.
template <typename T, int LAW>
struct PhiloxNoise {
  static constexpr bool kStaged = false;
  uint32_t key0;
  uint32_t key1;
  uint32_t step0;  // global step of the pass's first step
  T scale;

  __device__ __forceinline__ T at(int s, int r, int c) const {
    const uint4 w = philox4x32_10(
        make_uint4(step0 + static_cast<uint32_t>(s), static_cast<uint32_t>(r),
                   static_cast<uint32_t>(c), 0u),
        key0, key1);
    return mul_rn(unit_increment<T, LAW>(w), scale);
  }
};

}  // namespace pde_tpu_torch
