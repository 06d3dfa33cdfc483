// Helpers shared by ldl_factor.cu and ldl_solve.cu: the served range, the
// pivot clamp, the separately rounded product and difference, and the
// packed lower-triangle layout with its staging. Both kernels are
// templates on the element type T (float or double).

#pragma once

#include <cuda_runtime.h>

namespace ldl {

constexpr int kMaxM = 240;       // the largest M the wrappers route here
constexpr int kMaxSlots = 8;     // ceil(kMaxM / 32)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float tiny_of(float) { return 1e-30f; }
__device__ __forceinline__ double tiny_of(double) { return 1e-30; }

template <typename T>
__device__ __forceinline__ T safe_d(T d) {
  const T tiny = tiny_of(d);
  if (d != d) return d;  // NaN propagates, as jnp.maximum/minimum do
  return d >= T(0) ? (d > tiny ? d : tiny) : (d < -tiny ? d : -tiny);
}

// a - b * c with the product and the difference rounded separately, as
// the plain PyTorch versions compute them (no fused multiply-add)
__device__ __forceinline__ float sub_mul_rn(float a, float b, float c) {
  return __fsub_rn(a, __fmul_rn(b, c));
}
__device__ __forceinline__ double sub_mul_rn(double a, double b, double c) {
  return __dsub_rn(a, __dmul_rn(b, c));
}

// Dynamic shared memory of a kernel on element type T (one extern
// declaration serves every instantiation).
template <typename T>
__device__ __forceinline__ T* shared_buffer() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// Offset of row i in the packed lower triangle.
__device__ __forceinline__ int tri(int i) { return (i * (i + 1)) >> 1; }

// Copy the lower triangle (diagonal included) of the row-major M x M
// matrix src into the packed P. Warp `warp` of `nwarps` takes rows warp,
// warp + nwarps, ...; its lanes take the row's columns. The 16-byte path
// (kVec) is float only.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_lower(const T* __restrict__ src,
                                            T* __restrict__ P, int M,
                                            int warp, int nwarps, int lane) {
  static_assert(!kVec || sizeof(T) == 4, "16-byte staging is float only");
  if constexpr (kVec) {
    // 16-byte chunks c = lane, lane + 32 (M <= 240: at most 60 per row),
    // those with 4c <= i; two rows in flight per warp
    constexpr int kRows = 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int q = M >> 2;
    for (int i0 = warp; i0 < M; i0 += kRows * nwarps) {
      float4 v[kRows][2];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + u * nwarps;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h;
          if (i < M && 4 * c <= i) v[u][h] = __ldg(s4 + i * q + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + u * nwarps;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 4 * (lane + 32 * h);
          if (i < M && j <= i) {
            T* dst = P + tri(i) + j;
            dst[0] = v[u][h].x;
            if (j + 1 <= i) dst[1] = v[u][h].y;
            if (j + 2 <= i) dst[2] = v[u][h].z;
            if (j + 3 <= i) dst[3] = v[u][h].w;
          }
        }
      }
    }
  } else {
    // scalar columns j = lane + 32h <= i, all of a row in flight
    for (int i = warp; i < M; i += nwarps) {
      T v[kMaxSlots];
#pragma unroll
      for (int h = 0; h < kMaxSlots; ++h) {
        const int j = lane + 32 * h;
        if (j <= i) v[h] = __ldg(src + i * M + j);
      }
#pragma unroll
      for (int h = 0; h < kMaxSlots; ++h) {
        const int j = lane + 32 * h;
        if (j <= i) P[tri(i) + j] = v[h];
      }
    }
  }
}

}  // namespace ldl
