// Batched pivot-free LDLᵀ factorization of symmetric quasi-definite KKT
// matrices: lower triangle only, one block-wide barrier per step.
//
// Replaces agentlib_mpc_tpu/ops/kkt.py::_ldl_factor_kernel (the Pallas TPU
// kernel launched by _ldl_factor_batched). Same factor: a right-looking
// LDLᵀ without pivoting. At step k the pivot is clamped away from zero
// keeping its sign (|d| >= 1e-30, NaN passes through), w = A[k+1:, k] is
// the unscaled column, l = w / d, and the lower trailing triangle gets
// a_ij -= l_i w_j for i >= j > k. Output, tril(LD): unit L strictly below
// the diagonal, D on it, zeros above it (written, so the output is
// deterministic). The input is read only on and below its diagonal.
//
// Layout: batch-major (B, M, M) float32 or float64, contiguous; one block
// per matrix. The kernel is a template on the element type: the float64
// instantiation (ldl_factor_f64) runs the same steps in double, with
// scalar staging and twice the shared memory.
//
// What bounds it on an H100: the function reads the lower triangle,
// B x M(M+1)/2 x 4 bytes, and writes B x M² x 4 (13.0 MB at B=256, M=92:
// 3.9 us at 3.35 TB/s), and does about M³/3 flops per matrix. In practice
// the M-step sequential recursion bounds it: each step's latency.
//
// What held the first design back: each of the M steps had two
// block-wide barriers (one after computing l, one after the update), one
// IEEE division per l by all threads, and a read-modify-write of the whole
// trailing square, both triangles (about M³/3 element updates where the
// lower triangle needs M³/6), reading row k because the TPU kernel does.
//
// This design:
// - the matrix lives in shared memory as a packed lower triangle
//   A[i(i+1)/2 + j] (116 KB at M=240, where the padded square of the
//   first design plus the look-ahead's vectors would not fit one block's
//   232,448 B), staged with 16-byte loads when M % 4 == 0 and the input is
//   16-byte aligned, scalar loads otherwise, no division by M;
// - look-ahead: at step k warp 0 updates column k+1 alone, takes its new
//   diagonal as the next pivot (its lanes meet at a __syncwarp, not a
//   block barrier), scales it into l, publishes l and w to the other half
//   of a double-buffered pair of M-vectors, and stores l into the column.
//   Meanwhile the other seven warps do the rest of the trailing update.
//   One __syncthreads per step then both publishes the next column and
//   ends the update; the buffer a step reads is never the one it writes.
//   The pivot chain (load, multiply, subtract, division, stores) thus
//   overlaps the trailing update instead of adding to it;
// - 2-D cyclic layout of the trailing update: column j goes to warp
//   1 + (j mod 7), row i of it to lane i % 32. The work stays balanced as
//   the triangle shrinks, and a warp's 32 lanes read and write 32 rows of
//   one column, whose packed offsets T(i) + j fall in 32 distinct banks
//   (the triangular numbers modulo 32 run through all residues over 32
//   consecutive rows);
// - each lane hoists its rows' l_i into registers once per step (R =
//   ceil(M/32) slots, a template parameter), and each warp reads w_j once
//   per column; four columns are loaded before any is stored, so their
//   shared-memory latencies overlap, and a slot whose 32 rows all lie
//   above the group's first column is skipped by the whole warp.
// Products and differences are rounded separately (sub_mul_rn) and the
// division is IEEE, in the order of the plain PyTorch version, so the
// result equals it bitwise in either type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldl_common.cuh"

using namespace ldl;

namespace {

constexpr int kWarps = 8;       // block = 256 threads
constexpr int kRestWarps = kWarps - 1;  // warps 1.. take the trailing update
constexpr int kGroup = 4;       // columns a rest warp loads before storing

// Write tril(A) as a row-major M x M matrix, zeros above the diagonal.
template <typename T, bool kVec>
__device__ __forceinline__ void write_tril(const T* __restrict__ A,
                                           T* __restrict__ dst, int M,
                                           int warp, int lane) {
  if constexpr (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int q = M >> 2;
    for (int i = warp; i < M; i += kWarps) {
      const T* row = A + tri(i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (c < q) {
          const int j = 4 * c;
          float4 v;
          v.x = j <= i ? row[j] : 0.f;
          v.y = j + 1 <= i ? row[j + 1] : 0.f;
          v.z = j + 2 <= i ? row[j + 2] : 0.f;
          v.w = j + 3 <= i ? row[j + 3] : 0.f;
          d4[i * q + c] = v;
        }
      }
    }
  } else {
    for (int i = warp; i < M; i += kWarps) {
      const T* row = A + tri(i);
#pragma unroll
      for (int h = 0; h < kMaxSlots; ++h) {
        const int j = lane + 32 * h;
        if (j < M) dst[i * M + j] = j <= i ? row[j] : T(0);
      }
    }
  }
}

// Column c of the factor is final in v (lane's rows i = lane + 32r >= c):
// store the raw diagonal (D_c), take d = safe_d(D_c), store l_i = v_i / d
// below it and publish l and w = v to the buffers. Called by one whole
// warp, the look-ahead warp.
template <typename T, int R>
__device__ __forceinline__ void publish_column(T* __restrict__ A,
                                               T* __restrict__ l_out,
                                               T* __restrict__ w_out,
                                               const T (&v)[R],
                                               const int (&off)[R], int c,
                                               int M, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane + 32 * r == c) A[off[r] + c] = v[r];
  }
  __syncwarp(kFullMask);
  const T d = safe_d(A[tri(c) + c]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i > c && i < M) {
      const T li = v[r] / d;
      l_out[i] = li;
      w_out[i] = v[r];
      A[off[r] + c] = li;
    }
  }
}

template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, 2)
ldl_factor_kernel(const T* __restrict__ K, T* __restrict__ LD, int M) {
  T* A = shared_buffer<T>();     // packed lower triangle, tri(M) elements
  T* lbuf = A + tri(M);          // [2][M]: l of the published column
  T* wbuf = lbuf + 2 * M;        // [2][M]: its unscaled w
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * M * M;

  stage_lower<T, kVec>(K + base, A, M, warp, kWarps, lane);
  int off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) off[r] = tri(lane + 32 * r);
  __syncthreads();

  // column 0 is final as loaded; the look-ahead warp publishes it
  if (warp == 0) {
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      v[r] = i < M ? A[off[r]] : T(0);
    }
    publish_column<T, R>(A, lbuf, wbuf, v, off, 0, M, lane);
  }

  for (int k = 0; k + 1 < M; ++k) {
    __syncthreads();  // column k published; step k-1's update done
    const T* l = lbuf + (k & 1) * M;
    const T* w = wbuf + (k & 1) * M;
    T lr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      lr[r] = i > k && i < M ? l[i] : T(0);
    }

    if (warp == 0) {
      // look-ahead: column k+1 first, then publish it for step k+1
      const int c = k + 1;
      const T wc = w[c];
      T v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        v[r] = i >= c && i < M ? sub_mul_rn(A[off[r] + c], lr[r], wc)
                               : T(0);
      }
      publish_column<T, R>(A, lbuf + ((k + 1) & 1) * M,
                        wbuf + ((k + 1) & 1) * M, v, off, c, M, lane);
      continue;
    }

    // the rest of the trailing update: columns j >= k+2, cyclic over the
    // other warps, kGroup columns at a time (all loaded before any store)
    for (int j = k + 2 + (warp - 1 + kRestWarps - (k + 2) % kRestWarps) %
                             kRestWarps;
         j < M; j += kGroup * kRestWarps) {
      T wj[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int jg = j + g * kRestWarps;
        wj[g] = jg < M ? w[jg] : T(0);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (32 * r + 31 < j) continue;  // no row of this slot reaches j
        const int i = lane + 32 * r;
        T v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int jg = j + g * kRestWarps;
          if (i >= jg && i < M) v[g] = A[off[r] + jg];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int jg = j + g * kRestWarps;
          if (i >= jg && i < M) {
            A[off[r] + jg] = sub_mul_rn(v[g], lr[r], wj[g]);
          }
        }
      }
    }
  }
  __syncthreads();

  write_tril<T, kVec>(A, LD + base, M, warp, lane);
}

template <typename T>
using FactorKernel = void (*)(const T*, T*, int);

template <typename T, bool kVec>
FactorKernel<T> pick(int slots) {
  switch (slots) {
    case 1: return ldl_factor_kernel<T, 1, kVec>;
    case 2: return ldl_factor_kernel<T, 2, kVec>;
    case 3: return ldl_factor_kernel<T, 3, kVec>;
    case 4: return ldl_factor_kernel<T, 4, kVec>;
    case 5: return ldl_factor_kernel<T, 5, kVec>;
    case 6: return ldl_factor_kernel<T, 6, kVec>;
    case 7: return ldl_factor_kernel<T, 7, kVec>;
    default: return ldl_factor_kernel<T, 8, kVec>;
  }
}

template <typename T>
long long smem_bytes(int M) {
  return (static_cast<long long>(M) * (M + 1) / 2 + 4LL * M) *
         static_cast<long long>(sizeof(T));
}

template <typename T>
int launch(const void* K, void* LD, int B, int M, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = sizeof(T) == 4 && M % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(K) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(LD) % 16 == 0;
  const int slots = (M + 31) / 32;
  FactorKernel<T> kernel;
  if constexpr (sizeof(T) == 4) {
    kernel = vec ? pick<T, true>(slots) : pick<T, false>(slots);
  } else {
    kernel = pick<T, false>(slots);
  }
  const long long smem = smem_bytes<T>(M);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, kWarps * 32, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(LD), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes the kernel needs for an M x M float32 matrix: the
// packed lower triangle and two pairs of M-vectors (l and w,
// double-buffered); twice that in float64.
extern "C" long long ldl_factor_smem_bytes(int M) {
  return smem_bytes<float>(M);
}

// The largest M the kernel takes.
extern "C" int ldl_factor_max_m() { return kMaxM; }

// K, LD: device pointers to B contiguous float32 (ldl_factor_f32) or
// float64 (ldl_factor_f64) M x M matrices. stream: a cudaStream_t.
// Returns the cudaError_t of the launch.
extern "C" int ldl_factor_f32(const void* K, void* LD, int B, int M,
                              void* stream) {
  return launch<float>(K, LD, B, M, stream);
}

extern "C" int ldl_factor_f64(const void* K, void* LD, int B, int M,
                              void* stream) {
  return launch<double>(K, LD, B, M, stream);
}
