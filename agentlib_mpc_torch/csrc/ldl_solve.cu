// Batched solve of L D Lᵀ x = b from a compact LDLᵀ factor: one warp per
// system, no block-wide barrier inside the sweeps.
//
// Replaces agentlib_mpc_tpu/ops/kkt.py::_ldl_solve_kernel (the Pallas TPU
// kernel launched by _ldl_solve_batched). Same function: a forward sweep
// with the unit L (column k, rows > k), division by the pivots D (clamped
// away from zero keeping their sign, |d| >= 1e-30, NaN passes through),
// then a backward sweep with Lᵀ (row k, columns < k). Only the lower
// triangle and the diagonal of the factor are read. One right-hand side
// per system.
//
// Layout: LD batch-major (B, M, M) as written by ldl_factor; b and x
// (B, M); all contiguous, all float32 (ldl_solve_f32) or all float64
// (ldl_solve_f64, the same template in double, with scalar staging and
// twice the shared memory). One block per system.
//
// What bounds it on an H100: the function reads the lower triangle and
// the diagonal of the factor, B x M(M+1)/2 x 4 bytes, plus 2 x B x M x 4
// bytes of vectors (4.6 MB at B=256, M=92: 1.4 us at 3.35 TB/s), against
// 2 M² flops per system. In practice the two M-step sequential sweeps
// bound it: their latency, not bytes or flops.
//
// What held the first design back (one 128-thread block per system):
// each block staged the whole M x M factor, upper junk included, with
// scalar loads and a runtime e / M, e % M per element, and nothing
// overlapped that load; then each of the 2M sweep steps did at most one
// multiply-subtract per thread (at most M-1 of 128 threads busy) and
// ended in a block-wide __syncthreads, so an SM ran a chain of 184
// barriers at M=92 and little else.
//
// This design:
// - stages only the lower triangle (diagonal included) into a packed
//   row-major layout P[i(i+1)/2 + j], with 16-byte loads when M % 4 == 0
//   and the factor is 16-byte aligned (scalar loads otherwise), two rows
//   in flight per warp and no division by M. Eight warps stage; one
//   block-wide barrier follows, before the sweeps;
// - then one warp runs both sweeps. x lives in registers, lane l holding
//   rows l, l+32, ... (R = ceil(M/32) slots, a template parameter so every
//   slot index is static). x_k reaches every lane by __shfl_sync: the
//   sweeps have no barrier and no shared-memory round trip for x;
// - bank conflicts: the forward sweep reads column k, P[T(i) + k] for 32
//   consecutive rows i = 32r + lane; the triangular numbers T(i) modulo 32
//   run through all 32 residues over such a window, so the 32 reads hit 32
//   banks. The backward sweep reads row k, 32 consecutive floats;
// - one system per block, so at B=256 all 132 SMs get work (2 systems per
//   block would leave some idle). Shared memory per block is the packed
//   triangle, M(M+1)/2 floats: 17.1 KB at M=92, 115,680 B at M=240.
// Products and differences are rounded separately (sub_mul_rn) and the
// division is IEEE, in the order of the plain PyTorch version, so the
// result equals it bitwise in either type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ldl_common.cuh"

using namespace ldl;

namespace {

constexpr int kStageWarps = 8;   // warps that stage the factor

// Two blocks per SM serve B=256 on 132 SMs; stating it lets ptxas give a
// thread up to 128 registers (with the thread count alone it aims at full
// occupancy, and spills x at R >= 7).
template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kStageWarps * 32, 2)
ldl_solve_kernel(const T* __restrict__ LD, const T* __restrict__ b,
                 T* __restrict__ x_out, int M) {
  T* P = shared_buffer<T>();  // packed lower triangle, M(M+1)/2 elements
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t sys = blockIdx.x;

  // warp 0 issues its right-hand-side loads before it helps stage
  T x[R];
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      x[r] = i < M ? __ldg(b + sys * M + i) : T(0);
    }
  }
  stage_lower<T, kVec>(LD + sys * M * M, P, M, warp, kStageWarps, lane);
  __syncthreads();  // the factor is staged; the sweeps need no other barrier
  if (warp != 0) return;
  int off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) off[r] = tri(lane + 32 * r);

  // forward: x_i -= L_ik x_k for i > k, k ascending
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int kend = min(32, M - 32 * s);
#pragma unroll 4
    for (int kl = 0; kl < kend; ++kl) {
      const int k = 32 * s + kl;
      const T xk = __shfl_sync(kFullMask, x[s], kl);
#pragma unroll
      for (int r = s; r < R; ++r) {
        const int i = lane + 32 * r;
        if (i > k && i < M) x[r] = sub_mul_rn(x[r], P[off[r] + k], xk);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < M) x[r] = x[r] / safe_d(P[off[r] + i]);
  }
  // backward: x_i -= L_ki x_k for i < k, k descending
#pragma unroll
  for (int s = R - 1; s >= 0; --s) {
    const int kend = min(32, M - 32 * s);
#pragma unroll 4
    for (int kl = kend - 1; kl >= 0; --kl) {
      const int k = 32 * s + kl;
      const T xk = __shfl_sync(kFullMask, x[s], kl);
      const T* rowk = P + tri(k);
#pragma unroll
      for (int r = 0; r <= s; ++r) {
        const int i = lane + 32 * r;
        if (i < k) x[r] = sub_mul_rn(x[r], rowk[i], xk);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < M) x_out[sys * M + i] = x[r];
  }
}

template <typename T>
using SolveKernel = void (*)(const T*, const T*, T*, int);

template <typename T, bool kVec>
SolveKernel<T> pick(int slots) {
  switch (slots) {
    case 1: return ldl_solve_kernel<T, 1, kVec>;
    case 2: return ldl_solve_kernel<T, 2, kVec>;
    case 3: return ldl_solve_kernel<T, 3, kVec>;
    case 4: return ldl_solve_kernel<T, 4, kVec>;
    case 5: return ldl_solve_kernel<T, 5, kVec>;
    case 6: return ldl_solve_kernel<T, 6, kVec>;
    case 7: return ldl_solve_kernel<T, 7, kVec>;
    default: return ldl_solve_kernel<T, 8, kVec>;
  }
}

template <typename T>
long long smem_bytes(int M) {
  return static_cast<long long>(M) * (M + 1) / 2 *
         static_cast<long long>(sizeof(T));
}

template <typename T>
int launch(const void* LD, const void* b, void* x, int B, int M,
           void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = sizeof(T) == 4 && M % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(LD) % 16 == 0;
  const int slots = (M + 31) / 32;
  SolveKernel<T> kernel;
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
  kernel<<<B, kStageWarps * 32, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(LD), static_cast<const T*>(b),
      static_cast<T*>(x), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes the kernel needs for an M x M float32 factor: the
// packed lower triangle; twice that in float64.
extern "C" long long ldl_solve_smem_bytes(int M) {
  return smem_bytes<float>(M);
}

// The largest M the kernel takes.
extern "C" int ldl_solve_max_m() { return kMaxM; }

// LD: device pointer to B contiguous M x M factors; b, x: B contiguous
// vectors of length M; all float32 (ldl_solve_f32) or all float64
// (ldl_solve_f64). stream: a cudaStream_t. Returns the cudaError_t of the
// launch.
extern "C" int ldl_solve_f32(const void* LD, const void* b, void* x, int B,
                             int M, void* stream) {
  return launch<float>(LD, b, x, B, M, stream);
}

extern "C" int ldl_solve_f64(const void* LD, const void* b, void* x, int B,
                             int M, void* stream) {
  return launch<double>(LD, b, x, B, M, stream);
}
