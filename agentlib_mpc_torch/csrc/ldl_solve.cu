// Batched solve of L D Lᵀ x = b from a compact LDLᵀ factor, one thread
// block per system.
//
// Replaces agentlib_mpc_tpu/ops/kkt.py::_ldl_solve_kernel (the Pallas TPU
// kernel launched by _ldl_solve_batched). Same function: a forward sweep
// with the unit L (column k, rows > k), division by the pivots D (clamped
// away from zero keeping their sign, |d| >= 1e-30), then a backward sweep
// with Lᵀ (row k, columns < k). One right-hand side per system.
//
// Layout: LD batch-major (B, M, M) float32 as written by ldl_factor; b and
// x (B, M) float32; all contiguous. The batch is the grid.
//
// What bounds it on an H100: the data is B x M² x 4 bytes of factor plus
// 2 x B x M x 4 bytes of vectors — at B=256, M=92 about 8.8 MB, 2.6 us at
// 3.35 TB/s — against only 2 M² flops per system. In practice it is
// latency-bound by the two M-step sequential sweeps, one block-wide
// barrier per step. The design loads the factor into shared memory once
// with coalesced reads (row stride padded to an odd number of floats, so
// the forward sweep's column reads are free of bank conflicts), keeps x in
// shared memory, and rounds each product and difference separately
// (__fmul_rn/__fsub_rn, IEEE division), which is the plain PyTorch
// version's arithmetic exactly.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float safe_d(float d) {
  const float tiny = 1e-30f;
  if (d != d) return d;  // NaN propagates, as jnp.maximum/minimum do
  return d >= 0.f ? (d > tiny ? d : tiny) : (d < -tiny ? d : -tiny);
}

__global__ void ldl_solve_kernel(const float* __restrict__ LD,
                                 const float* __restrict__ b,
                                 float* __restrict__ x_out, int M, int ld) {
  extern __shared__ float smem[];
  float* L = smem;            // M rows of stride ld
  float* x = smem + M * ld;   // the solution, in place
  const size_t base = static_cast<size_t>(blockIdx.x) * M * M;
  const size_t vbase = static_cast<size_t>(blockIdx.x) * M;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int mm = M * M;

  for (int e = tid; e < mm; e += nthreads) {
    L[(e / M) * ld + (e % M)] = LD[base + e];
  }
  for (int i = tid; i < M; i += nthreads) x[i] = b[vbase + i];
  __syncthreads();

  // forward: unit L, column k below the diagonal
  for (int k = 0; k < M; ++k) {
    const float xk = x[k];
    for (int i = k + 1 + tid; i < M; i += nthreads) {
      x[i] = __fsub_rn(x[i], __fmul_rn(L[i * ld + k], xk));
    }
    __syncthreads();
  }
  for (int i = tid; i < M; i += nthreads) {
    x[i] = x[i] / safe_d(L[i * ld + i]);
  }
  __syncthreads();
  // backward: Lᵀ, row k left of the diagonal
  for (int k = M - 1; k >= 0; --k) {
    const float xk = x[k];
    for (int i = tid; i < k; i += nthreads) {
      x[i] = __fsub_rn(x[i], __fmul_rn(L[k * ld + i], xk));
    }
    __syncthreads();
  }

  for (int i = tid; i < M; i += nthreads) x_out[vbase + i] = x[i];
}

}  // namespace

// Shared memory bytes the kernel needs for an M x M factor.
extern "C" long long ldl_solve_smem_bytes(int M) {
  const long long ld = M | 1;
  return (static_cast<long long>(M) * ld + M) * 4;
}

// LD: device pointer to B contiguous float32 M x M factors; b, x: B
// contiguous float32 vectors of length M. stream: a cudaStream_t.
// Returns the cudaError_t of the launch.
extern "C" int ldl_solve_f32(const void* LD, const void* b, void* x, int B,
                             int M, void* stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = M | 1;
  const long long smem = ldl_solve_smem_bytes(M);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ldl_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ldl_solve_kernel<<<B, 128, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(LD), static_cast<const float*>(b),
      static_cast<float*>(x), M, ld);
  return static_cast<int>(cudaGetLastError());
}
