// Batched pivot-free LDLᵀ factorization of symmetric quasi-definite KKT
// matrices, one thread block per matrix.
//
// Replaces agentlib_mpc_tpu/ops/kkt.py::_ldl_factor_kernel (the Pallas TPU
// kernel launched by _ldl_factor_batched). Same function: an in-place,
// right-looking LDLᵀ without pivoting. At each step k the pivot is clamped
// away from zero keeping its sign (|d| >= 1e-30, NaN passes through),
// l = A[k+1:, k] / d, the trailing block gets the rank-1 update
// A[i][j] -= l[i] * A[k][j] for i > k, j > k (the full trailing block, both
// triangles, so row k is read as in the TPU kernel), and l is stored into
// column k. Output: unit L strictly below the diagonal, D on the diagonal,
// the (deterministic) updated upper triangle above it.
//
// Layout: batch-major (B, M, M) float32, contiguous; the batch is the grid
// (the TPU kernel's batch-in-lanes layout has no Hopper counterpart).
//
// What bounds it on an H100: the data is 2 x B x M² x 4 bytes (read K,
// write LD) — at B=256, M=92 that is 17.3 MB, 5.2 us at 3.35 TB/s — and
// about (2/3) M³ flops per matrix (0.13 GFLOP at B=256, 2 us at 67 TFLOP/s
// fp32). In practice the kernel is latency-bound by the M-step sequential
// recursion: each step is two block-wide barriers. The design keeps the
// whole matrix in shared memory for the k-loop (one read and one write of
// device memory per element), pads the row stride to an odd number of
// floats so column reads are free of bank conflicts, and maps each warp to
// consecutive columns of a row so row reads and updates are conflict-free.
// Products and differences are rounded separately (__fmul_rn/__fsub_rn)
// and the division is IEEE, so the result is the plain PyTorch version's
// arithmetic exactly.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float safe_d(float d) {
  const float tiny = 1e-30f;
  if (d != d) return d;  // NaN propagates, as jnp.maximum/minimum do
  return d >= 0.f ? (d > tiny ? d : tiny) : (d < -tiny ? d : -tiny);
}

__global__ void ldl_factor_kernel(const float* __restrict__ K,
                                  float* __restrict__ LD, int M, int ld) {
  extern __shared__ float smem[];
  float* A = smem;            // M rows of stride ld
  float* l = smem + M * ld;   // the current column of L
  const size_t base = static_cast<size_t>(blockIdx.x) * M * M;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int mm = M * M;

  for (int e = tid; e < mm; e += nthreads) {
    A[(e / M) * ld + (e % M)] = K[base + e];
  }
  __syncthreads();

  for (int k = 0; k < M; ++k) {
    const float d = safe_d(A[k * ld + k]);
    for (int i = k + 1 + tid; i < M; i += nthreads) {
      l[i] = A[i * ld + k] / d;
    }
    __syncthreads();
    const float* rowk = A + k * ld;
    for (int i = k + 1 + threadIdx.y; i < M; i += blockDim.y) {
      const float li = l[i];
      float* rowi = A + i * ld;
      for (int j = k + 1 + threadIdx.x; j < M; j += blockDim.x) {
        rowi[j] = __fsub_rn(rowi[j], __fmul_rn(li, rowk[j]));
      }
    }
    // no thread reads column k during the update: store L there now
    for (int i = k + 1 + tid; i < M; i += nthreads) {
      A[i * ld + k] = l[i];
    }
    __syncthreads();
  }

  for (int e = tid; e < mm; e += nthreads) {
    LD[base + e] = A[(e / M) * ld + (e % M)];
  }
}

}  // namespace

// Shared memory bytes the kernel needs for an M x M matrix.
extern "C" long long ldl_factor_smem_bytes(int M) {
  const long long ld = M | 1;
  return (static_cast<long long>(M) * ld + M) * 4;
}

// K, LD: device pointers to B contiguous float32 M x M matrices.
// stream: a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int ldl_factor_f32(const void* K, void* LD, int B, int M,
                              void* stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = M | 1;
  const long long smem = ldl_factor_smem_bytes(M);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ldl_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(32, 8);
  ldl_factor_kernel<<<B, block, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(K), static_cast<float*>(LD), M, ld);
  return static_cast<int>(cudaGetLastError());
}
