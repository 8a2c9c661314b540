// Grouped (per-expert) matmul for Hopper: (E, C, K) @ (E, K, N) -> (E, C, N).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::grouped_matmul
// (Pallas `_gmm_kernel`), the expert FFN of the MoE layer: three calls per
// MoE layer (w1, w3, w2), in decode and in prefill.
//
// What bounds it on an H100:
//   * decode (C = 4 rows per expert) reads every expert weight once and
//     does ~C multiply-adds per weight: it is bound by the weight bytes
//     (w1 at phi3.5-moe width: 16*4096*6400*2 B = 839 MB, 0.25 ms at
//     3.35 TB/s);
//   * prefill (C = 640) does 2*E*C*K*N = 537 GFLOP per call: bound by
//     operations (0.54 ms at the 989 TFLOP/s bf16 tensor-core peak).
//
// Design (simple and right first; wgmma/TMA are later work):
//   * one thread block per (expert, C-tile, N-tile); the Pallas grid's
//     sequential K axis and its VMEM f32 accumulator become a loop inside
//     the block and registers;
//   * lhs and rhs tiles are staged through shared memory as f32, products
//     are summed in f32 with FMA, the result is rounded once to the
//     input dtype (f32 or bf16), as the reference's f32 einsum does;
//   * ragged edges are masked (zero-filled loads, guarded stores) instead
//     of the Pallas wrapper's divisor search, so any (E, C, K, N) works;
//   * two tile shapes: for C <= 8 (decode) a block covers 8 rows x 128
//     columns, so each weight is read once by a block that wastes at most
//     half its rows; otherwise 128 x 128 tiles with 8 x 8 outputs per
//     thread, for reuse of each staged value across 8 products.
//
// C interface: repro_grouped_matmul(...) launches on the given stream and
// returns cudaGetLastError(); the caller allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// BM x BN output tile per block, BK deep K step, TM x TN outputs per thread.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               T* __restrict__ out, int C, int K, int N) {
  constexpr int TX = BN / TN;           // threads along N
  constexpr int NT = (BM / TM) * TX;    // threads per block
  __shared__ float As[BK][BM + 1];      // lhs tile, k-major; odd stride
  __shared__ float Bs[BK][BN];          // rhs tile

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* A = lhs + (size_t)e * C * K;
  const T* B = rhs + (size_t)e * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one lhs row ...
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, kk = idx % BK;
      const int gm = m0 + m, gk = k0 + kk;
      As[kk][m] = (gm < C && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.f;
    }
    // ... and consecutive n of one rhs row
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gn = n0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* O = out + (size_t)e * C * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) O[(size_t)gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* lhs, const void* rhs, void* out, int E, int C, int K,
            int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
  const dim3 block((BM / TM) * (BN / TN));
  gmm_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<T*>(out), C, K, N);
}

template <typename T>
void dispatch(const void* lhs, const void* rhs, void* out, int E, int C,
              int K, int N, cudaStream_t stream) {
  if (C <= 8)
    launch<T, 8, 128, 32, 1, 4>(lhs, rhs, out, E, C, K, N, stream);
  else
    launch<T, 128, 128, 8, 8, 8>(lhs, rhs, out, E, C, K, N, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int repro_grouped_matmul(const void* lhs, const void* rhs,
                                    void* out, int E, int C, int K, int N,
                                    int dtype, void* stream) {
  if (E <= 0 || C <= 0 || N <= 0) return 0;  // empty output: nothing to do
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(lhs, rhs, out, E, C, K, N, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(lhs, rhs, out, E, C, K, N, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
