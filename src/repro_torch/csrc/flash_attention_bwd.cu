// Flash-attention backward for Hopper (FlashAttention-2): dq, dk, dv from
// q, k, v, dO, the forward's lse and delta = rowsum(dO * O).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (Pallas `_dq_kernel` and `_dkv_kernel`), which
// training runs once per attention layer.  Per (q row, kv column) pair:
//
//     p  = exp(q.k * scale - lse)        (recomputed, masked p exactly 0)
//     dv += p^T dO                        dp = dO v^T
//     ds = p * (dp - delta) * scale
//     dq += ds k                          dk += ds^T q
//
// What bounds it on an H100: at the training shape (q (2,32,2048,128),
// k/v (2,8,2048,128), causal) FA2's five products over the unmasked pairs
// are 172 GFLOP (0.174 ms at the 989 TFLOP/s bf16 peak); the reference's
// race-free split recomputes q.k and dO.v^T in both kernels, seven products
// in all (0.244 ms).  Operations, not bytes (≈ 0.2 GB), bound it.
//
// Design (simple and right first; wgmma/TMA are later work), the
// reference's split kept:
//   * dq kernel: one block (256 threads) per (batch, q head, 64-row q
//     tile), looping over 64-column kv tiles; the dq accumulator lives in
//     registers.  kv head h / (Hq / Hkv) serves grouped q heads.
//   * dkv kernel: one block per (batch, *query* head, 64-row kv tile),
//     looping over 64-row q tiles; it writes dk and dv per query head,
//     (B, Hq, Skv, Dh), and the caller sums each group of Hq / Hkv heads
//     to Hkv.  So no two blocks write one output and no atomics are used:
//     the result does not depend on the order blocks run in, which keeps
//     a remat recompute's routing and every rerun bit-identical.
//   * tiles are staged in shared memory as f32 (rows padded to an odd
//     stride), every product and sum is f32; only dq / dk / dv are rounded
//     to the input dtype;
//   * masks as the forward: cols < kv_len, causal cols <= rows, window
//     cols > rows - window, rows offset by kv_offset; tiles that lie wholly
//     above the causal diagonal or outside the window are skipped in both
//     kernels, and ragged Sq / Skv are masked.
//
// Thread layout: thread (ty, tx) = (tid / 16, tid % 16) owns the block's
// rows 4*ty .. 4*ty+3 (q rows in the dq kernel, kv rows in the dkv kernel)
// and, of each 64 x 64 score tile, the columns tx + 16*j (j < 4); of the
// outputs, head-dim columns tx + 16*c (c < Dh/16).
//
// C interface: repro_flash_attention_bwd(...) launches the dq kernel, then
// the dkv kernel, on the given stream and returns the first
// cudaGetLastError() that is not success; the caller allocates the
// outputs and computes delta.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BKV = 64;        // kv rows per tile
constexpr int NT = 256;        // threads per block

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

// Stage rows [r0, r0 + 64) of a (len, D) matrix into smem rows of stride
// D + 1 as f32; rows past len are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int len) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] =
        (r0 + r < len) ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ bool unmasked(int row, int col, int Skv,
                                         int causal, int has_window,
                                         int window) {
  return col < Skv && (!causal || col <= row) &&
         (!has_window || col > row - window);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles (stride D+1), dS (stride BKV+1), lse and delta
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BKV * (D + 1) +
                                  BQ * (BKV + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles (stride D+1), P^T and dS^T (stride BQ+1), lse, delta
  return sizeof(float) * (size_t)(2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BKV * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
              int causal, int has_window, int window, int kv_offset,
              float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BKV + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x DP
  float* Os = Qs + BQ * DP;      // BQ x DP (dO)
  float* Ks = Os + BQ * DP;      // BKV x DP
  float* Vs = Ks + BKV * DP;     // BKV x DP
  float* Ss = Vs + BKV * DP;     // BQ x PP (dS)
  float* Ls = Ss + BQ * PP;      // BQ (lse)
  float* Ds = Ls + BQ;           // BQ (delta)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  stage<T, D>(Qs, q + qoff * D, q0, Sq);
  stage<T, D>(Os, dout + qoff * D, q0, Sq);
  for (int r = tid; r < BQ; r += NT) {
    Ls[r] = (q0 + r < Sq) ? lse[qoff + q0 + r] : 0.f;
    Ds[r] = (q0 + r < Sq) ? delta[qoff + q0 + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // kv columns that can be unmasked for some row of this tile
  const int row_lo = q0 + kv_offset;
  const int row_hi = min(q0 + BQ, Sq) - 1 + kv_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, row_hi + 1);
  if (has_window) kv_lo = max(0, row_lo - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  for (int c0 = kv_lo; c0 < kv_hi; c0 += BKV) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<T, D>(Ks, kb, c0, Skv);
    stage<T, D>(Vs, vb, c0, Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty * 4 + i) * DP + d];
        oa[i] = Os[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = Ks[(tx + 16 * j) * DP + d];
        va[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_ok = q0 + r < Sq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = row_ok && unmasked(q0 + r + kv_offset, col, Skv,
                                           causal, has_window, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ss[r * PP + tx + 16 * j] = p * (dp[i][j] - Ds[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kv = Ks[c * DP + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
      }
    }
  }

  T* dqb = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      dqb[(size_t)r * D + tx + 16 * cc] = from_f32<T>(acc[i][cc]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
               int Sq, int Skv, int causal, int has_window, int window,
               int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // BKV x DP
  float* Vs = Ks + BKV * DP;     // BKV x DP
  float* Qs = Vs + BKV * DP;     // BQ x DP
  float* Os = Qs + BQ * DP;      // BQ x DP (dO)
  float* Ps = Os + BQ * DP;      // BKV x PP (P^T)
  float* Ss = Ps + BKV * PP;     // BKV x PP (dS^T)
  float* Ls = Ss + BKV * PP;     // BQ (lse)
  float* Ds = Ls + BQ;           // BQ (delta)

  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qb = q + qoff * D;
  const T* ob = dout + qoff * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  stage<T, D>(Ks, k + (size_t)(b * Hkv + hk) * Skv * D, k0, Skv);
  stage<T, D>(Vs, v + (size_t)(b * Hkv + hk) * Skv * D, k0, Skv);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // q rows that can see some column of this tile: causal needs
  // r + kv_offset >= k0, the window r + kv_offset < k_last + window
  const int k_last = min(k0 + BKV, Skv) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - kv_offset);
  if (has_window) q_hi = min(q_hi, k_last + window - kv_offset);
  q_lo = (q_lo / BQ) * BQ;

  for (int r0 = q_lo; r0 < q_hi; r0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are read
    stage<T, D>(Qs, qb, r0, Sq);
    stage<T, D>(Os, ob, r0, Sq);
    for (int r = tid; r < BQ; r += NT) {
      Ls[r] = (r0 + r < Sq) ? lse[qoff + r0 + r] : 0.f;
      Ds[r] = (r0 + r < Sq) ? delta[qoff + r0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];   // [kv row i][q row j], i.e. S^T and dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qa[4], oa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(ty * 4 + i) * DP + d];
        va[i] = Vs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qa[j] = Qs[(tx + 16 * j) * DP + d];
        oa[j] = Os[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool ok = r0 + r < Sq && unmasked(r0 + r + kv_offset, k0 + c,
                                                Skv, causal, has_window,
                                                window);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ps[c * PP + r] = p;
        Ss[c * PP + r] = p * (dp[i][j] - Ds[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(ty * 4 + i) * PP + r];
        ds[i] = Ss[(ty * 4 + i) * PP + r];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float o = Os[r * DP + tx + 16 * cc];
        const float qv = Qs[r * DP + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][cc] = fmaf(p[i], o, dv_acc[i][cc]);
          dk_acc[i][cc] = fmaf(ds[i], qv, dk_acc[i][cc]);
        }
      }
    }
  }

  const size_t kvoff = (size_t)(b * Hq + h) * Skv * D;   // per query head
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= Skv) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const size_t at = kvoff + (size_t)c * D + tx + 16 * cc;
      dk[at] = from_f32<T>(dk_acc[i][cc]);
      dv[at] = from_f32<T>(dv_acc[i][cc]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Hq, Hkv, Sq, Skv, causal, has_window, window, kv_offset;
  float scale;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.Hq, a.Hkv, a.Sq, a.Skv, a.causal,
      a.has_window, a.window, a.kv_offset, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BKV - 1) / BKV, a.Hq, a.B);
  dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Hq, a.Hkv, a.Sq,
      a.Skv, a.causal, a.has_window, a.window, a.kv_offset, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a, void* dq, void* dk, void* dv,
                   cudaStream_t s) {
  cudaError_t err = a.Sq > 0 ? launch_dq<T, D>(a, dq, s) : cudaSuccess;
  if (err == cudaSuccess && a.Skv > 0) err = launch_dkv<T, D>(a, dk, dv, s);
  return err;
}

template <typename T>
cudaError_t dispatch(int Dh, const Args& a, void* dq, void* dk, void* dv,
                     cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(a, dq, dk, dv, s);
    case 32: return launch<T, 32>(a, dq, dk, dv, s);
    case 64: return launch<T, 64>(a, dq, dk, dv, s);
    case 128: return launch<T, 128>(a, dq, dk, dv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); lse, delta:
// (B, Hq, Sq) float32; dq like q; dk, dv: (B, Hq, Skv, Dh), one slice per
// *query* head; all contiguous.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int has_window,
    int window, int kv_offset, float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;   // empty outputs
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Hq, Hkv, Sq, Skv,
               causal, has_window, window, kv_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(Dh, a, dq, dk, dv, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(Dh, a, dq, dk, dv, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
