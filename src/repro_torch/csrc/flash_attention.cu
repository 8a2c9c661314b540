// Flash-attention forward for Hopper: online-softmax attention with GQA,
// causal and sliding-window masks, a kv offset and ragged lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas `_attn_kernel`), which the full-sequence prefill
// runs once per attention layer (entry point repro_flash_attention).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// flash_attention_fwd (Pallas `_fwd_kernel`) too: the same forward pass
// that also writes lse = m + log(l) per row, (B, Hq, Sq) f32, for the
// backward kernels of csrc/flash_attention_bwd.cu (entry point
// repro_flash_attention_fwd_lse).  Training runs it once per attention
// layer and again in the remat recompute.  A row with l == 0 (fully
// masked) counts l as 1, the reference's rule, so its lse is -1e30.
//
// What bounds it on an H100: at the prefill shape (q (2,32,2048,128),
// k/v (2,8,2048,128), causal) it moves 84 MB (q, k, v read once, the output
// written once) and does 4*B*Hq*Dh * (the unmasked (row, col) pairs) =
// 69 GFLOP: operations, not bytes, bound it (0.070 ms at the 989 TFLOP/s
// bf16 peak against 0.025 ms for the bytes at 3.35 TB/s).
//
// Design (simple and right first; wgmma/TMA are later work):
//   * one thread block (256 threads) per (batch, q head, 64-row q tile);
//     the Pallas grid's sequential kv axis becomes a loop inside the block
//     over 64-column kv tiles, and the running max / sum / accumulator of
//     the online softmax live in registers, not in device memory;
//   * the block reads kv head h / (Hq / Hkv), so grouped q heads share kv
//     tiles without a materialised repeat;
//   * Q, K, V and P tiles are staged in shared memory as f32 and every
//     product and sum is f32 (the TPU kernel computes in f32 too); only the
//     output is rounded to the input dtype;
//   * masks follow the TPU kernel: cols < kv_len, causal cols <= rows,
//     window cols > rows - window, rows offset by kv_offset, masked logits
//     -1e30; masked probabilities are exactly 0, so a row with no unmasked
//     column has l == 0 and writes 0 (the reference's fully-masked rule);
//   * kv tiles that lie wholly above the causal diagonal or wholly before
//     the window are skipped, and ragged Sq / Skv are masked, so no length
//     needs to divide a tile.
//
// Thread layout: thread (ty, tx) = (tid / 16, tid % 16) owns q rows
// 4*ty .. 4*ty+3 and, of the scores, kv columns tx + 16*j (j < 4), of the
// output, head-dim columns tx + 16*j (j < Dh/16).  The 16 threads of one
// row group are one half warp, which reduces row max and sum by shuffles.
//
// C interface: repro_flash_attention(...) and
// repro_flash_attention_fwd_lse(...) launch on the given stream and return
// cudaGetLastError(); the caller allocates the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BKV = 64;        // kv columns per tile
constexpr int NT = 256;        // threads per block
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded to an odd stride; P rows padded too.
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Hq, int Hkv, int Sq,
                      int Skv, int causal, int has_window, int window,
                      int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BKV + 1;
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BKV x DP
  float* Vs = Ks + BKV * DP;   // BKV x D
  float* Ps = Vs + BKV * D;    // BQ x PP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  T* ob = o + (size_t)(b * Hq + h) * Sq * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qs[r * DP + d] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // kv columns that can be unmasked for some row of this tile
  const int row_lo = q0 + kv_offset;
  const int row_hi = min(q0 + BQ, Sq) - 1 + kv_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, row_hi + 1);
  if (has_window) kv_lo = max(0, row_lo - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  for (int c0 = kv_lo; c0 < kv_hi; c0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const bool in = c0 + r < Skv;
      const size_t off = (size_t)(c0 + r) * D + d;
      Ks[r * DP + d] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i + kv_offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        ok[j] = col < Skv && (!causal || col <= row) &&
                (!has_window || col > row - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = Vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];   // fully masked -> 0
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      ob[(size_t)r * D + tx + 16 * cc] = from_f32<T>(acc[i][cc] / l);
    if (lse != nullptr && tx == 0)
      lse[(size_t)(b * Hq + h) * Sq + r] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                   int causal, int has_window, int window, int kv_offset,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attn_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Skv,
      causal, has_window, window, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                     int Skv, int causal, int has_window, int window,
                     int kv_offset, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                           has_window, window, kv_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                           has_window, window, kv_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                           has_window, window, kv_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                            has_window, window, kv_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int Hq, int Hkv, int Sq, int Skv, int Dh, int causal,
        int has_window, int window, int kv_offset, float scale, int dtype,
        void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;  // empty output
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(Dh, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                          has_window, window, kv_offset, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(Dh, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                  causal, has_window, window, kv_offset,
                                  scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); o like q; all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int Dh,
                                     int causal, int has_window, int window,
                                     int kv_offset, float scale, int dtype,
                                     void* stream) {
  return run(q, k, v, o, nullptr, B, Hq, Hkv, Sq, Skv, Dh, causal,
             has_window, window, kv_offset, scale, dtype, stream);
}

// As repro_flash_attention, and also writes lse: (B, Hq, Sq) float32.
extern "C" int repro_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int has_window,
    int window, int kv_offset, float scale, int dtype, void* stream) {
  return run(q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Sq, Skv, Dh,
             causal, has_window, window, kv_offset, scale, dtype, stream);
}
