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
// masked) counts l as 1, the reference's rule, so it writes 0 and its lse
// is -1e30.
//
// What bounds it on an H100: at the prefill shape (q (2,32,2048,128),
// k/v (2,8,2048,128), causal) it moves 84 MB (q, k, v read once, the output
// written once) and does 4*B*Hq*Dh * (the unmasked (row, col) pairs) =
// 69 GFLOP: operations, not bytes, bound it (0.070 ms at the 989 TFLOP/s
// bf16 peak against 0.025 ms for the bytes at 3.35 TB/s).
//
// Two variants, chosen by the wrapper (kernels/flash_attention.py::variant)
// and passed in as `variant`; both compute the same masks and the same
// online softmax, and neither uses atomics (every block writes its own
// rows), so two runs on the same inputs are equal bit for bit.
//
// * wgmma (1) -- bf16 at head dims 64, 80 and 128, 16-byte aligned bases:
//   the tensor-core kernel, FlashAttention-3's forward without its ping-pong
//   scheduling or intra-warpgroup overlap.  One block (3 warpgroups) per
//   (q head, batch, 128-row q tile), the q tiles in reverse order so the
//   heavy causal tiles start first:
//     - producer warpgroup (registers given up with setmaxnreg): one thread
//       loads the Q tile once and the K and V tiles of 128 kv rows into a
//       2-stage ring, each stage with a full and an empty mbarrier.  TMA
//       reads 3-D maps (Dh, S, B*H) in boxes of 64 bf16 (128 bytes,
//       swizzled) x 128 rows; GQA is the map coordinate b*Hkv + h/group (no
//       repeat), rows past Sq or Skv are zero-filled, never the next head's.
//       Head dim 80 (h2o-danube's 2560 / 32) takes the 128-column tile: the
//       maps keep the true inner dim 80 (rows of 160 bytes), the second box
//       reaches past it and TMA zero-fills columns 80..127, so S = Q K^T
//       runs its 5 k steps over the true head dim, and columns 80..127 of
//       P V are 0 and never stored (1.6x the P V work of an n = 80 tile);
//     - two consumer warpgroups, 64 q rows each: S = Q K^T by wgmma
//       m64n128k16 with both operands K-major in shared memory and f32
//       accumulators (bf16 x bf16 products are exact in f32, so S differs
//       from the f32 SIMT kernel only in summation order); masks and the
//       online softmax in registers on the accumulator layout (a row's 128
//       columns lie in the 4 threads of a quad: shfl_xor 1 and 2); then
//       O = alpha * O + P V by wgmma with A = P from registers (the m64nN
//       accumulator fragment rounded to bf16 pairs is the A fragment) and
//       B = the V tile read MN-major (the descriptor's transpose bit);
//     - the softmax turns an absolute error in x = S * scale into a
//       relative error in p, and the rounding of S grows with |x|: the
//       tensor cores sum a k step's 16 products in their own order, which
//       differs from an f32 FMA chain by a few ulps of x.  At the model's
//       reference init (|x| about 6400, softmaxes near one-hot) that alone
//       moves every training gradient by 60-100% (PERF.md).  So in a row
//       whose running max |x| is tc::RESUM_MIN or more, each logit within
//       tc::RESUM_WINDOW of that max (the only ones whose p can exceed
//       e^-24 of the max's) is summed again from the Q and K tiles in
//       shared memory as an f32 FMA chain over the head dim in order: the
//       SIMT kernel's and the plain version's order.  Each lane re-sums
//       its own such logits, the warp's lanes in step.  Such logits are
//       few (0.1% of the unmasked ones at the reference init, counted
//       against each row's final max); softer rows (|x| < 16, where a few
//       ulps of x move p by about 2^-17) keep the tensor cores' sums;
//     - P enters the tensor cores as tc::P_PARTS bf16 terms, a compile-
//       time choice: bf16(p) alone (1; FA2, FA3 and SDPA do this) or p
//       split into bf16(p) and the bf16 roundings of what is left (2:
//       about 16 significant bits, 3: all 24 of f32), one wgmma per term
//       and k step, at (1 + P_PARTS) / 2 times the operations.  The
//       Pallas kernel multiplies p by v in f32.  3 ships: with 1 or 2 the
//       reference-init gradients move past the end-to-end gate (PERF.md);
//     - the softmax is the plain version's: x = s * scale, p =
//       exp(x - max x), without fused multiply-adds (exp2 with the scale
//       folded in would move every p by up to an ulp of the exponent);
//       masked logits are -inf inside the tile (exp gives exactly 0) and
//       the running max starts at -1e30, so a row with no unmasked column
//       keeps l == 0; masks are computed only on tiles that straddle the
//       causal diagonal, the window's edge or Skv; wholly masked tiles are
//       skipped;
//     - epilogue: O / l rounded to bf16, staged through the warpgroup's own
//       rows of the Q tile and stored with 16-byte stores; lse per row.
// * simt (0) -- everything else (f32, head dims 16 and 32): one thread
//   block (256 threads) per (batch, q head, 64-row q tile); Q, K, V and P
//   tiles staged in shared memory as f32, every product and sum an f32 FMA
//   (the TPU kernel computes in f32 too; the tensor cores would round f32
//   to tf32); only the output is rounded to the input dtype.  Thread
//   (ty, tx) = (tid / 16, tid % 16) owns q rows 4*ty .. 4*ty+3 and, of the
//   scores, kv columns tx + 16*j (j < 4), of the output, head-dim columns
//   tx + 16*j (j < Dh/16; Dh 16, 32, 64, 80 or 128); the 16 threads of a row group are one half warp,
//   which reduces row max and sum by shuffles.
//
// Masks (both variants) follow the TPU kernel: cols < kv_len, causal
// cols <= rows, window cols > rows - window, rows offset by kv_offset;
// masked probabilities are exactly 0.  kv tiles that lie wholly above the
// causal diagonal or wholly before the window are skipped, and ragged Sq /
// Skv are masked, so no length needs to divide a tile.
//
// C interface: repro_flash_attention(...) and
// repro_flash_attention_fwd_lse(...) launch the variant asked for on the
// given stream and return cudaGetLastError() (cudaErrorInvalidValue for a
// variant that cannot take the call); the caller allocates the outputs.
// repro_flash_numerics(...) reports the wgmma variant's compile-time
// numerics (P_PARTS, RESUM_MIN, RESUM_WINDOW) to the card's checks.

#include "ptx.cuh"
#include "tma_host.cuh"

#include <math_constants.h>

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
    case 80:
      return launch<T, 80>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                           has_window, window, kv_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                            has_window, window, kv_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma: TMA producer warpgroup + two consumer warpgroups (bf16, Dh 64, 80,
// 128)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {
constexpr int BQ = 128, BKV = 128, STAGES = 2;
constexpr int BOX = 128 * 64 * 2;           // 128 rows x 64 bf16: 16 KiB
constexpr int NT = 384;                     // producer + 2 consumer groups
// P enters P V as P_PARTS bf16 terms, one wgmma each per k step: bf16(p)
// alone (1), or each further term the bf16 rounding of what the terms
// before it leave of p (2: about 16 significant bits; 3: all 24 of f32);
// see the note at the top.
constexpr int P_PARTS = 3;
// Rows whose largest |x| (x = S * scale) is at least RESUM_MIN get their
// logits within RESUM_WINDOW of the row's max re-summed in f32 FMA order;
// see the note at the top.
constexpr float RESUM_MIN = 16.f;
constexpr float RESUM_WINDOW = 24.f;

// The tile width of head dim D: whole 64-column boxes (80 -> 128; TMA
// zero-fills the columns past D)
template <int D>
__host__ __device__ constexpr int tile_dim() {
  return (D + 63) / 64 * 64;
}

// Q tile, then per stage a K and a V tile, then the mbarriers
template <int D>
constexpr int smem_bytes() {
  return 1024 + (1 + 2 * STAGES) * (tile_dim<D>() / 64) * BOX +
         (2 * STAGES + 1) * 8;
}
}  // namespace tc

// S[ra][rb] of two 128-row bf16 tiles as TMA wrote them (64-column boxes
// of 128-byte rows, 128-byte swizzle), summed in f32 FMA over the head dim
// in order: the SIMT kernel's and the plain version's order.
template <int D>
__device__ __forceinline__ float dot_in_order(const uint8_t* a, int ra,
                                              const uint8_t* b, int rb) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    const int at = (d / 64) * tc::BOX + ((((d % 64) / 8) ^ (ra & 7)) << 4) +
                   (d % 8) * 2;
    const int bt = (d / 64) * tc::BOX + ((((d % 64) / 8) ^ (rb & 7)) << 4) +
                   (d % 8) * 2;
    const __nv_bfloat162 x =
        *reinterpret_cast<const __nv_bfloat162*>(a + ra * 128 + at);
    const __nv_bfloat162 y =
        *reinterpret_cast<const __nv_bfloat162*>(b + rb * 128 + bt);
    acc = fmaf(__low2float(x), __low2float(y), acc);
    acc = fmaf(__high2float(x), __high2float(y), acc);
  }
  return acc;
}

// max over the quad's 128 columns of each of a thread's two rows
__device__ __forceinline__ void quad_row_max(const float (&s)[64],
                                             float (&mx)[2]) {
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

template <int D>
__global__ void __launch_bounds__(tc::NT, 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                            const __grid_constant__ CUtensorMap tma_k,
                            const __grid_constant__ CUtensorMap tma_v,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int Hq, int Hkv, int Sq, int Skv, int causal,
                            int has_window, int window, int kv_offset,
                            float scale) {
  constexpr int BQ = tc::BQ, BKV = tc::BKV, STAGES = tc::STAGES;
  constexpr int BOX = tc::BOX;
  constexpr int P_PARTS = tc::P_PARTS;
  constexpr int DT = tc::tile_dim<D>();      // D padded to whole boxes
  constexpr int NB = DT / 64;                // 64-column boxes per row tile
  constexpr int TILE = NB * BOX;             // one 128-row tile of Q, K or V
  extern __shared__ uint8_t smem_raw[];
  // tiles 1024-byte aligned (the 128-byte swizzle's period)
  const uint32_t raw = ptx::smem_u32(smem_raw);
  uint8_t* qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* ring = qs + TILE;                 // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heavy tiles first
  const int bh = b * Hq + h;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  const int wg = threadIdx.x / 128;

  // kv tiles that can be unmasked for some row of this q tile
  const int row_lo = q0 + kv_offset;
  const int row_hi = min(q0 + BQ, Sq) - 1 + kv_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, row_hi + 1);
  if (has_window) kv_lo = max(0, row_lo - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], 256);        // every consumer thread
    }
    ptx::mbar_init(qbar, 1);
    ptx::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    ptx::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      ptx::mbar_expect_tx(qbar, TILE);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        ptx::tma_load_3d(qs + j * BOX, &tma_q, qbar, 64 * j, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) ptx::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* ks = ring + s * 2 * TILE;
        const int c0 = kv_lo + t * BKV;
        ptx::mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ptx::tma_load_3d(ks + j * BOX, &tma_k, &full[s], 64 * j, c0, bhk);
          ptx::tma_load_3d(ks + TILE + j * BOX, &tma_v, &full[s], 64 * j, c0,
                           bhk);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows [64 w, 64 w + 64) of the tile --
    ptx::setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator fragment: d[4j + e] lies in row r0 (e < 2) or r0 + 8
    // (e >= 2) of the warpgroup's 64 rows, column 8j + 2 (lane % 4) + e % 2
    const int r0 = 16 * warp + lane / 4;
    const int mrow[2] = {q0 + 64 * w + r0 + kv_offset,
                         q0 + 64 * w + r0 + 8 + kv_offset};
    const int wrow_lo = q0 + 64 * w + kv_offset, wrow_hi = wrow_lo + 63;

    float acc[DT / 2], s[64];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_base = ptx::smem_u32(qs) + w * 64 * 128;

    ptx::mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      const int c0 = kv_lo + t * BKV;
      ptx::mbar_wait(&full[st], (t / STAGES) & 1);
      const uint32_t k_base = ptx::smem_u32(ring + st * 2 * TILE);
      const uint32_t v_base = k_base + TILE;

      // S = Q K^T: both K-major; 16 head dims are 32 bytes of a row; the
      // k steps cover the true head dim (zero-filled columns add nothing)
      ptx::fence_regs(s);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        ptx::wgmma_m64n128k16_ss<0, 0>(
            s, ptx::wgmma_desc(q_base + off, 16, 1024),
            ptx::wgmma_desc(k_base + off, 16, 1024), kk > 0);
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait<0>();
      ptx::fence_regs(s);

      // masks, only where the tile straddles Skv, the diagonal or the window
      if (c0 + BKV > Skv || (causal && c0 + BKV - 1 > wrow_lo) ||
          (has_window && c0 <= wrow_hi - window)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = c0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int row = mrow[(i / 2) % 2];
          const bool ok = col < Skv && (!causal || col <= row) &&
                          (!has_window || col > row - window);
          if (!ok) s[i] = -CUDART_INF_F;
        }
      }

      // rows of large logits: re-sum those near the running max in FMA
      // order, each lane its own candidates, the warp's lanes in step
      float mx[2], alpha[2];
      quad_row_max(s, mx);
      uint64_t todo = 0;                        // bit i: re-sum s[i]
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float top = fmaxf(m[r], __fmul_rn(mx[r], scale));
        if (top > NEG_INF && fabsf(top) >= tc::RESUM_MIN) {
          const float cut = (top - tc::RESUM_WINDOW) / scale;
#pragma unroll
          for (int j = 0; j < 16; ++j)          // row r's s[4 j + 2 r + e]
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * r + e;
              if (s[i] >= cut) todo |= 1ull << i;
            }
        }
      }
      if (__any_sync(0xffffffffu, todo != 0)) {
        const uint8_t* ks = ring + st * 2 * TILE;
        while (__any_sync(0xffffffffu, todo != 0)) {
          const int i = todo ? __ffsll(static_cast<long long>(todo)) - 1 : -1;
          float sum = 0.f;
          if (i >= 0) {
            sum = dot_in_order<D>(qs, 64 * w + r0 + 8 * ((i / 2) % 2), ks,
                                  8 * (i / 4) + 2 * (lane % 4) + (i % 2));
            todo &= todo - 1;
          }
#pragma unroll
          for (int j = 0; j < 64; ++j)
            if (j == i) s[j] = sum;
        }
        quad_row_max(s, mx);
      }

      // online softmax as the plain version computes it: x = s * scale
      // rounded, p = exp(x - max x) (no fused multiply-add, so each x is
      // the plain version's when s is); l stays a per-thread partial sum
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], __fmul_rn(mx[r], scale));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = expf(__fsub_rn(__fmul_rn(s[i], scale), m[(i / 2) % 2]));
        l[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // P as wgmma A fragments, in P_PARTS bf16 terms: k step kk is
      // columns 16 kk .. 16 kk + 15, i.e. s[8 kk .. 8 kk + 7] in the order
      // (row r0, r0 + 8, r0, r0 + 8)
      uint32_t pa[P_PARTS][8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = s[8 * kk + 2 * e], c = s[8 * kk + 2 * e + 1];
#pragma unroll
          for (int t = 0; t < P_PARTS; ++t) {
            pa[t][kk][e] = ptx::pack_bf16(a, c);
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(&pa[t][kk][e]);
            a -= __low2float(r);      // exact: what this term leaves of p
            c -= __high2float(r);
          }
        }

      // O += P V: V read MN-major, 16 kv rows a k step, 64-column boxes
      ptx::fence_regs(acc);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = ptx::wgmma_desc(v_base + kk * 2048, BOX, 1024);
#pragma unroll
        for (int t = 0; t < P_PARTS; ++t) {
          if constexpr (DT == 128)
            ptx::wgmma_m64n128k16_rs<1>(acc, pa[t][kk], dv);
          else
            ptx::wgmma_m64n64k16_rs<1>(acc, pa[t][kk], dv);
        }
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait<0>();
      ptx::fence_regs(acc);
      ptx::mbar_arrive(&empty[st]);
    }

    // ---- epilogue: O / l to bf16, staged through this warpgroup's rows
    // of the Q tile (same 128-byte swizzle), 16-byte stores of each row's
    // first D columns ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float div[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
    ptx::bar_sync(1 + w, 128);      // the group's last wgmma read of Q is done
    uint8_t* stage = qs + w * 64 * 128;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int box = j / 8, c = j % 8;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        *reinterpret_cast<uint32_t*>(stage + box * BOX + row * 128 +
                                     ((c ^ (row & 7)) << 4) +
                                     4 * (lane % 4)) =
            ptx::pack_bf16(acc[4 * j + 2 * r] / div[r],
                           acc[4 * j + 2 * r + 1] / div[r]);
      }
    }
    ptx::bar_sync(1 + w, 128);
    constexpr int CHUNKS = D / 8;             // 16-byte chunks of a row
#pragma unroll
    for (int it = 0; it < 64 * CHUNKS / 128; ++it) {
      const int idx = tid + 128 * it;
      const int row = idx / CHUNKS, cc = idx % CHUNKS;
      const int grow = q0 + 64 * w + row;
      if (grow < Sq)
        *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + grow) * D + 8 * cc) =
            *reinterpret_cast<const uint4*>(stage + (cc / 8) * BOX + row * 128 +
                                            (((cc % 8) ^ (row & 7)) << 4));
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int grow = q0 + 64 * w + r0 + 8 * r;
        if (grow < Sq)
          lse[(size_t)bh * Sq + grow] = m[r] + logf(div[r]);
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                         int Skv, int causal, int has_window, int window,
                         int kv_offset, float scale, cudaStream_t stream) {
  cudaError_t err = tma::bind_device();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!(tma::encode(&tq, q, D, Sq, B * Hq, tc::BQ) &&
        tma::encode(&tk, k, D, Skv, B * Hkv, tc::BKV) &&
        tma::encode(&tv, v, D, Skv, B * Hkv, tc::BKV)))
    return cudaErrorInvalidValue;
  constexpr int smem = tc::smem_bytes<D>();
  auto kernel = flash_attn_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (Sq + tc::BQ - 1) / tc::BQ);
  kernel<<<grid, tc::NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Hq, Hkv, Sq, Skv, causal,
      has_window, window, kv_offset, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int Hq, int Hkv, int Sq, int Skv, int Dh, int causal,
        int has_window, int window, int kv_offset, float scale, int dtype,
        int variant, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;  // empty output
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == 0 && dtype == 0)
    err = dispatch<float>(Dh, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                          has_window, window, kv_offset, scale, s);
  else if (variant == 0 && dtype == 1)
    err = dispatch<bf16>(Dh, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                         has_window, window, kv_offset, scale, s);
  else if (variant == 1 && dtype == 1 && Skv > 0 && aligned16(q) &&
           aligned16(k) && aligned16(v) && aligned16(o)) {
    if (Dh == 64)
      err = launch_wgmma<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                             has_window, window, kv_offset, scale, s);
    else if (Dh == 80)
      err = launch_wgmma<80>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                             has_window, window, kv_offset, scale, s);
    else if (Dh == 128)
      err = launch_wgmma<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                              has_window, window, kv_offset, scale, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); o like q; all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt, 1 = wgmma.
// Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int Dh,
                                     int causal, int has_window, int window,
                                     int kv_offset, float scale, int dtype,
                                     int variant, void* stream) {
  return run(q, k, v, o, nullptr, B, Hq, Hkv, Sq, Skv, Dh, causal,
             has_window, window, kv_offset, scale, dtype, variant, stream);
}

// As repro_flash_attention, and also writes lse: (B, Hq, Sq) float32.
extern "C" int repro_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int has_window,
    int window, int kv_offset, float scale, int dtype, int variant,
    void* stream) {
  return run(q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Sq, Skv, Dh,
             causal, has_window, window, kv_offset, scale, dtype, variant,
             stream);
}

// The wgmma variant's P terms and its re-summation thresholds (tc::).
extern "C" void repro_flash_numerics(int* p_parts, float* resum_min,
                                     float* resum_window) {
  *p_parts = tc::P_PARTS;
  *resum_min = tc::RESUM_MIN;
  *resum_window = tc::RESUM_WINDOW;
}
