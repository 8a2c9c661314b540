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
// Design, the reference's split kept:
//   * dq kernel: one block per (batch, q head, 64-row q tile), looping
//     over 64-column kv tiles; the dq accumulator lives in registers.  kv
//     head h / (Hq / Hkv) serves grouped q heads.
//   * dkv kernel: one block per (batch, kv head, 64-row kv tile), looping
//     over the group's Hq / Hkv query heads in order and, for each, over
//     the 64-row q tiles; it sums the group in its registers and writes dk
//     and dv as (B, Hkv, Skv, Dh).  No two blocks write one output and no
//     atomics are used: the result does not depend on the order blocks
//     run in, which keeps a remat recompute's routing and every rerun
//     bit-identical.
//   * bf16 (the training path): every product on the tensor cores,
//     mma.sync m16n8k16 with f32 accumulators, 4 warps of 16 rows each.
//     Tiles are staged in shared memory as bf16 (rows padded by 16 bytes,
//     so ldmatrix's 8 row addresses hit 8 bank groups) by cp.async, the
//     next kv (dq kernel) or q (dkv kernel) tile loading while the current
//     one is multiplied (at head dim 80 a row is 5 k steps of 16 and 10 n
//     tiles of 8, its pitch 176 bytes: an odd count of 16-byte units, so
//     ldmatrix's 8 rows still hit 8 bank groups).  q.k and dO.v^T read
//     their operands with ldmatrix;
//     p and ds stay in registers, rounded to bf16 as they enter the next
//     product (the accumulator fragment of m16n8 is the A fragment of
//     m16k16), as FlashAttention-2 does; the products with k, q and dO
//     read them with ldmatrix.trans.
//   * f32: the same split on CUDA cores (f32 FMA, tiles staged as f32 with
//     an odd row stride, 256 threads of 4 x 4 outputs), since the tensor
//     cores would round f32 operands to tf32.
//   * masks as the forward: cols < kv_len, causal cols <= rows, window
//     cols > rows - window, rows offset by kv_offset; tiles that lie wholly
//     above the causal diagonal or outside the window are skipped in both
//     kernels, and ragged Sq / Skv are masked.
//
// C interface: repro_flash_attention_bwd(...) launches the dq kernel, then
// the dkv kernel, on the given stream and returns the first
// cudaGetLastError() that is not success; the caller allocates the
// outputs and computes delta.

#include "ptx.cuh"

#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;         // q rows per tile
constexpr int BKV = 64;        // kv rows per tile

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Hq, Hkv, Sq, Skv, causal, has_window, window, kv_offset;
  float scale;
};

__device__ __forceinline__ bool unmasked(int row, int col, int Skv,
                                         int causal, int has_window,
                                         int window) {
  return col < Skv && (!causal || col <= row) &&
         (!has_window || col > row - window);
}

// kv columns [lo, hi) that some q row of [q0, q0 + BQ) can see; lo is
// rounded down to a tile
__device__ __forceinline__ void kv_range(const Args& a, int q0, int& lo,
                                         int& hi) {
  const int row_lo = q0 + a.kv_offset;
  const int row_hi = min(q0 + BQ, a.Sq) - 1 + a.kv_offset;
  lo = 0;
  hi = a.Skv;
  if (a.causal) hi = min(hi, row_hi + 1);
  if (a.has_window) lo = max(0, row_lo - a.window + 1);
  lo = (lo / BKV) * BKV;
}

// q rows [lo, hi) that can see some column of [k0, k0 + BKV): causal needs
// r + kv_offset >= k0, the window r + kv_offset < k_last + window; lo is
// rounded down to a tile
__device__ __forceinline__ void q_range(const Args& a, int k0, int& lo,
                                        int& hi) {
  const int k_last = min(k0 + BKV, a.Skv) - 1;
  lo = 0;
  hi = a.Sq;
  if (a.causal) lo = max(0, k0 - a.kv_offset);
  if (a.has_window) hi = min(hi, k_last + a.window - a.kv_offset);
  lo = (lo / BQ) * BQ;
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16), 128 threads = 4 warps x 16 rows
// ===========================================================================

constexpr int NW = 128;

// Rows [r0, r0 + 64) of a (len, D) bf16 matrix into smem rows of stride
// D + 8 by cp.async; rows past len are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int len) {
  constexpr int CH = D / 8;    // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NW) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < len;
    ptx::cp_async16(dst + r * (D + 8) + 8 * c,
                    ok ? src + (size_t)(r0 + r) * D + 8 * c : src, ok);
  }
}

// ldmatrix row addresses (lane l gives row l % 8 of matrix l / 8) of a tile
// with row stride S elements:
// A fragment of rows m0.., cols k0.. (row-major A)
__device__ __forceinline__ const bf16* a_at(const bf16* t, int S, int m0,
                                            int k0, int lane) {
  return t + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * S + k0 +
         8 * (lane >> 4);
}
// B fragments of two n8 tiles, the tile stored (n rows, k contiguous)
__device__ __forceinline__ const bf16* bn_at(const bf16* t, int S, int n0,
                                             int k0, int lane) {
  return t + (n0 + (lane & 7) + 8 * (lane >> 4)) * S + k0 +
         8 * ((lane >> 3) & 1);
}
// B fragments of two n8 tiles, the tile stored (k rows, n contiguous):
// read with ldmatrix.trans
__device__ __forceinline__ const bf16* bk_at(const bf16* t, int S, int k0,
                                             int n0, int lane) {
  return t + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * S + n0 +
         8 * (lane >> 4);
}

// acc[8][4] (16 x 64) += A (16 rows of `a`, m0..) * B^T (64 rows of `b`),
// contracting over D: a.b^T of two row-major tiles
template <int D>
__device__ __forceinline__ void rows_dot(float (&acc)[8][4], const bf16* a,
                                         const bf16* b, int m0, int lane) {
  constexpr int S = D + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4];
    ptx::ldmatrix_x4(fa, a_at(a, S, m0, 16 * ks, lane));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t fb[4];
      ptx::ldmatrix_x4(fb, bn_at(b, S, 16 * jj, 16 * ks, lane));
      ptx::mma_bf16_16816(acc[2 * jj], fa, fb[0], fb[1]);
      ptx::mma_bf16_16816(acc[2 * jj + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[D/8][4] (16 x D) += P (16 x 64, an accumulator in registers, rounded
// to bf16) * B (64 rows of the row-major tile `b`)
template <int D>
__device__ __forceinline__ void regs_times(float (&acc)[D / 8][4],
                                           const float (&p)[8][4],
                                           const bf16* b, int lane) {
  constexpr int S = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t fa[4] = {ptx::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            ptx::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            ptx::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            ptx::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      uint32_t fb[4];
      ptx::ldmatrix_x4_trans(fb, bk_at(b, S, 16 * kk, 16 * dj, lane));
      ptx::mma_bf16_16816(acc[2 * dj], fa, fb[0], fb[1]);
      ptx::mma_bf16_16816(acc[2 * dj + 1], fa, fb[2], fb[3]);
    }
  }
}

// rows r0, r0 + 8 of a 16 x D accumulator to `out` (row stride D) as bf16
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[D / 8][4],
                                           int r0, int len, int lane) {
#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj) {
    const int col = 8 * dj + 2 * (lane & 3);
    if (r0 < len)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(acc[dj][0], acc[dj][1]);
    if (r0 + 8 < len)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + 8) * D + col) =
          __floats2bfloat162_rn(acc[dj][2], acc[dj][3]);
  }
}

template <int D>
constexpr size_t dq_mma_smem() {   // Q, dO, 2 x (K, V)
  return sizeof(bf16) * (size_t)6 * 64 * (D + 8);
}

template <int D>
constexpr size_t dkv_mma_smem() {  // K, V, 2 x (Q, dO), 2 x (lse, delta)
  return sizeof(bf16) * (size_t)6 * 64 * (D + 8) + sizeof(float) * 4 * 64;
}

template <int D>
__global__ void __launch_bounds__(NW)
    dq_mma_kernel(Args a, bf16* __restrict__ dq) {
  constexpr int S = D + 8;
  constexpr int TILE = 64 * S;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + TILE;
  bf16* Ks = Os + TILE;          // 2 buffers
  bf16* Vs = Ks + 2 * TILE;      // 2 buffers

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qoff = (size_t)(b * a.Hq + h) * a.Sq;
  const size_t kvoff = (size_t)(b * a.Hkv + hk) * a.Skv * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + kvoff;
  const bf16* vb = static_cast<const bf16*>(a.v) + kvoff;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * warp + lane / 4;      // this thread's rows r0, r0+8
  const int t2 = 2 * (lane & 3);
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = r0 + 8 * i < a.Sq;
    lse[i] = ok ? a.lse[qoff + r0 + 8 * i] : 0.f;
    dlt[i] = ok ? a.delta[qoff + r0 + 8 * i] : 0.f;
  }

  int kv_lo, kv_hi;
  kv_range(a, q0, kv_lo, kv_hi);
  load_tile<D>(Qs, static_cast<const bf16*>(a.q) + qoff * D, q0, a.Sq);
  load_tile<D>(Os, static_cast<const bf16*>(a.dout) + qoff * D, q0, a.Sq);
  if (kv_lo < kv_hi) {
    load_tile<D>(Ks, kb, kv_lo, a.Skv);
    load_tile<D>(Vs, vb, kv_lo, a.Skv);
  }
  ptx::cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int c0 = kv_lo, it = 0; c0 < kv_hi; c0 += BKV, ++it) {
    const int buf = it & 1;
    if (c0 + BKV < kv_hi) {
      load_tile<D>(Ks + (buf ^ 1) * TILE, kb, c0 + BKV, a.Skv);
      load_tile<D>(Vs + (buf ^ 1) * TILE, vb, c0 + BKV, a.Skv);
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<1>();       // this tile (and Q, dO) have landed
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    float s[8][4] = {}, dp[8][4] = {};
    rows_dot<D>(s, Qs, Kt, 16 * warp, lane);
    rows_dot<D>(dp, Os, Vt, 16 * warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + 8 * (c >> 1);
        const int col = c0 + 8 * j + t2 + (c & 1);
        const bool ok = row < a.Sq && unmasked(row + a.kv_offset, col, a.Skv,
                                               a.causal, a.has_window,
                                               a.window);
        const float p = ok ? expf(s[j][c] * a.scale - lse[c >> 1]) : 0.f;
        s[j][c] = p * (dp[j][c] - dlt[c >> 1]) * a.scale;      // ds
      }
    regs_times<D>(acc, s, Kt, lane);
    __syncthreads();               // before the next load overwrites buf
  }
  store_rows<D>(dq + qoff * D, acc, r0, a.Sq, lane);
}

template <int D>
__global__ void __launch_bounds__(NW)
    dkv_mma_kernel(Args a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int S = D + 8;
  constexpr int TILE = 64 * S;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;          // 2 buffers
  bf16* Os = Qs + 2 * TILE;      // 2 buffers
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);   // 2 x 64
  float* Ds = Ls + 2 * 64;                                // 2 x 64

  const int k0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const size_t kvoff = (size_t)(b * a.Hkv + hk) * a.Skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = k0 + 16 * warp + lane / 4;      // this thread's kv rows
  const int t2 = 2 * (lane & 3);

  int q_lo, q_hi;
  q_range(a, k0, q_lo, q_hi);
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int total = group * n_qt;    // (query head, q tile) steps, in order

  auto load_q = [&](int i, int buf) {
    const int h = hk * group + i / n_qt;
    const int r0 = q_lo + BQ * (i % n_qt);
    const size_t qoff = (size_t)(b * a.Hq + h) * a.Sq;
    load_tile<D>(Qs + buf * TILE, static_cast<const bf16*>(a.q) + qoff * D,
                 r0, a.Sq);
    load_tile<D>(Os + buf * TILE, static_cast<const bf16*>(a.dout) + qoff * D,
                 r0, a.Sq);
    for (int r = threadIdx.x; r < BQ; r += NW) {
      const bool ok = r0 + r < a.Sq;
      Ls[buf * 64 + r] = ok ? a.lse[qoff + r0 + r] : 0.f;
      Ds[buf * 64 + r] = ok ? a.delta[qoff + r0 + r] : 0.f;
    }
  };

  load_tile<D>(Ks, static_cast<const bf16*>(a.k) + kvoff, k0, a.Skv);
  load_tile<D>(Vs, static_cast<const bf16*>(a.v) + kvoff, k0, a.Skv);
  if (total > 0) load_q(0, 0);
  ptx::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    if (i + 1 < total) load_q(i + 1, buf ^ 1);
    ptx::cp_async_commit();
    ptx::cp_async_wait<1>();
    __syncthreads();
    const int r0 = q_lo + BQ * (i % n_qt);
    const bf16* Qt = Qs + buf * TILE;
    const bf16* Ot = Os + buf * TILE;
    const float* L = Ls + buf * 64;
    const float* Dl = Ds + buf * 64;

    // S^T and dP^T: [kv row][q column]
    float st[8][4] = {}, dpt[8][4] = {};
    rows_dot<D>(st, Ks, Qt, 16 * warp, lane);
    rows_dot<D>(dpt, Vs, Ot, 16 * warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kv = c0 + 8 * (c >> 1);
        const int r = 8 * j + t2 + (c & 1);
        const bool ok = r0 + r < a.Sq &&
                        unmasked(r0 + r + a.kv_offset, kv, a.Skv, a.causal,
                                 a.has_window, a.window);
        const float p = ok ? expf(st[j][c] * a.scale - L[r]) : 0.f;
        st[j][c] = p;
        dpt[j][c] = p * (dpt[j][c] - Dl[r]) * a.scale;    // ds^T
      }
    regs_times<D>(dv_acc, st, Ot, lane);
    regs_times<D>(dk_acc, dpt, Qt, lane);
    __syncthreads();
  }
  store_rows<D>(dk + kvoff, dk_acc, c0, a.Skv, lane);
  store_rows<D>(dv + kvoff, dv_acc, c0, a.Skv, lane);
}

template <int D>
cudaError_t launch_mma(const Args& a, void* dq, void* dk, void* dv,
                       cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (a.Sq > 0) {
    constexpr size_t smem = dq_mma_smem<D>();
    err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    dq_mma_kernel<D><<<grid, NW, smem, s>>>(a, static_cast<bf16*>(dq));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && a.Skv > 0) {
    constexpr size_t smem = dkv_mma_smem<D>();
    err = cudaFuncSetAttribute(dkv_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Skv + BKV - 1) / BKV, a.Hkv, a.B);
    dkv_mma_kernel<D><<<grid, NW, smem, s>>>(a, static_cast<bf16*>(dk),
                                             static_cast<bf16*>(dv));
    err = cudaGetLastError();
  }
  return err;
}

// ===========================================================================
// f32: CUDA cores, 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns
// the block's rows 4*ty .. 4*ty+3 and, of each 64 x 64 score tile, the
// columns tx + 16*j (j < 4); of the outputs, head-dim columns tx + 16*c
// ===========================================================================

constexpr int NT = 256;

// Stage rows [r0, r0 + 64) of a (len, D) matrix into smem rows of stride
// D + 1; rows past len are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int len) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = (r0 + r < len) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_simt_smem() {
  // Q, dO, K, V tiles (stride D+1), dS (stride BKV+1), lse and delta
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BKV * (D + 1) +
                                  BQ * (BKV + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_simt_smem() {
  // K, V, Q, dO tiles (stride D+1), P^T and dS^T (stride BQ+1), lse, delta
  return sizeof(float) * (size_t)(2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BKV * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT)
    dq_simt_kernel(Args a, float* __restrict__ dq) {
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
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qoff = (size_t)(b * a.Hq + h) * a.Sq;
  const size_t kvoff = (size_t)(b * a.Hkv + hk) * a.Skv * D;
  const float* kb = static_cast<const float*>(a.k) + kvoff;
  const float* vb = static_cast<const float*>(a.v) + kvoff;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  stage<D>(Qs, static_cast<const float*>(a.q) + qoff * D, q0, a.Sq);
  stage<D>(Os, static_cast<const float*>(a.dout) + qoff * D, q0, a.Sq);
  for (int r = tid; r < BQ; r += NT) {
    Ls[r] = (q0 + r < a.Sq) ? a.lse[qoff + q0 + r] : 0.f;
    Ds[r] = (q0 + r < a.Sq) ? a.delta[qoff + q0 + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int kv_lo, kv_hi;
  kv_range(a, q0, kv_lo, kv_hi);
  for (int c0 = kv_lo; c0 < kv_hi; c0 += BKV) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<D>(Ks, kb, c0, a.Skv);
    stage<D>(Vs, vb, c0, a.Skv);
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
      const bool row_ok = q0 + r < a.Sq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = row_ok && unmasked(q0 + r + a.kv_offset, col, a.Skv,
                                           a.causal, a.has_window, a.window);
        const float p = ok ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
        Ss[r * PP + tx + 16 * j] = p * (dp[i][j] - Ds[r]) * a.scale;
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

  float* dqb = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      dqb[(size_t)r * D + tx + 16 * cc] = acc[i][cc];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
    dkv_simt_kernel(Args a, float* __restrict__ dk, float* __restrict__ dv) {
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
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const size_t kvoff = (size_t)(b * a.Hkv + hk) * a.Skv * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  stage<D>(Ks, static_cast<const float*>(a.k) + kvoff, k0, a.Skv);
  stage<D>(Vs, static_cast<const float*>(a.v) + kvoff, k0, a.Skv);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int q_lo, q_hi;
  q_range(a, k0, q_lo, q_hi);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const size_t qoff = (size_t)(b * a.Hq + h) * a.Sq;
    const float* qb = static_cast<const float*>(a.q) + qoff * D;
    const float* ob = static_cast<const float*>(a.dout) + qoff * D;
    for (int r0 = q_lo; r0 < q_hi; r0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are read
      stage<D>(Qs, qb, r0, a.Sq);
      stage<D>(Os, ob, r0, a.Sq);
      for (int r = tid; r < BQ; r += NT) {
        Ls[r] = (r0 + r < a.Sq) ? a.lse[qoff + r0 + r] : 0.f;
        Ds[r] = (r0 + r < a.Sq) ? a.delta[qoff + r0 + r] : 0.f;
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
          const bool ok = r0 + r < a.Sq &&
                          unmasked(r0 + r + a.kv_offset, k0 + c, a.Skv,
                                   a.causal, a.has_window, a.window);
          const float p = ok ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
          Ps[c * PP + r] = p;
          Ss[c * PP + r] = p * (dp[i][j] - Ds[r]) * a.scale;
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= a.Skv) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const size_t at = kvoff + (size_t)c * D + tx + 16 * cc;
      dk[at] = dk_acc[i][cc];
      dv[at] = dv_acc[i][cc];
    }
  }
}

template <int D>
cudaError_t launch_simt(const Args& a, void* dq, void* dk, void* dv,
                        cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (a.Sq > 0) {
    constexpr size_t smem = dq_simt_smem<D>();
    err = cudaFuncSetAttribute(dq_simt_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    dq_simt_kernel<D><<<grid, NT, smem, s>>>(a, static_cast<float*>(dq));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && a.Skv > 0) {
    constexpr size_t smem = dkv_simt_smem<D>();
    err = cudaFuncSetAttribute(dkv_simt_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Skv + BKV - 1) / BKV, a.Hkv, a.B);
    dkv_simt_kernel<D><<<grid, NT, smem, s>>>(a, static_cast<float*>(dk),
                                              static_cast<float*>(dv));
    err = cudaGetLastError();
  }
  return err;
}

template <int D>
cudaError_t launch(int dtype, const Args& a, void* dq, void* dk, void* dv,
                   cudaStream_t s) {
  if (dtype == 0) return launch_simt<D>(a, dq, dk, dv, s);
  if (dtype == 1) return launch_mma<D>(a, dq, dk, dv, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); lse, delta:
// (B, Hq, Sq) float32; dq like q; dk, dv like k, each the sum over the kv
// head's group of query heads; all contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = success).
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
  switch (Dh) {
    case 16: err = launch<16>(dtype, a, dq, dk, dv, s); break;
    case 32: err = launch<32>(dtype, a, dq, dk, dv, s); break;
    case 64: err = launch<64>(dtype, a, dq, dk, dv, s); break;
    case 80: err = launch<80>(dtype, a, dq, dk, dv, s); break;
    case 128: err = launch<128>(dtype, a, dq, dk, dv, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
