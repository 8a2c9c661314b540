// Flash-attention backward for Hopper (FlashAttention-2): dq, dk, dv from
// q, k, v, dO, the forward's lse and delta = rowsum(dO * O).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (Pallas `_dq_kernel` and `_dkv_kernel` over
// `_bwd_tile`), which training runs once per attention layer.  Per (q row,
// kv column) pair:
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
// in all (0.244 ms).  Operations, not bytes (about 0.2 GB: 0.06 ms at
// 3.35 TB/s), bound it.
//
// Three variants, chosen by the wrapper (kernels/flash_attention_bwd.py::
// variant) and passed in as `variant`.  All keep the reference's split (a
// dq kernel and a dkv kernel that never write one output from two blocks)
// and use no atomics, so two runs on the same inputs are equal bit for bit,
// which a remat recompute's routing and a bit-for-bit restore rely on.
// Masks as the forward: cols < kv_len, causal cols <= rows, window cols >
// rows - window, rows offset by kv_offset; tiles that lie wholly above the
// causal diagonal or outside the window are skipped in both kernels
// (kv_range / q_range), and ragged Sq / Skv are masked.
//
// * wgmma (2) -- bf16 at head dims 64, 80 and 128, 16-byte aligned bases,
//   at least one q and one kv row: Hopper's tensor-core path, TMA, mbarriers
//   and wgmma, warp-specialised as the forward (csrc/flash_attention.cu).
//   One launch holds both kernels' blocks (neither reads the other's
//   output), each 3 warpgroups: the dkv blocks first, the heavy causal kv
//   tiles first, then the dq blocks, the heavy causal q tiles first, so
//   the light blocks of either fill in around the heavy ones:
//     - dq blocks, the forward's structure: one per (q head, batch, 128-row
//       q tile).  A producer warpgroup (registers given up with setmaxnreg)
//       loads the Q and dO tiles once and streams 128-row K and V tiles
//       through a 2-stage ring (full / empty mbarriers); GQA is the map
//       coordinate b*Hkv + h/group.  Two consumer warpgroups of 64 q rows
//       each: S = Q K^T and dP = dO V^T by wgmma m64n128k16 with every
//       operand K-major in shared memory; p and ds in registers on the
//       accumulator layout (lse and delta per row); dQ += dS K by wgmma with
//       A = dS from registers (the accumulator fragment rounded to bf16
//       pairs is the A fragment) and B = the K tile read MN-major (the
//       descriptor's transpose bit), the forward's P V pattern;
//     - dkv blocks in the transposed orientation, so neither P nor dS goes
//       through shared memory: one per (kv head x split, batch, 128-row kv
//       tile).  The K and V tiles load once; the producer streams 64-row Q
//       and dO tiles through a 3-stage ring, one lane issuing the TMA loads
//       and its warp copying the tile's lse * log2(e) and delta into the
//       stage (the full barrier counts the expect_tx and the warp's 32
//       arrivals).  Each consumer warpgroup owns 64 kv rows: S^T = K Q^T and
//       dP^T = V dO^T by wgmma m64n64k16 (Q and dO K-major), P^T and dS^T
//       with lse and delta broadcast along columns from shared memory, then
//       dV += P^T dO and dK += dS^T Q by wgmma with A from registers and dO
//       / Q read MN-major.  dK and dV (64 x 128 f32 each) and the two
//       64 x 64 score tiles stay in registers under setmaxnreg 240;
//     - filling the card: a (Skv/128, Hkv, B) set of dkv blocks is 32 at
//       the tensor-parallel shape (q (1,16,1024,128), 4 kv heads) for 132
//       SMs, each walking 4 heads, so the wrapper splits each kv head's
//       query-head group over `nsplit` blocks (the fewest, a divisor of the
//       group, that give one block per SM; kernels/flash_attention_bwd.py::
//       dkv_splits).  Each block sums its heads in order in f32 registers;
//       with nsplit > 1 it writes f32 partials to the caller's workspace and
//       a second launch sums them in split order and rounds once to bf16
//       (the reference's dk_h, dv_h and group sum): the order is fixed by
//       the shape, never by scheduling;
//     - head dim 80 takes the 128-column tile as the forward: the maps keep
//       the true inner dim, TMA zero-fills columns 80..127, the k steps of
//       S and dP cover the true head dim, and columns 80..127 of dQ, dK and
//       dV are 0 and never stored;
//     - the exp and mask work between the products is what the tensor cores
//       wait on (each consumer warpgroup runs its products, then its
//       elementwise work), so it is kept short: p = 2^(s * scale log2(e) -
//       lse log2(e)), one fused multiply-add and the special function
//       unit's ex2 (2 ulp, subnormals flushed), with lse * log2(e) formed
//       once per row, in place of expf of x = s * scale rounded.  Its error
//       in p (under 2^-10 relative at |x| of thousands, under 2^-18 at |x|
//       of tens) is below the bf16 rounding p and ds get as they enter a
//       product, as in the mma variant; every sum is f32; a fully masked
//       row gives dq = 0;
//     - warpgroup tiles with no unmasked pair (past the causal diagonal,
//       before the window, past Sq / Skv) skip their products; masks are
//       computed only where a tile straddles an edge.  Turn-taking between
//       the two consumer warpgroups (named barriers, FlashAttention-3's
//       ping-pong), alone or with a tile's last products issued beside the
//       next tile's first, made both kernels slower (PERF.md; the second
//       spills registers at head dim 128).
// * mma (1) -- bf16 at head dims 16 and 32 (and any head dim when forced):
//   the Ampere-style tensor-core kernels, mma.sync m16n8k16 with cp.async
//   and ldmatrix, 4 warps on 64 x 64 tiles:
//     - dq kernel: one block per (batch, q head, 64-row q tile), looping
//       over 64-column kv tiles; the dq accumulator lives in registers.
//     - dkv kernel: one block per (batch, kv head, 64-row kv tile), looping
//       over the group's Hq / Hkv query heads in order and, for each, over
//       the 64-row q tiles; it sums the group in its registers and writes dk
//       and dv as (B, Hkv, Skv, Dh).
//     - tiles are staged in shared memory as bf16 (rows padded by 16 bytes,
//       so ldmatrix's 8 row addresses hit 8 bank groups) by cp.async, the
//       next kv (dq kernel) or q (dkv kernel) tile loading while the current
//       one is multiplied (at head dim 80 a row is 5 k steps of 16 and 10 n
//       tiles of 8, its pitch 176 bytes: an odd count of 16-byte units, so
//       ldmatrix's 8 rows still hit 8 bank groups).  q.k and dO.v^T read
//       their operands with ldmatrix; p and ds stay in registers, rounded to
//       bf16 as they enter the next product (the accumulator fragment of
//       m16n8 is the A fragment of m16k16), as FlashAttention-2 does; the
//       products with k, q and dO read them with ldmatrix.trans.
// * simt (0) -- f32: the same split on CUDA cores (f32 FMA, tiles staged as
//   f32 with an odd row stride, 256 threads of 4 x 4 outputs), since the
//   tensor cores would round f32 operands to tf32.
//
// delta = rowsum(dO * O) is the first kernel of every call (one warp a
// row, f32, a fixed order); the reference computes it with jnp outside its
// Pallas calls, and a torch reduction there took 0.2 ms of the 1.1 at the
// training shape (its f32 temporaries of dO and O).
//
// C interface: repro_flash_attention_bwd(...) launches the delta kernel and
// the variant asked for (simt and mma: the dq kernel, then the dkv kernel;
// wgmma: one launch of both, then with nsplit > 1 the group sum) on the
// given stream and returns the
// first cudaGetLastError() that is not success (cudaErrorInvalidValue for
// a variant that cannot take the call); the caller allocates the outputs,
// delta and the workspace.

#include "ptx.cuh"
#include "tma_host.cuh"

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

// kv columns [lo, hi) that some q row of [q0, q0 + TQ) can see; lo is
// rounded down to a TKV-column tile
template <int TQ, int TKV>
__device__ __forceinline__ void kv_range(const Args& a, int q0, int& lo,
                                         int& hi) {
  const int row_lo = q0 + a.kv_offset;
  const int row_hi = min(q0 + TQ, a.Sq) - 1 + a.kv_offset;
  lo = 0;
  hi = a.Skv;
  if (a.causal) hi = min(hi, row_hi + 1);
  if (a.has_window) lo = max(0, row_lo - a.window + 1);
  lo = (lo / TKV) * TKV;
}

// q rows [lo, hi) that can see some column of [k0, k0 + TKV): causal needs
// r + kv_offset >= k0, the window r + kv_offset < k_last + window; lo is
// rounded down to a TQ-row tile
template <int TKV, int TQ>
__device__ __forceinline__ void q_range(const Args& a, int k0, int& lo,
                                        int& hi) {
  const int k_last = min(k0 + TKV, a.Skv) - 1;
  lo = 0;
  hi = a.Sq;
  if (a.causal) lo = max(0, k0 - a.kv_offset);
  if (a.has_window) hi = min(hi, k_last + a.window - a.kv_offset);
  lo = (lo / TQ) * TQ;
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
  kv_range<BQ, BKV>(a, q0, kv_lo, kv_hi);
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
  q_range<BKV, BQ>(a, k0, q_lo, q_hi);
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
  kv_range<BQ, BKV>(a, q0, kv_lo, kv_hi);
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
  q_range<BKV, BQ>(a, k0, q_lo, q_hi);
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

// ===========================================================================
// bf16 wgmma: a TMA producer warpgroup and two consumer warpgroups (Dh 64,
// 80, 128)
// ===========================================================================

namespace tc {
constexpr int NT = 384;          // producer + 2 consumer warpgroups
constexpr int BKV = 128;         // kv rows per tile (both kernels)
constexpr int BQ_DQ = 128;       // dq blocks: q rows per block
constexpr int BQ_KV = 64;        // dkv blocks: q rows per streamed tile
constexpr int DQ_STAGES = 2;     // the dq blocks' K, V ring
constexpr int KV_STAGES = 3;     // the dkv blocks' Q, dO ring
constexpr int ROW = 128;         // bytes of a box row: 64 bf16, swizzled
constexpr float LOG2E = 1.4426950408889634f;

// The tile width of head dim D: whole 64-column boxes (80 -> 128; TMA
// zero-fills the columns past D)
template <int D>
__host__ __device__ constexpr int tile_dim() {
  return (D + 63) / 64 * 64;
}

template <int D>
__host__ __device__ constexpr int boxes() {
  return tile_dim<D>() / 64;
}

// dq blocks: Q, dO, then per stage a K and a V tile, then the mbarriers
template <int D>
constexpr int dq_smem() {
  return 1024 + (2 + 2 * DQ_STAGES) * boxes<D>() * BKV * ROW +
         (2 * DQ_STAGES + 1) * 8;
}

// dkv blocks: K, V, then per stage a Q and a dO tile, then lse * log2(e)
// and delta per stage, then the mbarriers
template <int D>
constexpr int dkv_smem() {
  return 1024 + 2 * boxes<D>() * BKV * ROW +
         KV_STAGES * (2 * boxes<D>() * BQ_KV * ROW + 2 * BQ_KV * 4) +
         (2 * KV_STAGES + 1) * 8;
}
}  // namespace tc

// every (row, col) of rows [r_lo, r_hi] x cols [c_lo, c_hi] unmasked
__device__ __forceinline__ bool all_unmasked(const Args& a, int r_lo,
                                             int r_hi, int c_lo, int c_hi) {
  return r_hi < a.Sq && c_hi < a.Skv &&
         (!a.causal || c_hi <= r_lo + a.kv_offset) &&
         (!a.has_window || c_lo > r_hi + a.kv_offset - a.window);
}

// no (row, col) of rows [r_lo, r_hi] x cols [c_lo, c_hi] unmasked
__device__ __forceinline__ bool none_unmasked(const Args& a, int r_lo,
                                              int r_hi, int c_lo, int c_hi) {
  return r_lo >= a.Sq || c_lo >= a.Skv ||
         (a.causal && c_lo > r_hi + a.kv_offset) ||
         (a.has_window && c_hi <= r_lo + a.kv_offset - a.window);
}

// An m64nN accumulator (N = 16 * K16 columns) as the A fragments of K16
// k steps of 16 columns, rounded to bf16 pairs: k step kk is
// acc[8 kk .. 8 kk + 7] in the order (row r0, r0 + 8, r0, r0 + 8)
template <int K16>
__device__ __forceinline__ void a_fragments(uint32_t (&fa)[K16][4],
                                            const float (&acc)[8 * K16]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fa[kk][e] = ptx::pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

// acc (64 x DT) += A (64 x 16 K16, fragments) * B (16 K16 x DT): B's k
// steps 16 rows of the tile at `b` apart (TMA wrote it in `box`-byte boxes
// of 64 columns), read MN-major
template <int DT, int K16>
__device__ __forceinline__ void rs_product(float (&acc)[DT / 2],
                                           const uint32_t (&fa)[K16][4],
                                           uint32_t b, uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const uint64_t db = ptx::wgmma_desc(b + kk * 16 * tc::ROW, box, 1024);
    if constexpr (DT == 128)
      ptx::wgmma_m64n128k16_rs<1>(acc, fa[kk], db);
    else
      ptx::wgmma_m64n64k16_rs<1>(acc, fa[kk], db);
  }
}

// A thread's two rows of an m64 accumulator (DT columns, the first D
// stored) to `out` (row stride D), rows at or past `len` dropped
template <int D, int DT, typename T>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[DT / 2],
                                          const int (&row)[2], int len,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= len) continue;
      T* at = out + (size_t)row[r] * D + 8 * j + 2 * (lane % 4);
      const float x = acc[4 * j + 2 * r], y = acc[4 * j + 2 * r + 1];
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(at) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
    }
}

// The block of (q head h, batch b, the 128 q rows from q0) of the dq
// kernel: dq = sum over the visible kv tiles of dS K
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap* tma_q,
                                         const CUtensorMap* tma_do,
                                         const CUtensorMap* tma_k,
                                         const CUtensorMap* tma_v,
                                         const Args& a, bf16* dq, int h,
                                         int b, int q0, uint8_t* smem_raw) {
  constexpr int BQ = tc::BQ_DQ, BKV = tc::BKV, STAGES = tc::DQ_STAGES;
  constexpr int DT = tc::tile_dim<D>(), NB = tc::boxes<D>();
  constexpr int BOX = BKV * tc::ROW;          // 128 rows x 64 bf16: 16 KiB
  constexpr int TILE = NB * BOX;              // a 128-row Q, dO, K or V tile
  // tiles 1024-byte aligned (the 128-byte swizzle's period)
  const uint32_t raw = ptx::smem_u32(smem_raw);
  uint8_t* qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* dos = qs + TILE;
  uint8_t* ring = dos + TILE;                 // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = b * a.Hq + h;
  const int bhk = b * a.Hkv + h / (a.Hq / a.Hkv);
  const int wg = threadIdx.x / 128;
  int kv_lo, kv_hi;
  kv_range<BQ, BKV>(a, q0, kv_lo, kv_hi);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], 256);         // every consumer thread
    }
    ptx::mbar_init(qbar, 1);
    ptx::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    ptx::setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      ptx::mbar_expect_tx(qbar, 2 * TILE);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        ptx::tma_load_3d(qs + j * BOX, tma_q, qbar, 64 * j, q0, bh);
        ptx::tma_load_3d(dos + j * BOX, tma_do, qbar, 64 * j, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) ptx::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* ks = ring + s * 2 * TILE;
        const int c0 = kv_lo + t * BKV;
        ptx::mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ptx::tma_load_3d(ks + j * BOX, tma_k, &full[s], 64 * j, c0, bhk);
          ptx::tma_load_3d(ks + TILE + j * BOX, tma_v, &full[s], 64 * j, c0,
                           bhk);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns q rows [64 w, 64 w + 64) of the tile
    ptx::setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator fragment: d[4j + e] lies in row r0 (e < 2) or r0 + 8
    // (e >= 2) of the warpgroup's 64 rows, column 8j + 2 (lane % 4) + e % 2
    const int r0 = 16 * warp + lane / 4;
    const int w_lo = q0 + 64 * w;
    const int row[2] = {w_lo + r0, w_lo + r0 + 8};
    const float scale2 = a.scale * tc::LOG2E;
    float lse2[2], dlt[2];             // lse * log2(e) and delta of the rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < a.Sq;
      lse2[r] = ok ? a.lse[(size_t)bh * a.Sq + row[r]] * tc::LOG2E : 0.f;
      dlt[r] = ok ? a.delta[(size_t)bh * a.Sq + row[r]] : 0.f;
    }
    float acc[DT / 2], s[64], dp[64];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.f;
    const uint32_t q_base = ptx::smem_u32(qs) + w * 64 * tc::ROW;
    const uint32_t do_base = ptx::smem_u32(dos) + w * 64 * tc::ROW;

    if (n_tiles > 0) ptx::mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      const int c0 = kv_lo + t * BKV;
      ptx::mbar_wait(&full[st], (t / STAGES) & 1);
      if (!none_unmasked(a, w_lo, w_lo + 63, c0, c0 + BKV - 1)) {
        const uint32_t k_base = ptx::smem_u32(ring + st * 2 * TILE);
        const uint32_t v_base = k_base + TILE;

        // S = Q K^T and dP = dO V^T, every operand K-major; the k steps
        // cover the true head dim (zero-filled columns add nothing)
        ptx::fence_regs(s);
        ptx::fence_regs(dp);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
          ptx::wgmma_m64n128k16_ss<0, 0>(
              s, ptx::wgmma_desc(q_base + off, 16, 1024),
              ptx::wgmma_desc(k_base + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
          ptx::wgmma_m64n128k16_ss<0, 0>(
              dp, ptx::wgmma_desc(do_base + off, 16, 1024),
              ptx::wgmma_desc(v_base + off, 16, 1024), kk > 0);
        }
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_regs(s);
        ptx::fence_regs(dp);

        // p = 2^(s scale log2(e) - lse log2(e)), ds = p (dp - delta) scale
        // in place of s; masks only where the tile straddles Sq, Skv, the
        // diagonal or the window
        const bool edge =
            !all_unmasked(a, w_lo, w_lo + 63, c0, c0 + BKV - 1);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i / 2) % 2;
          const int col = c0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const bool ok =
              !edge || (row[r] < a.Sq &&
                        unmasked(row[r] + a.kv_offset, col, a.Skv, a.causal,
                                 a.has_window, a.window));
          const float p = ok ? ptx::ex2(fmaf(s[i], scale2, -lse2[r])) : 0.f;
          s[i] = p * (dp[i] - dlt[r]) * a.scale;
        }

        // dQ += dS K: dS as bf16 A fragments, the K tile read MN-major
        uint32_t fa[8][4];
        a_fragments<8>(fa, s);
        ptx::fence_regs(acc);
        ptx::wgmma_fence();
        rs_product<DT, 8>(acc, fa, k_base, BOX);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_regs(acc);
      }
      ptx::mbar_arrive(&empty[st]);
    }
    store_acc<D, DT>(dq + (size_t)bh * a.Sq * D, acc, row, a.Sq, lane);
  }
}

// The block of (kv head x split x = hk * nsplit + split, batch b, the 128
// kv rows from k0) of the dkv kernel: dk and dv of those rows, summed over
// the split's query heads in order
template <int D>
__device__ __forceinline__ void dkv_block(const CUtensorMap* tma_q,
                                          const CUtensorMap* tma_do,
                                          const CUtensorMap* tma_k,
                                          const CUtensorMap* tma_v,
                                          const Args& a, int nsplit,
                                          bf16* dk, bf16* dv, float* part,
                                          int x, int b, int k0,
                                          uint8_t* smem_raw) {
  constexpr int BKV = tc::BKV, BQ = tc::BQ_KV, STAGES = tc::KV_STAGES;
  constexpr int DT = tc::tile_dim<D>(), NB = tc::boxes<D>();
  constexpr int KBOX = BKV * tc::ROW;         // 128 rows x 64 bf16: 16 KiB
  constexpr int QBOX = BQ * tc::ROW;          // 64 rows x 64 bf16: 8 KiB
  constexpr int KTILE = NB * KBOX, QTILE = NB * QBOX;
  const uint32_t raw = ptx::smem_u32(smem_raw);
  uint8_t* ks = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* vs = ks + KTILE;
  uint8_t* ring = vs + KTILE;                 // stage s: Q, then dO
  float* lses = reinterpret_cast<float*>(ring + STAGES * 2 * QTILE);
  float* dlts = lses + STAGES * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(dlts + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int split = x % nsplit;
  const int hk = x / nsplit;
  const int heads = a.Hq / a.Hkv / nsplit;    // this block's query heads
  const int h0 = hk * (a.Hq / a.Hkv) + split * heads;
  const int bhk = b * a.Hkv + hk;
  const int wg = threadIdx.x / 128;
  int q_lo, q_hi;
  q_range<BKV, BQ>(a, k0, q_lo, q_hi);
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int total = heads * n_qt;    // (query head, q tile) steps, in order

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ptx::mbar_init(&full[s], 1 + 32);       // expect_tx + the loader warp
      ptx::mbar_init(&empty[s], 256);
    }
    ptx::mbar_init(kvbar, 1);
    ptx::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads, every lane copies
    // lse * log2(e) and delta of the tile's rows into the stage ----
    ptx::setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && total > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        ptx::mbar_expect_tx(kvbar, 2 * KTILE);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ptx::tma_load_3d(ks + j * KBOX, tma_k, kvbar, 64 * j, k0, bhk);
          ptx::tma_load_3d(vs + j * KBOX, tma_v, kvbar, 64 * j, k0, bhk);
        }
      }
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) ptx::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        const int bh = b * a.Hq + h0 + i / n_qt;
        const int r0 = q_lo + BQ * (i % n_qt);
        uint8_t* qd = ring + s * 2 * QTILE;
        if (lane == 0) {
          ptx::mbar_expect_tx(&full[s], 2 * QTILE);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            ptx::tma_load_3d(qd + j * QBOX, tma_q, &full[s], 64 * j, r0, bh);
            ptx::tma_load_3d(qd + QTILE + j * QBOX, tma_do, &full[s], 64 * j,
                             r0, bh);
          }
        }
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = r0 + r < a.Sq;
          const size_t at = (size_t)bh * a.Sq + r0 + r;
          lses[s * BQ + r] = ok ? a.lse[at] * tc::LOG2E : 0.f;
          dlts[s * BQ + r] = ok ? a.delta[at] : 0.f;
        }
        ptx::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns kv rows [64 w, 64 w + 64) of the
    // tile; its score tiles are transposed: row = kv row, column = q row
    ptx::setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;
    const int w_lo = k0 + 64 * w;
    const int kv[2] = {w_lo + r0, w_lo + r0 + 8};
    const float scale2 = a.scale * tc::LOG2E;
    float dk_acc[DT / 2], dv_acc[DT / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    const uint32_t k_base = ptx::smem_u32(ks) + w * 64 * tc::ROW;
    const uint32_t v_base = ptx::smem_u32(vs) + w * 64 * tc::ROW;

    if (total > 0) ptx::mbar_wait(kvbar, 0);
    for (int i = 0; i < total; ++i) {
      const int s = i % STAGES;
      const int q0 = q_lo + BQ * (i % n_qt);
      ptx::mbar_wait(&full[s], (i / STAGES) & 1);
      if (!none_unmasked(a, q0, q0 + BQ - 1, w_lo, w_lo + 63)) {
        const uint32_t q_base = ptx::smem_u32(ring + s * 2 * QTILE);
        const uint32_t o_base = q_base + QTILE;

        // S^T = K Q^T and dP^T = V dO^T, every operand K-major
        ptx::fence_regs(st);
        ptx::fence_regs(dpt);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * KBOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * QBOX + (kk % 4) * 32;
          ptx::wgmma_m64n64k16_ss<0, 0>(
              st, ptx::wgmma_desc(k_base + ko, 16, 1024),
              ptx::wgmma_desc(q_base + qo, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * KBOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * QBOX + (kk % 4) * 32;
          ptx::wgmma_m64n64k16_ss<0, 0>(
              dpt, ptx::wgmma_desc(v_base + ko, 16, 1024),
              ptx::wgmma_desc(o_base + qo, 16, 1024), kk > 0);
        }
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_regs(st);
        ptx::fence_regs(dpt);

        // P^T in place of S^T, dS^T in place of dP^T, with lse * log2(e)
        // and delta of each column (q row) from the stage
        const float* L = lses + s * BQ;
        const float* Dl = dlts + s * BQ;
        const bool edge =
            !all_unmasked(a, q0, q0 + BQ - 1, w_lo, w_lo + 63);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
          const bool ok =
              !edge || (q0 + c < a.Sq &&
                        unmasked(q0 + c + a.kv_offset, kv[(e / 2) % 2], a.Skv,
                                 a.causal, a.has_window, a.window));
          const float p = ok ? ptx::ex2(fmaf(st[e], scale2, -L[c])) : 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - Dl[c]) * a.scale;
        }

        // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q read
        // MN-major
        uint32_t fp[4][4], fs[4][4];
        a_fragments<4>(fp, st);
        a_fragments<4>(fs, dpt);
        ptx::fence_regs(dv_acc);
        ptx::fence_regs(dk_acc);
        ptx::wgmma_fence();
        rs_product<DT, 4>(dv_acc, fp, o_base, QBOX);
        rs_product<DT, 4>(dk_acc, fs, q_base, QBOX);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_regs(dv_acc);
        ptx::fence_regs(dk_acc);
      }
      ptx::mbar_arrive(&empty[s]);
    }

    const size_t at = (size_t)bhk * a.Skv * D;
    if (nsplit == 1) {
      store_acc<D, DT>(dk + at, dk_acc, kv, a.Skv, lane);
      store_acc<D, DT>(dv + at, dv_acc, kv, a.Skv, lane);
    } else {    // f32 partials: (2, nsplit, B * Hkv * Skv * D), dk then dv
      const size_t n = (size_t)a.B * a.Hkv * a.Skv * D;
      store_acc<D, DT>(part + split * n + at, dk_acc, kv, a.Skv, lane);
      store_acc<D, DT>(part + (nsplit + split) * n + at, dv_acc, kv, a.Skv,
                       lane);
    }
  }
}

// One launch of both kernels' blocks (neither reads the other's output):
// the dkv blocks first, kv tile by kv tile from the first (the heaviest
// under a causal mask), then the dq blocks from the last q tile (the
// heaviest); `n_dkv` blocks of the first kind
template <int D>
__global__ void __launch_bounds__(tc::NT, 1)
    bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q128,
                     const __grid_constant__ CUtensorMap do128,
                     const __grid_constant__ CUtensorMap q64,
                     const __grid_constant__ CUtensorMap do64,
                     const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm, Args a,
                     int nsplit, int n_dkv, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  int id = blockIdx.x;
  if (id < n_dkv) {
    const int X = a.Hkv * nsplit;
    dkv_block<D>(&q64, &do64, &km, &vm, a, nsplit, dk, dv, part, id % X,
                 (id / X) % a.B, id / (X * a.B) * tc::BKV, smem_raw);
  } else {
    id -= n_dkv;
    const int n_qt = (a.Sq + tc::BQ_DQ - 1) / tc::BQ_DQ;
    dq_block<D>(&q128, &do128, &km, &vm, a, dq, id % a.Hq,
                (id / a.Hq) % a.B,
                (n_qt - 1 - id / (a.Hq * a.B)) * tc::BQ_DQ, smem_raw);
  }
}

// dk and dv (n values each, bf16) = the sum of the dkv kernel's nsplit f32
// partials in split order, rounded once; 4 values a thread (n is a multiple
// of the head dim, so of 16)
__global__ void group_sum_kernel(const float* __restrict__ part, int nsplit,
                                 size_t n, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv) {
  const size_t i4 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i4 >= 2 * n) return;
  const size_t which = i4 >= n;
  const size_t i = i4 - which * n;
  const float* src = part + which * nsplit * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int c = 1; c < nsplit; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(src + c * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* out = (which ? dv : dk) + i;
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc.x, acc.y);
  *reinterpret_cast<__nv_bfloat162*>(out + 2) =
      __floats2bfloat162_rn(acc.z, acc.w);
}

template <int D>
cudaError_t launch_wgmma(const Args& a, void* dq, void* dk, void* dv,
                         int nsplit, float* part, cudaStream_t s) {
  cudaError_t err = tma::bind_device();
  if (err != cudaSuccess) return err;
  // Q and dO in 128-row boxes (dq blocks) and 64-row boxes (dkv blocks),
  // K and V in 128-row boxes (both)
  CUtensorMap q128, do128, q64, do64, km, vm;
  if (!(tma::encode(&q128, a.q, D, a.Sq, a.B * a.Hq, tc::BQ_DQ) &&
        tma::encode(&do128, a.dout, D, a.Sq, a.B * a.Hq, tc::BQ_DQ) &&
        tma::encode(&q64, a.q, D, a.Sq, a.B * a.Hq, tc::BQ_KV) &&
        tma::encode(&do64, a.dout, D, a.Sq, a.B * a.Hq, tc::BQ_KV) &&
        tma::encode(&km, a.k, D, a.Skv, a.B * a.Hkv, tc::BKV) &&
        tma::encode(&vm, a.v, D, a.Skv, a.B * a.Hkv, tc::BKV)))
    return cudaErrorInvalidValue;
  const int n_qt = (a.Sq + tc::BQ_DQ - 1) / tc::BQ_DQ;
  const int n_kt = (a.Skv + tc::BKV - 1) / tc::BKV;
  constexpr int smem = tc::dq_smem<D>() > tc::dkv_smem<D>()
                           ? tc::dq_smem<D>()
                           : tc::dkv_smem<D>();
  auto kernel = bwd_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_dkv = a.Hkv * nsplit * a.B * n_kt;
  kernel<<<n_dkv + a.Hq * a.B * n_qt, tc::NT, smem, s>>>(
      q128, do128, q64, do64, km, vm, a, nsplit, n_dkv,
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nsplit > 1) {
    const size_t n = (size_t)a.B * a.Hkv * a.Skv * D;
    const size_t threads = 2 * n / 4;
    group_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        part, nsplit, n, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
    err = cudaGetLastError();
  }
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(p[0], p[1]);     // f32 bases may be 4-byte aligned
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// delta[row] = sum_d dout[row, d] * out[row, d] in f32, one warp a row:
// lane l adds columns 2l, 2l + 1, 2l + 64, 2l + 65, ... in order, then the
// lanes' sums meet by xor shuffles (a fixed order); D is even
template <typename T>
__global__ void delta_kernel(const T* __restrict__ dout,
                             const T* __restrict__ out,
                             float* __restrict__ delta, size_t rows, int D) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 x = load2(dout + row * D + d), y = load2(out + row * D + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch_delta(const void* dout, const void* out, float* delta,
                         size_t rows, int D, cudaStream_t s) {
  if (rows == 0) return cudaSuccess;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), delta, rows,
      D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int variant, const Args& a, void* dq, void* dk, void* dv,
                   int nsplit, float* part, cudaStream_t s) {
  if (variant == 0) return launch_simt<D>(a, dq, dk, dv, s);
  if (variant == 1) return launch_mma<D>(a, dq, dk, dv, s);
  if constexpr (D == 64 || D == 80 || D == 128)
    return launch_wgmma<D>(a, dq, dk, dv, nsplit, part, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); lse, delta:
// (B, Hq, Sq) float32, delta written here first (rowsum(dout * out));
// dq like q; dk, dv like k, each the sum over the kv head's group of query
// heads; all contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  variant: 0 = simt (float32), 1 = mma (bfloat16, 16-byte
// aligned bases), 2 = wgmma (bfloat16, Dh 64, 80 or 128, aligned bases,
// Sq and Skv > 0).  nsplit: the wgmma dkv kernel's blocks per kv head (a
// divisor of Hq / Hkv; 1 for the other variants); with nsplit > 1,
// `workspace` holds 2 * nsplit * B * Hkv * Skv * Dh floats.  Returns a
// cudaError_t (0 = success; cudaErrorInvalidValue for a variant that
// cannot take the call).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B,
    int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int has_window,
    int window, int kv_offset, float scale, int dtype, int variant,
    int nsplit, void* workspace, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;   // empty outputs
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) &&
                       aligned16(out) && aligned16(dout) && aligned16(dq) &&
                       aligned16(dk) && aligned16(dv);
  bool ok = false;
  if (variant == 0) ok = dtype == 0 && nsplit == 1;
  if (variant == 1) ok = dtype == 1 && nsplit == 1 && aligned;
  if (variant == 2)
    ok = dtype == 1 && aligned && Sq > 0 && Skv > 0 &&
         (Dh == 64 || Dh == 80 || Dh == 128) && nsplit >= 1 &&
         (Hq / Hkv) % nsplit == 0 && (nsplit == 1 || workspace != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)B * Hq * Sq;
  cudaError_t err =
      dtype == 0
          ? launch_delta<float>(dout, out, static_cast<float*>(delta), rows,
                                Dh, s)
          : launch_delta<bf16>(dout, out, static_cast<float*>(delta), rows,
                               Dh, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Hq, Hkv, Sq, Skv,
               causal, has_window, window, kv_offset, scale};
  float* part = static_cast<float*>(workspace);
  switch (Dh) {
    case 16: err = launch<16>(variant, a, dq, dk, dv, nsplit, part, s); break;
    case 32: err = launch<32>(variant, a, dq, dk, dv, nsplit, part, s); break;
    case 64: err = launch<64>(variant, a, dq, dk, dv, nsplit, part, s); break;
    case 80: err = launch<80>(variant, a, dq, dk, dv, nsplit, part, s); break;
    case 128:
      err = launch<128>(variant, a, dq, dk, dv, nsplit, part, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
