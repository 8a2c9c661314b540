// Grouped (per-expert) matmul for Hopper: (E, C, K) @ (E, K, N) -> (E, C, N).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::grouped_matmul
// (Pallas `_gmm_kernel`), the expert FFN of the MoE layer: three calls per
// MoE layer (w1, w3, w2) in decode and prefill, and two more per call in
// training's backward (dlhs = dout @ rhs^T, drhs = lhs^T @ dout).
//
// What bounds it on an H100 (phi3.5-moe: E = 16, K x N = 4096 x 6400):
//   * decode (C = 4 rows per expert) reads every expert weight once and
//     does C multiply-adds per weight: bound by the weight bytes (w1:
//     839 MB, 0.25 ms at 3.35 TB/s);
//   * prefill and training (C = 640) do 2*E*C*K*N = 537 GFLOP a call:
//     bound by operations (0.54 ms at the 989 TFLOP/s bf16 tensor-core
//     peak).
//
// Operand layouts.  lhs is read K-major (row-major (E, C, K)) or, as the
// view lhs^T of training's drhs, C-major; rhs N-major (row-major
// (E, K, N)) or, as the view rhs^T of dlhs, K-major.  Every variant takes
// both layouts of each operand, so the backward copies nothing.
//
// Three variants, chosen by the wrapper (kernels/moe_gmm.py::variant):
//   * wgmma — bf16, K, N (and C for a C-major lhs) multiples of 8, 16-byte
//     aligned bases, C > 16: the tensor-core kernel.  One block per (128-row
//     C tile, 256-column N tile, expert): a producer warp keeps a ring of
//     4 K stages (64 deep) filled with TMA loads (128-byte swizzle, 3-D
//     tensor maps so a box past C, K or N reads zeros, never the next
//     expert), two consumer warpgroups each run wgmma m64n256k16 on 64 rows
//     with f32 accumulators in registers, stages are handed over through
//     mbarriers.  The descriptors' transpose bits read an MN-major operand
//     as it lies.  The output is rounded once to bf16, stores guarded.
//   * decode — bf16, C <= 16, lhs K-major, rhs N-major, K and N multiples
//     of 8: the bandwidth path.  One block per (64-column N strip, expert)
//     streams the strip's K x 64 weights through a 4-stage cp.async ring
//     (16-byte loads, XOR-swizzled rows) with the lhs rows beside them;
//     each warp multiplies 16 columns with mma.sync m16n8k16 (rows padded
//     to 16 with zeros, fragments by ldmatrix).
//   * simt — everything else (f32, unaligned shapes or bases): one block
//     per (expert, C tile, N tile), tiles staged through shared memory as
//     f32, f32 FMA, ragged edges masked.  f32 stays here because the
//     tensor cores would round f32 operands to tf32.
//
// Tensor maps are encoded on the host by csrc/tma_host.cuh
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda).
//
// Sizes.  Every element offset is formed in 64 bits (size_t, or the long
// long Strides), and the tensor maps take 64-bit dims and strides, so no
// product of E, C, K and N is limited: jamba's expert FFN at C = 10240 has
// 2.35e9 output elements.  What is 32-bit: E, C, K and N each (ints here,
// and TMA's box coordinates), a grid's y and z dims (65535), and a tensor
// map's stride (below 2^40 bytes); kernels/moe_gmm.py refuses a call past
// any of them before it launches.
//
// C interface: repro_grouped_matmul(...) launches the variant asked for on
// the given stream and returns cudaGetLastError() (cudaErrorInvalidValue
// for a variant that cannot take the call); the caller allocates the
// output, contiguous (E, C, N).

#include "ptx.cuh"
#include "tma_host.cuh"

#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of one expert's operands: lhs (c, k), rhs (k, n).
struct Strides {
  long long lc, lk, rk, rn;
};

// ---------------------------------------------------------------------------
// simt: BM x BN output tile per block, BK deep K step, TM x TN per thread;
// STRIDED reads the strides `st`, otherwise both operands row-major
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, int TM, int TN, bool STRIDED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gmm_simt_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                    T* __restrict__ out, int C, int K, int N, Strides st) {
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
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, kk = idx % BK;
      const int gm = m0 + m, gk = k0 + kk;
      const size_t at = STRIDED ? gm * st.lc + gk * st.lk : (size_t)gm * K + gk;
      As[kk][m] = (gm < C && gk < K) ? to_f32(A[at]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gn = n0 + n;
      const size_t at = STRIDED ? gk * st.rk + gn * st.rn : (size_t)gk * N + gn;
      Bs[kk][n] = (gk < K && gn < N) ? to_f32(B[at]) : 0.f;
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

template <typename T, int BM, int BN, int BK, int TM, int TN, bool STRIDED>
void launch_simt(const void* lhs, const void* rhs, void* out, int E, int C,
                 int K, int N, Strides st, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
  const dim3 block((BM / TM) * (BN / TN));
  gmm_simt_kernel<T, BM, BN, BK, TM, TN, STRIDED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<T*>(out), C, K, N, st);
}

template <typename T, bool STRIDED>
void simt(const void* lhs, const void* rhs, void* out, int E, int C, int K,
          int N, Strides st, cudaStream_t stream) {
  if (C <= 8)
    launch_simt<T, 8, 128, 32, 1, 4, STRIDED>(lhs, rhs, out, E, C, K, N, st,
                                              stream);
  else
    launch_simt<T, 128, 128, 8, 8, 8, STRIDED>(lhs, rhs, out, E, C, K, N, st,
                                               stream);
}

template <typename T>
void simt(const void* lhs, const void* rhs, void* out, int E, int C, int K,
          int N, int lhs_mn, int rhs_k, cudaStream_t stream) {
  const Strides st{lhs_mn ? 1 : (long long)K, lhs_mn ? (long long)C : 1,
                   rhs_k ? 1 : (long long)N, rhs_k ? (long long)K : 1};
  if (lhs_mn || rhs_k)
    simt<T, true>(lhs, rhs, out, E, C, K, N, st, stream);
  else
    simt<T, false>(lhs, rhs, out, E, C, K, N, st, stream);
}

// ---------------------------------------------------------------------------
// wgmma: TMA producer warp + two consumer warpgroups (bf16)
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;            // 16 KiB
constexpr int B_BYTES = BN * BK * 2;            // 32 KiB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BOX = 64 * 64 * 2;                // one 64 x 64 box, 8 KiB
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
}  // namespace tc

// A_MN: lhs C-major (the tile is two 64-row boxes, k rows of 64 c);
// otherwise K-major (one box of 128 c rows of 64 k).  B_MN: rhs N-major
// (four 64-column boxes, k rows of 64 n); otherwise K-major (one box of 256
// n rows of 64 k).
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(384, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     bf16* __restrict__ out, int C, int K, int N) {
  using namespace tc;
  extern __shared__ uint8_t smem_raw[];
  // stage tiles 1024-byte aligned (the 128-byte swizzle's period)
  const uint32_t raw = ptx::smem_u32(smem_raw);
  uint8_t* tiles = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], 256);     // every consumer thread
    }
    ptx::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    ptx::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) ptx::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* a = tiles + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        const int k0 = kt * BK;
        ptx::mbar_expect_tx(&full[s], STAGE_BYTES);
        if (A_MN) {
          ptx::tma_load_3d(a, &tma_a, &full[s], m0, k0, e);
          ptx::tma_load_3d(a + BOX, &tma_a, &full[s], m0 + 64, k0, e);
        } else {
          ptx::tma_load_3d(a, &tma_a, &full[s], k0, m0, e);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            ptx::tma_load_3d(b + j * BOX, &tma_b, &full[s], n0 + 64 * j, k0,
                             e);
        } else {
          ptx::tma_load_3d(b, &tma_b, &full[s], k0, n0, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows [64 w, 64 w + 64) of the tile --
    ptx::setmaxnreg_inc<232>();
    const int w = wg - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      ptx::mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = ptx::smem_u32(tiles + s * STAGE_BYTES) + w * BOX;
      const uint32_t b = ptx::smem_u32(tiles + s * STAGE_BYTES + A_BYTES);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: 16 k are 32 bytes along a swizzled row; MN-major: 16 k
        // are 16 rows of 128 bytes
        const uint64_t da = A_MN ? ptx::wgmma_desc(a + kk * 2048, BOX, 1024)
                                 : ptx::wgmma_desc(a + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? ptx::wgmma_desc(b + kk * 2048, BOX, 1024)
                                 : ptx::wgmma_desc(b + kk * 32, 16, 1024);
        ptx::wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait<0>();
      ptx::mbar_arrive(&empty[s]);
    }

    // accumulator fragment: row 16*warp + lane/4 (+8), column
    // 8*j + 2*(lane%4) (+1) of the warpgroup's 64 x 256 tile
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int r0 = m0 + 64 * w + 16 * warp + lane / 4;
    bf16* O = out + (size_t)e * C * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
      if (r0 < C)
        *reinterpret_cast<__nv_bfloat162*>(O + (size_t)r0 * N + col) =
            __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
      if (r0 + 8 < C)
        *reinterpret_cast<__nv_bfloat162*>(O + (size_t)(r0 + 8) * N + col) =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

template <bool A_MN, bool B_MN>
cudaError_t launch_wgmma(const void* lhs, const void* rhs, void* out, int E,
                         int C, int K, int N, cudaStream_t stream) {
  cudaError_t err = tma::bind_device();
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  const bool ok = (A_MN ? tma::encode(&ta, lhs, C, K, E, 64)
                        : tma::encode(&ta, lhs, K, C, E, 128)) &&
                  (B_MN ? tma::encode(&tb, rhs, N, K, E, 64)
                        : tma::encode(&tb, rhs, K, N, E, 256));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma_kernel<A_MN, B_MN>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN, E);
  kernel<<<grid, 384, tc::SMEM_BYTES, stream>>>(ta, tb,
                                                static_cast<bf16*>(out), C, K,
                                                N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode: C <= 16, mma.sync over a cp.async ring (bf16)
// ---------------------------------------------------------------------------

namespace dec {
constexpr int BN = 64, BK = 64, STAGES = 4;
constexpr int ROW = 128;                        // bytes of a smem row
}  // namespace dec

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows, the
// chunk index XOR-ed with r % 8 so ldmatrix's 8 rows hit 8 bank groups
__device__ __forceinline__ int swz(int r, int c) {
  return r * dec::ROW + ((c ^ (r & 7)) << 4);
}

__global__ void __launch_bounds__(128)
    gmm_decode_kernel(const bf16* __restrict__ lhs,
                      const bf16* __restrict__ rhs, bf16* __restrict__ out,
                      int C, int K, int N) {
  using namespace dec;
  __shared__ __align__(128) uint8_t sB[STAGES][BK * ROW];  // k rows of 64 n
  __shared__ __align__(128) uint8_t sA[STAGES][16 * ROW];  // c rows of 64 k

  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.y;
  const bf16* A = lhs + (size_t)e * C * K;
  const bf16* B = rhs + (size_t)e * K * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {             // 64 rows x 8 chunks of rhs
      const int idx = tid + 128 * i;
      const int r = idx / 8, c = idx % 8;
      const bool ok = k0 + r < K && n0 + 8 * c < N;
      ptx::cp_async16(sB[s] + swz(r, c),
                      ok ? B + (size_t)(k0 + r) * N + n0 + 8 * c : B, ok);
    }
    const int r = tid / 8, c = tid % 8;       // 16 rows x 8 chunks of lhs
    const bool ok = r < C && k0 + 8 * c < K;
    ptx::cp_async16(sA[s] + swz(r, c),
                    ok ? A + (size_t)r * K + k0 + 8 * c : A, ok);
  };

  float acc[2][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    ptx::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptx::cp_async_wait<STAGES - 2>();         // tile kt has landed
    __syncthreads();                          // ... and tile kt-1 is read
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    ptx::cp_async_commit();
    const int s = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // lane l addresses row l % 8 of matrix l / 8: A's matrices are
      // (rows 0-7 | 8-15) x (k 0-7 | 8-15), B's (k 0-7 | 8-15) x (this
      // warp's n 0-7 | 8-15), transposed into mma.sync's column fragments
      const int half = (lane >> 3) & 1, hi = lane >> 4;
      uint32_t a[4], b[4];
      ptx::ldmatrix_x4(a, sA[s] + swz((lane & 7) + 8 * half, 2 * kk + hi));
      ptx::ldmatrix_x4_trans(
          b, sB[s] + swz(16 * kk + (lane & 7) + 8 * half, 2 * warp + hi));
      ptx::mma_bf16_16816(acc[0], a, b[0], b[1]);
      ptx::mma_bf16_16816(acc[1], a, b[2], b[3]);
    }
  }

  bf16* O = out + (size_t)e * C * N;
  const int row = lane / 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = n0 + 16 * warp + 8 * t + 2 * (lane % 4);
    if (col >= N) continue;
    if (row < C)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row * N + col) =
          __floats2bfloat162_rn(acc[t][0], acc[t][1]);
    if (row + 8 < C)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(acc[t][2], acc[t][3]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// lhs (E, C, K), C-major if lhs_mn else K-major; rhs (E, K, N), K-major if
// rhs_k else N-major; out (E, C, N) contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  variant: 0 = simt, 1 = wgmma, 2 = decode.  Returns a
// cudaError_t (0 = success).
extern "C" int repro_grouped_matmul(const void* lhs, const void* rhs,
                                    void* out, int E, int C, int K, int N,
                                    int lhs_mn, int rhs_k, int dtype,
                                    int variant, void* stream) {
  if (E <= 0 || C <= 0 || N <= 0) return 0;  // empty output: nothing to do
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == 1;
  const bool fits = bf && K > 0 && K % 8 == 0 && N % 8 == 0 &&
                    (!lhs_mn || C % 8 == 0) && aligned16(lhs) &&
                    aligned16(rhs) && aligned16(out);
  if (variant == 0) {
    if (dtype == 0)
      simt<float>(lhs, rhs, out, E, C, K, N, lhs_mn, rhs_k, s);
    else if (bf)
      simt<bf16>(lhs, rhs, out, E, C, K, N, lhs_mn, rhs_k, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 1 && fits) {
    cudaError_t err;
    if (lhs_mn)
      err = rhs_k ? launch_wgmma<true, false>(lhs, rhs, out, E, C, K, N, s)
                  : launch_wgmma<true, true>(lhs, rhs, out, E, C, K, N, s);
    else
      err = rhs_k ? launch_wgmma<false, false>(lhs, rhs, out, E, C, K, N, s)
                  : launch_wgmma<false, true>(lhs, rhs, out, E, C, K, N, s);
    return static_cast<int>(err);
  }
  if (variant == 2 && fits && C <= 16 && !lhs_mn && !rhs_k) {
    const dim3 grid((N + dec::BN - 1) / dec::BN, E);
    gmm_decode_kernel<<<grid, 128, 0, s>>>(static_cast<const bf16*>(lhs),
                                          static_cast<const bf16*>(rhs),
                                          static_cast<bf16*>(out), C, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
