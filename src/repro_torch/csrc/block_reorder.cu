// The derived-datatype block reorder of the factorized all-to-all on
// Hopper: one persistent row-map copy that serves the round-k pack, the
// round-k unpack and the fused unpack(k) then pack(k') between two rounds.
//
// Replaces the TPU kernel src/repro/kernels/block_reorder.py::datatype_pack
// and its inverse ::datatype_unpack (Pallas `_pack_kernel`, whose BlockSpec
// index maps are the derived datatype).  In the port,
// torch.distributed's all_to_all_single takes one contiguous buffer split
// along dim 0, so the rearrangement the paper leaves implicit is one pass
// at every round boundary; kernels/block_reorder.py composes the pass's
// row map on the host.
//
// What it computes.  On a (p, B) buffer of any dtype, every pass is a
// permutation of the p rows, dst[r] = src[map[r]].  The host collapses
// the map into n_runs runs of g rows that are contiguous in source and
// destination (g = the gcd of the map's maximal run lengths, so every
// run starts at a multiple of g rows on both sides): run r copies
// run_bytes = g * B * itemsize bytes from source run run_src[r] to
// destination run r.  A (2,2) round moves 4 runs of p/4 rows.
//
// What bounds it on an H100: pure data movement, each byte read once and
// written once, so 2 * p * B * itemsize / 3.35 TB/s (40.1 us for the
// 64 MiB [moe_ep] buffer, 50.1 us for the 80 MiB MoE prefill buffer, 0.31
// us for the 512 KiB decode buffer, where launch latency dominates).
//
// Design:
//   * a grid-stride walk over the (run, chunk) space by a grid of at
//     most 8 blocks per SM (the caller's choice); chunks are a power of
//     two of 4-32 KiB, chosen by the caller so small buffers still spread
//     over the SMs;
//   * each thread keeps kUnroll = 8 independent loads of the widest
//     access in flight before its stores (16 B: 128 B a thread);
//   * the widest access (16, 8, 4, 2 or 1 bytes) divides both bases and
//     run_bytes, so every run is aligned alike and misaligned views work;
//   * index math is 32-bit inside a chunk; the chunk's base is 64-bit.
// On an H100 80GB HBM3 (700 W) tools/reorder_tune.py measured this loop at
// 82-83% of the byte bound at the 64 and 80 MiB buffers with 8 blocks per
// SM (78-80% with 2), level with Tensor.copy_ of the same bytes (the
// card's own device-to-device copy, 83-85%); 16 loads in flight or 512
// threads gained under 1%.  So no bulk-copy (cp.async.bulk) ring ships:
// there is nothing left between this loop and the card's copy rate.
//
// C interface: repro_block_reorder(src, dst, plan, stream) launches on the
// given stream (switching to the plan's device and back if another is
// current) and returns cudaGetLastError(); the caller allocates the output.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <typename V>
__device__ __forceinline__ V load(const V* p) {
  return __ldg(p);
}

template <typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  *p = v;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_map_kernel(const V* __restrict__ src, V* __restrict__ dst,
                   const int* __restrict__ run_src, long long run_vecs,
                   int chunk_vecs, int chunks_per_run, int n_chunks) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int run = c / chunks_per_run;
    const long long off =
        static_cast<long long>(c - run * chunks_per_run) * chunk_vecs;
    const int n = static_cast<int>(
        run_vecs - off < chunk_vecs ? run_vecs - off : chunk_vecs);
    const V* s = src + __ldg(run_src + run) * run_vecs + off;
    V* d = dst + run * run_vecs + off;
    for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n) v[u] = load(s + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n) store(d + i, v[u]);
      }
    }
  }
}

}  // namespace

// The launch plan of one pass on one buffer shape, packed once by the
// caller (kernels/block_reorder.py keeps it alive and passes its address).
struct RowMapPlan {
  const int* run_src;    // device: source run of each destination run
  long long run_bytes;   // g * B * itemsize
  int n_runs;
  int chunk_bytes;       // a multiple of 16
  int blocks;            // the persistent grid's most blocks
  int device;            // the buffers' device
};

namespace {

template <typename V>
cudaError_t launch(const void* src, void* dst, const RowMapPlan& a,
                   cudaStream_t stream) {
  const long long run_vecs =
      a.run_bytes / static_cast<long long>(sizeof(V));
  const int chunk_vecs = a.chunk_bytes / static_cast<int>(sizeof(V));
  const long long per_run = (run_vecs + chunk_vecs - 1) / chunk_vecs;
  const long long n_chunks = per_run * a.n_runs;
  if (n_chunks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int grid =
      static_cast<int>(n_chunks < a.blocks ? n_chunks : a.blocks);
  row_map_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), a.run_src, run_vecs,
      chunk_vecs, static_cast<int>(per_run), static_cast<int>(n_chunks));
  return cudaGetLastError();
}

cudaError_t dispatch(const void* src, void* dst, const RowMapPlan& a,
                     cudaStream_t st) {
  const auto align = reinterpret_cast<std::uintptr_t>(src) |
                     reinterpret_cast<std::uintptr_t>(dst) |
                     static_cast<std::uintptr_t>(a.run_bytes);
  if (align % 16 == 0) return launch<uint4>(src, dst, a, st);
  if (align % 8 == 0) return launch<uint2>(src, dst, a, st);
  if (align % 4 == 0) return launch<unsigned int>(src, dst, a, st);
  if (align % 2 == 0) return launch<unsigned short>(src, dst, a, st);
  return launch<unsigned char>(src, dst, a, st);
}

}  // namespace

extern "C" int repro_block_reorder(const void* src, void* dst,
                                   const RowMapPlan* a, void* stream) {
  if (a == nullptr || a->n_runs < 1 || a->run_bytes < 1 || a->blocks < 1 ||
      a->chunk_bytes < 16 || a->chunk_bytes % 16)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current == a->device)
    return dispatch(src, dst, *a, static_cast<cudaStream_t>(stream));
  err = cudaSetDevice(a->device);       // the stream is the buffers' device's
  if (err != cudaSuccess) return err;
  err = dispatch(src, dst, *a, static_cast<cudaStream_t>(stream));
  const cudaError_t back = cudaSetDevice(current);
  return err != cudaSuccess ? err : back;
}
