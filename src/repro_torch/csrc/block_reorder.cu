// Round-k derived-datatype pack / unpack for Hopper: the block reorder
// before and after every dimension-wise exchange of the factorized
// all-to-all.
//
// Replaces the TPU kernel src/repro/kernels/block_reorder.py::datatype_pack
// and ::datatype_unpack (Pallas `_pack_kernel`, whose BlockSpec index maps
// are the derived datatype).  In the port, torch.distributed's
// all_to_all_single takes one contiguous buffer split along dim 0, so each
// round packs with this kernel, exchanges, and unpacks with it.
//
// What it computes.  The buffer is (p, B) of any dtype; round k moves
// tiles of sigma_k = prod(dims[:k]) rows (tile_bytes = sigma_k * B *
// itemsize bytes, contiguous in source and destination).  Packed tile
// t = j * n_upper + u (peer j, message tile u) pairs with buffer tile
// j + f(u), where f(u) re-linearises u's mixed-radix digits over the upper
// dimensions (sizes given slowest first, the last digit fastest) with their
// tile strides.  pack:   dst[t] = src[j + f(u)];
//                unpack: dst[j + f(u)] = src[t].
// The upper digits' order is an argument, so the paper's datatype order
// and the natural (movedim) order are the same kernel.
//
// What bounds it on an H100: pure data movement, each byte read once and
// written once, so 2 * p * B * itemsize / 3.35 TB/s (50.1 us for the
// 80 MiB MoE prefill buffer of phi3.5-moe on a (2,2) torus).
//
// Design (simple and right first):
//   * bytes, not typed elements: the host picks the widest access (16, 8,
//     4, 2 or 1 bytes) that divides tile_bytes and both base addresses, so
//     every tile of the buffer is aligned alike;
//   * one block per (tile, chunk of kThreads * kUnroll vectors), so a
//     1 KiB tile and a 20 MiB tile both spread over the SMs; each thread
//     issues its kUnroll loads before its stores;
//   * the tile map is closed-form from blockIdx (no index arrays), as the
//     Pallas index maps are.
//
// C interface: repro_block_reorder(...) launches on the given stream and
// returns cudaGetLastError(); the caller allocates the output.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxUpper = 8;      // upper digits: d - 1 - k < 8
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Geometry {                 // passed by value as a kernel argument
  int n_up;
  long long size[kMaxUpper];      // upper digit sizes, slowest first
  long long stride[kMaxUpper];    // their strides, in tiles
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
    reorder_kernel(const V* __restrict__ src, V* __restrict__ dst,
                   long long tile_vecs, long long chunks_per_tile,
                   long long n_upper, Geometry g, int unpack) {
  const long long block = blockIdx.x;
  const long long packed = block / chunks_per_tile;
  const long long chunk = block - packed * chunks_per_tile;
  const long long j = packed / n_upper;
  long long u = packed - j * n_upper;
  long long strided = j;
#pragma unroll
  for (int i = kMaxUpper - 1; i >= 0; --i) {  // constant indices: no local
    if (i < g.n_up) {                          // copy of the argument
      strided += (u % g.size[i]) * g.stride[i];
      u /= g.size[i];
    }
  }
  const V* s = src + (unpack ? packed : strided) * tile_vecs;
  V* d = dst + (unpack ? strided : packed) * tile_vecs;
  const long long base = chunk * (kThreads * kUnroll) + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long long i = base + r * kThreads;
    if (i < tile_vecs) v[r] = s[i];
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long long i = base + r * kThreads;
    if (i < tile_vecs) d[i] = v[r];
  }
}

template <typename V>
cudaError_t launch(const void* src, void* dst, long long tile_bytes,
                   long long n_tiles, long long n_upper, const Geometry& g,
                   int unpack, cudaStream_t stream) {
  const long long tile_vecs = tile_bytes / static_cast<long long>(sizeof(V));
  const long long per_block = kThreads * kUnroll;
  const long long chunks = (tile_vecs + per_block - 1) / per_block;
  const long long blocks = n_tiles * chunks;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  reorder_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), tile_vecs, chunks,
      n_upper, g, unpack);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_block_reorder(const void* src, void* dst,
                                   long long tile_bytes, int n_peers,
                                   long long n_upper, int n_up,
                                   const long long* up_size,
                                   const long long* up_stride, int unpack,
                                   void* stream) {
  if (n_up < 0 || n_up > kMaxUpper || n_peers < 1 || n_upper < 1 ||
      tile_bytes < 1)
    return cudaErrorInvalidValue;
  Geometry g;
  g.n_up = n_up;
  for (int i = 0; i < kMaxUpper; ++i) {
    g.size[i] = i < n_up ? up_size[i] : 1;
    g.stride[i] = i < n_up ? up_stride[i] : 0;
  }
  const long long n_tiles = static_cast<long long>(n_peers) * n_upper;
  const auto s = reinterpret_cast<std::uintptr_t>(src);
  const auto d = reinterpret_cast<std::uintptr_t>(dst);
  const auto align = s | d | static_cast<std::uintptr_t>(tile_bytes);
  auto st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(src, dst, tile_bytes, n_tiles, n_upper, g, unpack,
                         st);
  if (align % 8 == 0)
    return launch<uint2>(src, dst, tile_bytes, n_tiles, n_upper, g, unpack,
                         st);
  if (align % 4 == 0)
    return launch<unsigned int>(src, dst, tile_bytes, n_tiles, n_upper, g,
                                unpack, st);
  if (align % 2 == 0)
    return launch<unsigned short>(src, dst, tile_bytes, n_tiles, n_upper, g,
                                  unpack, st);
  return launch<unsigned char>(src, dst, tile_bytes, n_tiles, n_upper, g,
                               unpack, st);
}
