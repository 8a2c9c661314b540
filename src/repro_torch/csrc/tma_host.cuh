// Host side of the port's TMA loads: 3-D tensor maps of bf16 encoded with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint(ByVersion)
// so no -lcuda link is needed.  Shared by csrc/grouped_matmul.cu and
// csrc/flash_attention.cu.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled is a driver call and needs a current context; a
// thread that has made no runtime call that binds one (autograd's backward
// thread) has none, so make the device's primary context current first
// (cudaSetDevice does since CUDA 12).  Call before encode().
inline cudaError_t bind_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return err;
}

// A 3-D map of `depth` matrices of `rows` rows of `inner` contiguous bf16,
// read in boxes of box_rows x 64 with the 128-byte swizzle; a box that
// reaches past the tensor is zero-filled.
inline bool encode(CUtensorMap* map, const void* base, int inner, int rows,
                   int depth, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
