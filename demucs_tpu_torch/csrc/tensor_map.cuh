// Tensor maps (the descriptors of tensor-memory-accelerator copies) of
// K3's operands, shared by flash_mha.cu and flash_mha_bwd.cu: a row-major
// (B, T, C) tensor, of which a block copies rows [t0, t0 + rows) of one
// head's ROW_BYTES-byte slice, as the 3-D tensor (C, T, B) so that rows past
// T (or the item's end) land as zeros instead of the next item's rows.
//
// A slice is stored in shared memory as rows of W bytes (W = 128, 64 or 32,
// the largest that divides the slice), BOXES boxes of W bytes side by side,
// each box all `rows` rows, swizzled at W: the pattern of wgmma's W-byte
// swizzle (hopper.cuh swizzled_desc), in which the 16-byte chunk k of row r
// sits at chunk k ^ ((r / (128 / W)) % (W / 16)) of its 128-byte line.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached at run time)
#include <cuda_runtime.h>

#include <cstdint>

namespace tensor_map {

// The shared-memory image of a slice of ROW_BYTES bytes a row.
template <int ROW_BYTES>
struct RowImage {
  static constexpr int W = ROW_BYTES % 128 == 0 ? 128 : ROW_BYTES % 64 == 0 ? 64 : 32;
  static constexpr int BOXES = ROW_BYTES / W;
  static constexpr uint64_t LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;  // wgmma's layout type
  static_assert(ROW_BYTES % 32 == 0, "a head slice is a whole number of 32-byte chunks");

  // Byte offset of byte `byte` of row r in an image of `rows` rows (the
  // image 8 W-byte aligned, as the swizzle atoms are).
  static __device__ __forceinline__ uint32_t offset(int rows, int r, int byte) {
    const uint32_t linear = (uint32_t)((byte / W) * rows * W + r * W + byte % W);
    return linear ^ (((linear >> 7) & (W / 16 - 1)) << 4);
  }
};

// A head slice of D bf16 values.
template <int D>
using HeadImage = RowImage<2 * D>;

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A failed encode returns ENCODE_FAILED + its CUresult (kernels/attention.py
// raises on it); no copy falls back to another path.
constexpr int ENCODE_FAILED = 10000;

// The tensor map of x (B, T, C), elements of ELEM bytes (2: bf16, 4: fp32),
// for copies of `rows` rows of a head slice of D elements (RowImage<D *
// ELEM>): boxes of W bytes x `rows` rows x 1 item, swizzled at W,
// zero-filled outside the tensor.
template <int D, int ELEM>
int head_map(CUtensorMap* map, const void* x, int B, int T, int C, int rows) {
  using I = RowImage<D * ELEM>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * ELEM, (cuuint64_t)T * C * ELEM};  // dims 1, 2
  const cuuint32_t box[3] = {I::W / ELEM, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = I::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : I::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      ELEM == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = encode(map, type, 3, const_cast<void*>(x), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

}  // namespace tensor_map
