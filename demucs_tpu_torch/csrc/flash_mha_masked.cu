// K3 under a static keep-mask, both routes: the masked kernels of
// flash_mha.cuh (flash_mha_kernel<D, NWG, true>, flash_mha_bf16_masked_kernel
// and its merge), which read the mask as its tile map and packed bits. A
// source of its own, built beside flash_mha.cu and linked into its library
// (kernels/_build.py PARTS); flash_mha.cu's C entries call these launches
// when given a tile map. Replaces demucs_tpu/ops/pallas/attention.py:
// flash_mha under its keep-mask (:59-63).

#include "flash_mha.cuh"

int flash_mha_f32_masked(const float* q, const float* k, const float* v, const int* tile_map,
                         const unsigned int* bits, float* image, float* o, float* lse, int B,
                         int Tq, int Tk, int H, int D, float q_scale, int block_rows,
                         Dropout drop, cudaStream_t s) {
  return run_f32<true>(q, k, v, tile_map, bits, image, o, lse, B, Tq, Tk, H, D, q_scale,
                       block_rows, drop, s);
}

int flash_mha_bf16_masked(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* tile_map, const unsigned int* bits,
                          __nv_bfloat16* o, float* part, float* lse, int B, int Tq, int Tk,
                          int H, int D, float scale, int key_tile, int block_rows, int ctas,
                          Dropout drop, cudaStream_t s) {
  return run_bf16<true>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H, D, scale, key_tile,
                        block_rows, ctas, drop, s);
}
