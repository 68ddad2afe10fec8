// K3 at head dim 128, both routes, unmasked and under a static keep-mask:
// the D = 128 instances of flash_mha.cuh's kernels, in a source of their
// own, built beside flash_mha.cu and flash_mha_masked.cu and linked into
// their library (kernels/_build.py PARTS); the C entries' switches call
// these launches at D = 128 (a head of d < 128 channels above 64 comes here
// padded with zero channels, kernels/attention.py). Replaces
// demucs_tpu/ops/pallas/attention.py: flash_mha at any head dim (:117).
//
// - fp32 (flash_mha_kernel<128, 1, MASKED>): 64 query rows a block, 32 keys
//   a tile (a tile's image is 4 x 32 x 128 floats, 64 KiB a stage), Q's
//   split in shared memory (64 KiB) and read by descriptor (score_tile_ss):
//   in registers it would take 128 a thread beside o's 64 and the tile's
//   P V's 64. 194 KiB a block.
// - bf16 (flash_mha_bf16_kernel<128, 64, 2, false>, its masked twin and
//   their merges): 64 keys a tile and 128 rows a block, the only plan whose
//   4-stage ring fits (193 KiB; 128 keys would need 321 KiB); the dropout
//   instances (DROP) add each stage's column terms, 256 bytes: 194 KiB, 204
//   KiB masked. The fp32 instances take the dropout at run time.
// The backward at D = 128 is flash_mha_bwd_d128.cu's (and its masked twin's).

#include "flash_mha.cuh"

int flash_mha_f32_d128(bool masked, const float* q, const float* k, const float* v,
                       const int* tile_map, const unsigned int* bits, float* image, float* o,
                       float* lse, int B, int Tq, int Tk, int H, float q_scale, int block_rows,
                       Dropout drop, cudaStream_t s) {
  return masked ? (int)launch_rows<128, true>(block_rows, q, k, v, tile_map, bits, image, o, lse,
                                              B, Tq, Tk, H, q_scale, drop, s)
                : (int)launch_rows<128, false>(block_rows, q, k, v, tile_map, bits, image, o, lse,
                                               B, Tq, Tk, H, q_scale, drop, s);
}

int flash_mha_bf16_d128(bool masked, const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const int* tile_map, const unsigned int* bits,
                        __nv_bfloat16* o, float* part, float* lse, int B, int Tq, int Tk, int H,
                        float scale, int key_tile, int block_rows, int ctas, Dropout drop,
                        cudaStream_t s) {
  return masked ? dispatch_bf16<128, true>(key_tile, block_rows, q, k, v, tile_map, bits, o, part,
                                           lse, B, Tq, Tk, H, scale, ctas, drop, s)
                : dispatch_bf16<128, false>(key_tile, block_rows, q, k, v, tile_map, bits, o,
                                            part, lse, B, Tq, Tk, H, scale, ctas, drop, s);
}

int flash_mha_bf16_tiles_d128(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const float* p, float* s_out, float* o_out,
                              int key_tile, cudaStream_t s) {
  return dispatch_tiles<128>(key_tile, q, k, v, p, s_out, o_out, s);
}
