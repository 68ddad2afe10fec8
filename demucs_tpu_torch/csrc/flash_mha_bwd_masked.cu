// K3's backward under a static keep-mask, the MASKED instances of
// flash_mha_bwd.cuh (both routes, by default and under the deterministic
// order): each key block walks the query tiles its tile map lists, a full
// unit takes no keep test, a partial one tests the bits its stage brought
// in. Replaces the gradient of demucs_tpu/ops/pallas/attention.py:103
// (flash_mha) under its keep-mask (:59-63; JAX trains through XLA's dense
// attention under the same mask). A source of its own, so that nvcc builds
// it beside the unmasked instances' (flash_mha_bwd.cu).

#include "flash_mha_bwd.cuh"

extern "C" {

// As flash_mha_bwd_f32, under the keep-mask given as the backward's tile
// map for 64 keys a block and 32 queries a tile, and its bits for 32-query
// tiles (kernels/attention.py MaskTiles.bwd_launch; see mask_rows). At
// head dim 128 also the forward's tile map for 64 rows and 32 keys and its
// bits (MaskTiles.launch(64, 32)), which that dQ kernel walks
// (flash_mha_bwd_d128.cuh), and turns are not read; below 128 both null.
int flash_mha_bwd_masked_f32(const float* q, const float* k, const float* v, const float* o,
                             const float* dout, const float* lse, const int* tile_map,
                             const unsigned char* bits, const int* fwd_map,
                             const unsigned* fwd_bits, float* stats, float* dq_acc,
                             unsigned* turns, float* dq, float* dk, float* dv, int B, int Tq,
                             int Tk, int H, int D, int keys, float scale, float sm_scale,
                             float rate, int seed, void* stream) {
  return dispatch_bwd<float, true>(q, k, v, o, dout, lse,
                                   MaskArgs{nullptr, tile_map, bits, fwd_map, fwd_bits}, stats,
                                   dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, D, keys, scale,
                                   sm_scale, rate, seed, stream);
}

// As flash_mha_bwd_bf16, under the keep-mask: the tile map for `keys` (64 or
// 128) keys a block and 64 queries a tile, the bits for 64-query tiles.
int flash_mha_bwd_masked_bf16(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, const int* tile_map,
                              const unsigned char* bits, float* stats, float* dq_acc,
                              unsigned* turns, void* dq, void* dk, void* dv, int B, int Tq,
                              int Tk, int H, int D, int keys, float scale, float sm_scale,
                              float rate, int seed, void* stream) {
  return dispatch_bwd<bf16, true>(q, k, v, o, dout, lse, MaskArgs{nullptr, tile_map, bits},
                                  stats, dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, D, keys, scale,
                                  sm_scale, rate, seed, stream);
}

// As flash_mha_bwd_ordered_plan, for the MASKED instances.
int flash_mha_bwd_masked_ordered_plan(int bf16_route, int B, int Tq, int Tk, int H, int D,
                                      int keys, int* plan) {
  return ordered_plan_entry<true>(bf16_route, B, Tq, Tk, H, D, keys, plan);
}

}  // extern "C"
