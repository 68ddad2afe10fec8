// K3's backward at head dim 128, the unmasked instances: the bf16 route's
// Bf16Bwd<128, 1, ORDERED> (by default and under the deterministic order)
// and the fp32 route's two kernels (dK and dV by key block, dQ by row
// block), in a source of their own, built beside flash_mha_bwd.cu and
// linked into its library (kernels/_build.py PARTS); dispatch_bwd calls
// these at D = 128. Replaces the gradient of
// demucs_tpu/ops/pallas/attention.py:103 (flash_mha) at any head dim (:117).
// The design, its shared-memory and register arithmetic: flash_mha_bwd_d128.cuh.

#include "flash_mha_bwd_d128.cuh"

int flash_mha_bwd_d128(int bf16_route, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, const int* tile_map,
    const unsigned char* bits, const int* fwd_map, const unsigned* fwd_bits, float* stats,
    float* dq_acc, unsigned* turns, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
    int H, int keys, float scale, float sm_scale, Dropout drop, cudaStream_t s) {
  return bwd_d128<false>(bf16_route, q, k, v, o, dout, lse, tile_map, bits, fwd_map,
                         fwd_bits, stats, dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, keys, scale,
                         sm_scale, drop, s);
}

int flash_mha_bwd_d128_plan(int bf16_route, int keys, int B, int Tq, int Tk, int H, int* plan) {
  return bwd_d128_plan<false>(bf16_route, keys, B, Tq, Tk, H, plan);
}
