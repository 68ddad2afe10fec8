// K3's backward, the unmasked instances: the gradients of flash_mha.cu's
// two routes (fp32 and bf16) without a keep-mask, by default and under the
// deterministic order. Replaces the gradient of
// demucs_tpu/ops/pallas/attention.py:103 (flash_mha): the Pallas kernel has
// no backward, and JAX trains through XLA's dense attention. The design,
// the bound and the code are in flash_mha_bwd.cuh; the masked launches'
// instances are flash_mha_bwd_masked.cu's.

#include "flash_mha_bwd.cuh"

extern "C" {

// q, o, dout (B, Tq, H*D); k, v (B, Tk, H*D), fp32 with 16-byte aligned
// bases; lse (B*H, Tq) from flash_mha_f32; mask: null (a masked launch takes
// flash_mha_bwd_masked_f32; a mask here is refused);
// stats: scratch of B*H*ceil(Tq / 64)*128 floats; dq_acc: scratch of
// B*H*ceil(Tq / 64)*64*D floats (dQ's sums); turns: null (dQ summed in the
// order the blocks come) or scratch of B*H*ceil(Tq / 32) + 1 uint32 (dQ
// summed in a fixed order, deterministic: a turn counter per tile, then the
// item counter of the cooperative grid) -> dq (B, Tq, H*D), dk, dv (B, Tk,
// H*D). D: 32, 48, 64 or 128 (flash_mha_bwd_d128.cu; dq_acc and turns
// unread there, the fp32 route's dQ is summed in one block). keys: keys per
// block, 64. scale = log2(e) / sqrt(D), the forward's; sm_scale = 1 /
// sqrt(D). rate and seed: the forward's dropout. Returns a cudaError_t, or
// ENCODE_FAILED + the CUresult of a failed tensor-map encode.
int flash_mha_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                      const float* dout, const float* lse, const unsigned char* mask,
                      float* stats, float* dq_acc, unsigned* turns, float* dq, float* dk,
                      float* dv, int B, int Tq, int Tk, int H, int D, int keys, float scale,
                      float sm_scale, float rate, int seed, void* stream) {
  return dispatch_bwd<float, false>(q, k, v, o, dout, lse, MaskArgs{mask, nullptr, nullptr},
                                    stats, dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, D, keys,
                                    scale, sm_scale, rate, seed, stream);
}

// The same for the bf16 route: q, k, v, o, dout, dq, dk, dv bf16 with 16-byte
// aligned bases, lse (B*H, Tq) from flash_mha_bf16; mask, stats, dq_acc and
// turns as for flash_mha_bwd_f32; keys per block 64 or 128.
int flash_mha_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, const unsigned char* mask,
                       float* stats, float* dq_acc, unsigned* turns, void* dq, void* dk, void* dv,
                       int B, int Tq, int Tk, int H, int D, int keys, float scale, float sm_scale,
                       float rate, int seed, void* stream) {
  return dispatch_bwd<bf16, false>(q, k, v, o, dout, lse, MaskArgs{mask, nullptr, nullptr},
                                   stats, dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, D, keys, scale,
                                   sm_scale, rate, seed, stream);
}

// The grid that a deterministic launch (turns not null) of flash_mha_bwd_f32
// (bf16_route 0) or flash_mha_bwd_bf16 (1) with these sizes takes on the
// current device -> plan: a head's query tiles and key blocks, the blocks an
// SM holds, the SMs, the blocks launched, the order (1 staggered, 0 key-block
// order) and the depth of the dQ ring. Returns a cudaError_t.
int flash_mha_bwd_ordered_plan(int bf16_route, int B, int Tq, int Tk, int H, int D, int keys,
                               int* plan) {
  return ordered_plan_entry<false>(bf16_route, B, Tq, Tk, H, D, keys, plan);
}

}  // extern "C"
