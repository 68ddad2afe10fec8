// K3: multi-head attention over projected q/k/v, the unmasked kernels and
// the C entries of both routes (fp32 in the three-term TF32 split, bf16):
// the design, the bound and the code are in flash_mha.cuh; a launch given a
// keep-mask's tile map runs flash_mha_masked.cu's kernels, and a launch at
// head dim 128 flash_mha_d128.cu's, both linked into the same library.
//
// Replaces demucs_tpu/ops/pallas/attention.py: flash_mha (kernel _attn_kernel).

#include "flash_mha.cuh"

extern "C" {

// q (B, Tq, H*D), k/v (B, Tk, H*D) -> o (B, Tq, H*D). tile_map and bits:
// null, or a keep-mask's tile map for block_rows rows and BK keys and its
// packed words (see mask_rows); BK = 64, and 32 at D = 128 (f32_keys).
// image: scratch of B * H * ceil(Tk / BK) * 4 * BK * D floats. D: 32, 48, 64
// or 128; q_scale = log2(e) / sqrt(d), d the heads' own dim (a head padded
// with zero channels to D keeps its scale); block_rows 64 or 128 query rows
// per block (64 at D = 128). lse: null, or (B * H, Tq) floats for each row's
// base-2 log-sum-exp. Dropout of the probabilities at `rate` (0: none) under
// `seed` (attention_dropout.cuh).
int flash_mha_f32(const float* q, const float* k, const float* v, const int* tile_map,
                  const unsigned int* bits, float* image, float* o, float* lse, int B, int Tq,
                  int Tk, int H, int D, float q_scale, int block_rows, float rate, int seed,
                  void* stream) {
  if (Tk <= 0 || (block_rows != 64 && block_rows != 128)) return (int)cudaErrorInvalidValue;
  if ((tile_map == nullptr) != (bits == nullptr)) return (int)cudaErrorInvalidValue;
  if (!(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  if (tile_map != nullptr) {
    return flash_mha_f32_masked(q, k, v, tile_map, bits, image, o, lse, B, Tq, Tk, H, D, q_scale,
                                block_rows, drop, s);
  }
  return run_f32<false>(q, k, v, tile_map, bits, image, o, lse, B, Tq, Tk, H, D, q_scale,
                        block_rows, drop, s);
}

// The bf16 route: q (B, Tq, H*D), k/v (B, Tk, H*D), o (B, Tq, H*D), all bf16
// with 16-byte aligned bases; tile_map (for block_rows rows and key_tile
// keys) and bits as for flash_mha_f32. scale = log2(e) / sqrt(d) as
// flash_mha_f32's q_scale, applied to the fp32 scores. key_tile 64 or 128
// keys, block_rows 128 or 192 query rows (D = 128: 64 keys, 128 rows);
// ctas blocks in the grid, each a range of the persistent schedule over
// the units (Schedule; ctas = the row blocks: a block each; part: fp32
// scratch of 2 ctas block_rows (D + 2) floats, which may be null when no
// range starts inside a row block, and under a mask is given exactly when
// one does). lse and the dropout's rate and seed as for flash_mha_f32.
// row0: the first global query row of the launch, 0 but on a piece of a
// longer masked call's rows (kernels/attention.py MaskTiles.pieces: q, o,
// lse, tile_map and bits are the piece's); the dropout hashes the global
// rows, so the pieces drop what one launch over all rows would.
// Returns a cudaError_t, or ENCODE_FAILED + the CUresult of a failed
// tensor-map encode.
int flash_mha_bf16(const void* q, const void* k, const void* v, const int* tile_map,
                   const unsigned int* bits, void* o, float* part, float* lse, int B, int Tq,
                   int Tk, int H, int D, float scale, int key_tile, int block_rows, int ctas,
                   float rate, int seed, int row0, void* stream) {
  if (Tk <= 0 || !(rate >= 0.f && rate < 1.f) || row0 < 0) return (int)cudaErrorInvalidValue;
  if ((tile_map == nullptr) != (bits == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed, row0);
  if (tile_map != nullptr) {
    return flash_mha_bf16_masked(qb, kb, vb, tile_map, bits, ob, part, lse, B, Tq, Tk, H, D,
                                 scale, key_tile, block_rows, ctas, drop, s);
  }
  if (row0 != 0) return (int)cudaErrorInvalidValue;  // only a masked call comes in pieces
  return run_bf16<false>(qb, kb, vb, tile_map, bits, ob, part, lse, B, Tq, Tk, H, D, scale,
                         key_tile, block_rows, ctas, drop, s);
}

// One S tile and one P V tile of the bf16 route alone (flash_mha_bf16_tiles_kernel):
// q (64, D), k and v (key_tile, D) bf16, p (64, key_tile) fp32.
int flash_mha_bf16_tiles(const void* q, const void* k, const void* v, const float* p,
                         float* s_out, float* o_out, int D, int key_tile, void* stream) {
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return dispatch_tiles<32>(key_tile, qb, kb, vb, p, s_out, o_out, s);
    case 48:
      return dispatch_tiles<48>(key_tile, qb, kb, vb, p, s_out, o_out, s);
    case 64:
      return dispatch_tiles<64>(key_tile, qb, kb, vb, p, s_out, o_out, s);
    case 128:
      return flash_mha_bf16_tiles_d128(qb, kb, vb, p, s_out, o_out, key_tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
