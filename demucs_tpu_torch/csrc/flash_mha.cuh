// K3: multi-head attention over projected q/k/v with an online softmax, both
// products on the tensor cores (sm_90a wgmma). Two routes: fp32 in and out
// in the three-term TF32 split (below), and bf16 in and out with one bf16
// product each (flash_mha_bf16_kernel, further down).
//
// Replaces demucs_tpu/ops/pallas/attention.py: flash_mha (kernel _attn_kernel).
//
//   o[b, i, h*D:(h+1)*D] = softmax_j(q_i . k_j / sqrt(D), masked) @ v[b, :, h*D:(h+1)*D]
//
// q (B, Tq, H*D), k and v (B, Tk, H*D), o (B, Tq, H*D), all row-major fp32;
// heads are read in place at column h*D. An optional keep-mask (Tq, Tk) is
// shared by batch and heads: masked scores are -inf, and the rescale is
// -inf-safe as in the Pallas kernel, so a row with no kept key gives 0 / 0 =
// NaN, as the plain softmax over all -inf does. Both routes read the mask as
// its tile map and packed bits (below, at mask_rows).
//
// Bound: operations. A head does 4 Tq Tk D flops (two products) on
// (2 Tq + 2 Tk) D floats: at the released shapes (Tq, Tk of 1344..2688,
// D = 64) several hundred flops per byte of HBM, far above the card's line.
// fp32 on the CUDA cores peaks at 67 TFLOP/s, TF32 on the tensor cores at
// 495; but one TF32 product keeps 11 bits of each operand, which puts the
// output 20-30 times over the fp32 tolerance. So each product is taken as
// three TF32 products (3xTF32):
//     x = hi + lo,  hi = tf32_hi(x),  lo = x - hi (exact in fp32),
//     a . b ~ a_hi . b_lo + a_lo . b_hi + a_hi . b_hi   (a_lo . b_lo left out),
// which keeps the error at fp32 level for 3 x the tensor-core operations:
// the bound is 3 x 4 Tq Tk D flops per head over 495 TFLOP/s.
//
// Design:
// - kv_image_kernel, launched first, lays out each tile of 64 keys of one
//   (batch, head) as the shared-memory image that the products read: K hi,
//   K lo, V^T hi, V^T lo, each in wgmma's core-matrix layout (no swizzle),
//   zero past Tk. wgmma reads 32-bit operands from shared memory only
//   K-major, with no transpose, and in O = P V the reduction runs over keys,
//   so V has to sit as V^T (D rows of keys); no copy engine transposes. This
//   pass transposes V, and splits K and V once per launch rather than once
//   per query block, for one more pass over k and v: it reads them once and
//   writes 4 B Tk H D floats, which every query block of a head then reads
//   from L2.
// - flash_mha_kernel: one block = NWG consumer warpgroups of 64 query rows
//   each, of one (batch, head), and one producer warpgroup, one thread of
//   which streams the tiles' images into a ring of STAGES = 2 buffers with
//   cp.async.bulk and mbarriers (full: the bytes arrived; empty: every
//   consumer warp is done with the buffer). With two consumer warpgroups the
//   producer gives up its registers (setmaxnreg), so that a consumer thread
//   may hold 240: Q's split, two accumulators and P's split.
// - A consumer warpgroup holds its Q rows in registers, scaled by
//   log2(e)/sqrt(D) and split once. Per tile:
//     S (64 x 64) = Q K^T: 3 x D/8 wgmma m64n64k8, A = Q from registers;
//     softmax in fp32 registers, base 2: row max over the 4 lanes that hold
//     a row, p = exp2(s - m), the -inf-safe rescale of O; row sums stay
//     partial per lane until the end;
//     O_t (64 x D) = P V: 3 x 8 wgmma m64nDk8, A = P from registers, into
//     an accumulator of the tile's own; then o = o * alpha + O_t in fp32.
//     (The tensor core's accumulation truncates; carried over the 42 tiles
//     of a 2688-key row, that bias alone came to half the tolerance.)
//   P goes from the S accumulator to the A fragment with no trip through
//   shared memory: lane (g, c) holds keys 2c and 2c+1 of each group of 8,
//   where the A fragment wants k-positions c and c+4. The sum over keys does
//   not depend on their order, so the image stores V's keys of each group
//   of 8 in the order 0 2 4 6 1 3 5 7: k-position c is key 2c, k-position
//   c+4 is key 2c+1.
// - With two consumer warpgroups, one computes its softmax while the
//   other's products run. Templated on D in {32, 48, 64} and NWG in {1, 2}
//   (64 or 128 query rows per block), and D = 128 with NWG = 1.
// - D = 128 (flash_mha_d128.cu; a head of 64 < d < 128 channels comes here
//   padded with zeros, kernels/attention.py). What bounds it is room, not
//   work: Q's split in registers would take 128 a thread beside o's 64 and
//   the tile's P V's 64, and a 64-key tile's image 128 KiB a stage. So the
//   one consumer warpgroup writes Q's split to shared memory in the K
//   part's layout (64 KiB) and issues S with both operands by descriptor
//   (score_tile_ss, m64n32k8), the tiles hold 32 keys (f32_keys: 64 KiB a
//   stage, two stages), and P V is m64n128k8 from registers: 194 KiB a
//   block, 182-189 registers, no spill. One warpgroup a block: no softmax
//   runs under another's products (29-44 % of the bound on the H100 against
//   the d = 64 instance's 47-71 %, PERF.md).
// - Under a keep-mask (the reference's sparse attention; the Pallas kernel
//   takes the keep test at every score). What bounded the first masked
//   kernel on this card: it visited every tile, masked or not, and after
//   each tile's S it loaded a byte per score from global memory (LDG.U8,
//   32 scattered bytes a thread a tile) on the chain the softmax waits for:
//   2.2-2.3x the unmasked time, whatever the mask kept (PERF.md). Now the
//   mask comes as a tile map built once per mask on the host (each (row
//   block, key tile) unit empty, full or partial) and as bits packed in the
//   lanes' order. A row block's loop walks its listed units only: the
//   producer streams their images alone, a full tile takes no test, and a
//   partial one brings its row block's words into its stage with the same
//   barrier (one bulk copy), so the keep test is a bit test and a select a
//   score from two shared-memory words, off the load chain. A row block
//   with no unit gives NaN rows (lse -inf), as the plain softmax does. The
//   masked code is an instance of its own (MASKED): an unmasked launch
//   runs the first design's loop. Times on one H100 80GB HBM3 at 700.00 W,
//   the reference's masks, 4 shapes, B = 1 / 6 (chip_smoke.py --k3-pair,
//   the first kernel in turns): diag at freq self 0.4226 / 1.6703 ms ->
//   0.0887 / 0.3643; masks with no empty unit 1.02-1.07x the unmasked
//   time (the first kernel: 2.2-2.3x); 0.07-0.32x SDPA with the mask.
// - Train-time dropout on the attention probabilities, the Pallas kernel's
//   own (attention_dropout.cuh): a counter hash of (global query row, key,
//   seed + batch-head salt), so the pattern does not depend on the tiles.
//   The row sum l takes p before the drop, o the dropped p / (1 - rate).
//   Where the caller asks, each row's log-sum-exp (base 2, of the scaled
//   scores: m + log2 l) goes to `lse` for the backward (flash_mha_bwd.cu).

// This header holds the device code and the host launch of both routes;
// flash_mha.cu instantiates the unmasked kernels and exports the C entries,
// flash_mha_masked.cu the masked ones (two sources, built in parallel and
// linked into one library: kernels/_build.py PARTS).

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder: tensor_map.cuh)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_dropout.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

// The head dim 128 launches of both routes, unmasked and masked, defined in
// flash_mha_d128.cu (a source of its own, compiled beside the others and
// linked into the same library): the switches below (run_f32, run_bf16) and
// flash_mha_bf16_tiles call them.
int flash_mha_f32_d128(bool masked, const float* q, const float* k, const float* v,
                       const int* tile_map, const unsigned int* bits, float* image, float* o,
                       float* lse, int B, int Tq, int Tk, int H, float q_scale, int block_rows,
                       Dropout drop, cudaStream_t s);
int flash_mha_bf16_d128(bool masked, const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const int* tile_map, const unsigned int* bits,
                        __nv_bfloat16* o, float* part, float* lse, int B, int Tq, int Tk, int H,
                        float scale, int key_tile, int block_rows, int ctas, Dropout drop,
                        cudaStream_t s);
int flash_mha_bf16_tiles_d128(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const float* p, float* s_out, float* o_out,
                              int key_tile, cudaStream_t s);

namespace {

using namespace hopper;
using tensor_map::ENCODE_FAILED;
using tensor_map::HeadImage;

constexpr int BK = 64;       // keys per tile (the fp32 route: f32_keys)
constexpr int ROWS_WG = 64;  // query rows per consumer warpgroup
constexpr int STAGES = 2;     // K/V tiles in flight per block (3 is no faster on the H100)
constexpr unsigned FULL_MASK = 0xffffffffu;

// Keys per tile of the fp32 route at head dim D: 64, and 32 at D = 128, where
// a tile's image (K and V^T, hi and lo: 4 BK D floats) of 64 keys would take
// 128 KiB a stage.
__host__ __device__ constexpr int f32_keys(int D) { return D == 128 ? 32 : 64; }

// ---- the keep-mask, as both routes read it (kernels/attention.py MaskTiles) ----
// tile_map, for the launch's plan (query rows a block, keys a tile), int32:
//   [nnz, n_empty, off[0 .. n_x], ent[0 .. nnz), empty[0 .. n_empty)]
// ent lists the (row block, key tile) units that keep a score, row block by
// row block (off: each row block's first), in key order, as tile << 1 |
// partial: a full tile keeps every in-range score and lies inside Tk, a
// partial one does not. empty: the row blocks that keep nothing.
// bits (ceil(Tk / 128), mask_rows(Tq), 4) uint32: word c of (128-key group
// w, query row r) holds the keys lane c of a warp holds in the S accumulator,
// 128 w + 8 j + 2 c + b at bit 2 j + b (0 past Tk and past Tq); a 64-key
// tile t is half t & 1 of group t >> 1. One row block's words of one group
// are contiguous, so a partial tile's words come in with one bulk copy.
__host__ __device__ constexpr int mask_rows(int Tq) { return (Tq + 383) / 384 * 384; }

// The tile map's offsets (n_x + 1) are copied to shared memory: every piece
// reads its row block's, and the block's first unit is found by a binary
// search over them, so from global memory their latency would stand before
// each piece (a piece of one unit is most of a piece's time). A masked
// launch takes at most OFF_SMEM - 1 row blocks (kernels/attention.py).
constexpr int OFF_SMEM = 512;

// The 128-key group of the packed words that holds key tile t of BK keys.
template <int BK>
__device__ __forceinline__ int mask_group(int t) {
  return BK == 128 ? t : BK == 64 ? t >> 1 : t >> 2;
}

// Loads the mask words of a thread's rows rr and rr + 8 (in its block) for
// a partial tile t from the stage's copy (ROWS x 4 words): 32 keys a row at
// 128 keys a tile, the tile's 16 at 64, its 8 at 32 (bit 2 j + b: key 8 j +
// 2c + b).
template <int BK>
__device__ __forceinline__ void load_words(uint32_t (&w)[2], const uint32_t* words, int rr, int c,
                                           int t) {
  w[0] = words[rr * 4 + c];
  w[1] = words[(rr + 8) * 4 + c];
  if constexpr (BK == 64) {
    const int shift = 16 * (t & 1);
    w[0] >>= shift;
    w[1] >>= shift;
  } else if constexpr (BK == 32) {
    const int shift = 8 * (t & 3);
    w[0] >>= shift;
    w[1] >>= shift;
  }
}

// A partial tile's keep test: element e of the S accumulator (row `row + 8
// ((e >> 1) & 1)`, key 8 (e >> 2) + 2c + (e & 1)) is -inf unless its bit is
// set; a bit test and a select a score, no load.
template <int BK>
__device__ __forceinline__ void keep_bits(float (&s)[BK / 2], const uint32_t (&w)[2]) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    if (!((w[(e >> 1) & 1] >> (2 * (e >> 2) + (e & 1))) & 1u)) s[e] = -INFINITY;
  }
}

// The unmasked launches' tail test, on both routes: the scores of keys past
// Tk (or masked by bytes: `mask` is always null) are -inf. Lane (g, c) of a
// warp holds rows `row` and `row + 8`, columns 8 j + 2c and 8 j + 2c + 1.
// It is the first design's test, null pointer and all: without the branch
// on `mask` ptxas schedules the unmasked instances otherwise (the bf16
// route's 192-row dropout instance past its registers, 92 bytes spilled and
// 10-12 % slower; the fp32 route's dropout instance 1-2.4 % slower, PERF.md),
// so a masked launch takes instances of its own. chip_smoke.py fails on any
// instance that spills, and --k3-pair compares these instances' SASS and
// times with a parent's.
template <int BK>
__device__ __forceinline__ void mask_tile(float (&s)[BK / 2],
                                          const unsigned char* __restrict__ mask, int k0, int row,
                                          int c, int Tq, int Tk) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
    const int r = row + 8 * ((e >> 1) & 1);
    bool keep = key < Tk;
    if (keep && mask != nullptr && r < Tq) keep = mask[(size_t)r * Tk + key] != 0;
    if (!keep) s[e] = -INFINITY;
  }
}

// Float offset of (key j, channel c) in a tile's K part: core matrices of
// 8 keys x 4 channels, those of one group of 8 keys side by side.
template <int D>
__host__ __device__ constexpr int k_offset(int j, int c) {
  return ((j >> 3) * (D / 4) + (c >> 2)) * 32 + (j & 7) * 4 + (c & 3);
}

// Float offset of (key j, channel c) in a tile's V^T part (BK keys):
// core matrices of 8 channels x 4 k-positions, those of one group of 8
// channels side by side; key j sits at k-position 8 (j / 8) + (j % 8) / 2 +
// 4 (j % 2).
template <int BK>
__host__ __device__ constexpr int v_offset(int j, int c) {
  return ((c >> 3) * (BK / 4) + 2 * (j >> 3) + (j & 1)) * 32 + (c & 7) * 4 + ((j & 7) >> 1);
}

// S = Q K^T of one tile for one warpgroup, 3xTF32, into s (accumulator layout).
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[BK / 2], uint32_t (&qhi)[D / 8][4],
                                           uint32_t (&qlo)[D / 8][4], const float* k_hi,
                                           const float* k_lo) {
  constexpr uint32_t LBO = 128, SBO = 32 * D;  // bytes to the next 4 channels, next 8 keys
  const uint32_t hi = smem_addr(k_hi), lo = smem_addr(k_lo);
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) fence_operand(s[e]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32<BK>::run(s, qhi[ks], smem_desc(lo + 256 * ks, LBO, SBO), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32<BK>::run(s, qlo[ks], smem_desc(hi + 256 * ks, LBO, SBO), 1);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32<BK>::run(s, qhi[ks], smem_desc(hi + 256 * ks, LBO, SBO), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) fence_operand(s[e]);
}

// score_tile with Q from shared memory (head dim 128, where Q's split would
// take 128 registers a thread): q_hi and q_lo are the warpgroup's 64 rows in
// the K part's layout (k_offset, a row as a key), both operands by
// descriptor, 32 keys a tile.
template <int D, int BK>
__device__ __forceinline__ void score_tile_ss(float (&s)[BK / 2], const float* q_hi,
                                              const float* q_lo, const float* k_hi,
                                              const float* k_lo) {
  static_assert(BK == 32, "MmaTf32SS32 takes 32 keys");
  constexpr uint32_t LBO = 128, SBO = 32 * D;  // bytes to the next 4 channels, next 8 rows
  const uint32_t qh = smem_addr(q_hi), ql = smem_addr(q_lo);
  const uint32_t hi = smem_addr(k_hi), lo = smem_addr(k_lo);
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) fence_operand(s[e]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32SS32::run(s, smem_desc(qh + 256 * ks, LBO, SBO), smem_desc(lo + 256 * ks, LBO, SBO),
                     ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32SS32::run(s, smem_desc(ql + 256 * ks, LBO, SBO), smem_desc(hi + 256 * ks, LBO, SBO), 1);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    MmaTf32SS32::run(s, smem_desc(qh + 256 * ks, LBO, SBO), smem_desc(hi + 256 * ks, LBO, SBO), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) fence_operand(s[e]);
}

// o = P V of one tile of BK keys for one warpgroup, 3xTF32; p holds P in the
// S accumulator layout.
template <int D, int BK>
__device__ __forceinline__ void value_tile(float (&o)[D / 2], const float (&p)[BK / 2],
                                           const float* v_hi, const float* v_lo) {
  constexpr uint32_t LBO = 128, SBO = 128 * (BK / 4);  // next 4 k-positions, next 8 channels
  const uint32_t hi = smem_addr(v_hi), lo = smem_addr(v_lo);
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) {
    // k-positions c and c + 4 of key group g: keys 2c and 2c + 1, which the
    // accumulator holds at 4g + {0, 1} (row g) and 4g + {2, 3} (row g + 8)
    const float x[4] = {p[4 * g], p[4 * g + 2], p[4 * g + 1], p[4 * g + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_hi(x[e]);
      ahi[g][e] = __float_as_uint(h);
      alo[g][e] = __float_as_uint(x[e] - h);
    }
  }
#pragma unroll
  for (int e = 0; e < D / 2; ++e) fence_operand(o[e]);
  wgmma_fence();
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) {
    MmaTf32<D>::run(o, ahi[g], smem_desc(lo + 256 * g, LBO, SBO), g > 0);
  }
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) MmaTf32<D>::run(o, alo[g], smem_desc(hi + 256 * g, LBO, SBO), 1);
#pragma unroll
  for (int g = 0; g < BK / 8; ++g) MmaTf32<D>::run(o, ahi[g], smem_desc(hi + 256 * g, LBO, SBO), 1);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < D / 2; ++e) fence_operand(o[e]);
}

// The float4 walk of kv_image_kernel over a tile's image (BK keys): float4
// f of a part is row f % 8 of core matrix f / 8. True if each value lands
// where k_offset and v_offset (the layout the descriptors describe) put it.
template <int D, int BK>
constexpr bool image_walk_matches_offsets() {
  for (int f = 0; f < BK * D / 4; ++f) {
    const int cm = f >> 3, r = f & 7, kc = cm % (BK / 4);
    for (int e = 0; e < 4; ++e) {
      if (k_offset<D>(8 * (cm / (D / 4)) + r, 4 * (cm % (D / 4)) + e) != 4 * f + e) return false;
      if (v_offset<BK>(8 * (kc >> 1) + (kc & 1) + 2 * e, 8 * (cm / (BK / 4)) + r) != 4 * f + e) {
        return false;
      }
    }
  }
  return true;
}
static_assert(image_walk_matches_offsets<32, 64>() && image_walk_matches_offsets<48, 64>() &&
                  image_walk_matches_offsets<64, 64>() && image_walk_matches_offsets<128, 32>(),
              "kv_image_kernel's walk disagrees with the image layout");

// hi and lo parts of four values (see tf32_hi).
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// k, v (B, Tk, H*D) -> image (B, H, n_tiles, 4, BK * D), BK = f32_keys(D):
// per tile K hi, K lo, V^T hi, V^T lo at k_offset / v_offset, zero past Tk.
// Grid (n_tiles, H, B). The tile's rows of k and v go through shared memory,
// so that both the reads and the writes are whole float4s of consecutive
// addresses.
template <int D>
__global__ void __launch_bounds__(256)
kv_image_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ image, int Tk, int H) {
  constexpr int BK = f32_keys(D);
  constexpr int N4 = BK * D / 4;  // float4s in one part of a tile's image
  constexpr int LD = D + 4;       // padded rows: 8 rows' float4s hit 32 distinct banks
  __shared__ __align__(16) float ks[BK * LD], vs[BK * LD];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  for (int f = threadIdx.x; f < N4; f += blockDim.x) {
    const int j = f / (D / 4), c = 4 * (f % (D / 4));
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (tile * BK + j < Tk) {
      const size_t at = ((size_t)b * Tk + tile * BK + j) * C + h * D + c;
      kx = *reinterpret_cast<const float4*>(k + at);
      vx = *reinterpret_cast<const float4*>(v + at);
    }
    *reinterpret_cast<float4*>(&ks[j * LD + c]) = kx;
    *reinterpret_cast<float4*>(&vs[j * LD + c]) = vx;
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(image) + (((size_t)b * H + h) * gridDim.x + tile) * 4 * N4;
  for (int f = threadIdx.x; f < N4; f += blockDim.x) {
    // float4 f of a part is row f % 8 of core matrix f / 8
    const int cm = f >> 3, r = f & 7;
    float4 hi, lo;
    // K: key 8 (cm / (D/4)) + r, channels 4 (cm % (D/4)) + 0..3
    split4(*reinterpret_cast<const float4*>(&ks[(8 * (cm / (D / 4)) + r) * LD + 4 * (cm % (D / 4))]),
           hi, lo);
    dst[f] = hi;
    dst[N4 + f] = lo;
    // V^T: channel 8 (cm / (BK / 4)) + r, k-positions 4 kc + 0..3 of core
    // column kc = cm % (BK / 4), which are keys j0, j0 + 2, j0 + 4, j0 + 6
    const int ch = 8 * (cm / (BK / 4)) + r, kc = cm % (BK / 4);
    const int j0 = 8 * (kc >> 1) + (kc & 1);
    split4(make_float4(vs[j0 * LD + ch], vs[(j0 + 2) * LD + ch], vs[(j0 + 4) * LD + ch],
                       vs[(j0 + 6) * LD + ch]),
           hi, lo);
    dst[2 * N4 + f] = hi;
    dst[3 * N4 + f] = lo;
  }
}

// The fp32 route's block at head dim D, NWG consumer warpgroups.
template <int D, int NWG, bool MASKED>
struct F32Cfg {
  static constexpr int ROWS = ROWS_WG * NWG;
  static constexpr int BK = f32_keys(D);  // keys a tile
  // D = 128: Q's split in shared memory (hi, then lo), before the ring
  static constexpr bool Q_SMEM = D == 128;
  static_assert(!Q_SMEM || NWG == 1, "D = 128 takes one consumer warpgroup");
  static constexpr uint32_t Q_BYTES = Q_SMEM ? 2 * ROWS * D * sizeof(float) : 0;
  static constexpr uint32_t STAGE_BYTES = 4 * BK * D * sizeof(float);  // a tile's image
  // MASKED: a partial tile's mask words (4 a row) and each stage's unit
  static constexpr uint32_t WORDS = MASKED ? ROWS * 16 : 0;
  static constexpr int UNITS = MASKED ? STAGES : 0;
  // Q's images, the ring, the stages' words, their units, the barriers
  static constexpr size_t SMEM =
      Q_BYTES + STAGES * (STAGE_BYTES + WORDS) + UNITS * 4 + 2 * STAGES * 8;
};
static_assert(F32Cfg<64, 2, true>::SMEM <= 227 * 1024 && F32Cfg<128, 1, true>::SMEM <= 227 * 1024,
              "the ring exceeds a block's shared memory");

// The consumer warpgroups of flash_mha_kernel: the row block's n units (its
// listed tiles under a mask, else every tile), in the order the producer
// streams them; ents and words: each stage's unit (tile << 1 | partial) and,
// for a partial tile, its mask words. mask: always null (mask_tile). q_img:
// at D = 128 the block's shared memory for Q's split (F32Cfg::Q_BYTES).
template <int D, int NWG, bool MASKED>
__device__ __forceinline__ void consume(const float* __restrict__ q, const float* ring,
                                        float* q_img, uint64_t* full, uint64_t* empty,
                                        const unsigned char* __restrict__ mask,
                                        const uint32_t* words, const int* ents, int n,
                                        float* __restrict__ o, float* __restrict__ lse,
                                        int Tq, int Tk, int H, float q_scale, Dropout drop) {
  using Cfg = F32Cfg<D, NWG, MASKED>;
  constexpr int BK = Cfg::BK, TILE = BK * D, ROWS = ROWS_WG * NWG;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A consumer warp: rows `row` and `row + 8` of its 16, columns 2c, 2c + 1
  // of each group of 8 in the accumulators.
  const int g = lane / 4, c = lane % 4;
  const int rr = warp * 16 + g, row = blockIdx.x * ROWS + rr;
  const int C = H * D;
  constexpr int QREG = Cfg::Q_SMEM ? 1 : D / 8;  // Q's split in registers, D <= 64
  uint32_t qhi[QREG][4], qlo[QREG][4];
  if constexpr (Cfg::Q_SMEM) {
    // D = 128: Q's split would take 128 registers a thread beside o (64)
    // and the tile's P V (64), so the warpgroup writes it to shared memory
    // in the K part's layout (k_offset, a row as a key), zero past Tq, and
    // the S products read it by descriptor (score_tile_ss).
    for (int f = threadIdx.x; f < ROWS * D / 4; f += 128 * NWG) {
      const int r = f / (D / 4), col = 4 * (f % (D / 4)), gr = blockIdx.x * ROWS + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < Tq) {
        x = *reinterpret_cast<const float4*>(q + ((size_t)b * Tq + gr) * C + h * D + col);
        x = make_float4(x.x * q_scale, x.y * q_scale, x.z * q_scale, x.w * q_scale);
      }
      float4 hi, lo;
      split4(x, hi, lo);
      *reinterpret_cast<float4*>(q_img + k_offset<D>(r, col)) = hi;
      *reinterpret_cast<float4*>(q_img + ROWS * D + k_offset<D>(r, col)) = lo;
    }
    fence_proxy_async();  // the generic writes, before the wgmma's reads
    named_bar_sync(1, 128 * NWG);
  } else {
    const float* q0 = q + ((size_t)b * Tq + row) * C + h * D;
    const float* q1 = q0 + (size_t)8 * C;
    const bool ok0 = row < Tq, ok1 = row + 8 < Tq;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int col = 8 * ks + c;
      const float x[4] = {ok0 ? q0[col] * q_scale : 0.f, ok1 ? q1[col] * q_scale : 0.f,
                          ok0 ? q0[col + 4] * q_scale : 0.f, ok1 ? q1[col + 4] * q_scale : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_hi(x[e]);
        qhi[ks][e] = __float_as_uint(hi);
        qlo[ks][e] = __float_as_uint(x[e] - hi);
      }
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const float* tile = ring + st * 4 * TILE;
    float s[BK / 2];
    if constexpr (Cfg::Q_SMEM) {
      score_tile_ss<D, BK>(s, q_img, q_img + ROWS * D, tile, tile + TILE);
    } else {
      score_tile<D>(s, qhi, qlo, tile, tile + TILE);
    }
    // a full tile takes no test; an unmasked launch tests keys past Tk
    int k0 = i * BK;
    if constexpr (MASKED) {
      const int unit = ents[st];
      k0 = (unit >> 1) * BK;
      if (unit & 1) {
        uint32_t w[2];
        load_words<BK>(w, words + st * ROWS * 4, rr, c, unit >> 1);
        keep_bits<BK>(s, w);
      }
    } else if (mask != nullptr || k0 + BK > Tk) {
      mask_tile<BK>(s, mask, k0, row, c, Tq, Tk);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // the four lanes of a row are adjacent
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      // -inf-safe: a row with no kept key so far keeps l == 0
      base[hf] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hf] = exp2f(m[hf] - base[hf]);  // exp2(-inf) == 0
      m[hf] = m_new;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = exp2f(s[e] - base[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + sum[hf];
    if (drop.rate > 0.f) {  // after the sum: l counts every p, o only the kept
      const uint32_t salt = drop.salt(b * H + h);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const int r = row + 8 * ((e >> 1) & 1);
        s[e] = drop.keep(r, key, salt) ? s[e] * drop.scale : 0.f;
      }
    }

    // The tile's P V in an accumulator of its own, added to o in fp32: the
    // tensor core's accumulation truncates, and over all tiles of a long
    // row that bias would add up in o.
    float pv[D / 2];
    value_tile<D, BK>(pv, s, tile + 2 * TILE, tile + 3 * TILE);
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = fmaf(acc[e], alpha[(e >> 1) & 1], pv[e]);
  }

  // a row with no kept key (a row block with no unit included): l == 0,
  // o = 0 / 0 = NaN and lse = -inf, as the plain softmax gives
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 1);
    l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 2);
    const int r = row + 8 * hf;
    if (lse != nullptr && c == 0 && r < Tq) {
      lse[((size_t)b * H + h) * Tq + r] = m[hf] + log2f(l[hf]);
    }
    if (r < Tq) {
      float* dst = o + ((size_t)b * Tq + r) * C + h * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * hf] / l[hf], acc[4 * j + 2 * hf + 1] / l[hf]);
      }
    }
  }
}

// Grid (n_x, H, B): row block blockIdx.x of one (batch, head). MASKED:
// tile_map and bits are the mask's (see mask_rows) for ROWS_WG NWG rows and
// f32_keys(D) keys. The other instance is the first design's (`mask` always null,
// mask_tile), its parameters where they were.
template <int D, int NWG, bool MASKED>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_mha_kernel(const float* __restrict__ q, const float* __restrict__ image,
                 const unsigned char* __restrict__ mask, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float q_scale, Dropout drop,
                 const int* __restrict__ tile_map, const uint32_t* __restrict__ bits) {
  using Cfg = F32Cfg<D, NWG, MASKED>;
  constexpr int BK = Cfg::BK, TILE = BK * D;  // floats of one part of a tile's image
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + Cfg::Q_BYTES);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + Cfg::Q_BYTES + STAGES * Cfg::STAGE_BYTES);
  int* ents =
      reinterpret_cast<int*>(smem + Cfg::Q_BYTES + STAGES * (Cfg::STAGE_BYTES + Cfg::WORDS));
  uint64_t* full = reinterpret_cast<uint64_t*>(ents + Cfg::UNITS);
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, x = blockIdx.x;
  const int n_tiles = (Tk + BK - 1) / BK;
  // the row block's units: its listed tiles, or every tile
  const int n = MASKED ? tile_map[3 + x] - tile_map[2 + x] : n_tiles;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread starts the copies
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      const float* src = image + (size_t)(b * H + h) * n_tiles * 4 * TILE;
      if constexpr (MASKED) {
        const int* units = tile_map + 3 + gridDim.x + tile_map[2 + x];
        const uint32_t* row_words = bits + (size_t)x * Cfg::ROWS * 4;
        int next = n > 0 ? units[0] : 0;  // each unit's entry read one unit ahead
        for (int i = 0; i < n; ++i) {
          const int s = i % STAGES;
          const int unit = next, t = unit >> 1;
          if (i + 1 < n) next = units[i + 1];
          if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
          ents[s] = unit;  // before the arrival, which releases it
          mbar_arrive_expect_tx(&full[s], Cfg::STAGE_BYTES + (unit & 1 ? Cfg::WORDS : 0));
          bulk_load(ring + s * 4 * TILE, src + (size_t)t * 4 * TILE, Cfg::STAGE_BYTES, &full[s]);
          if (unit & 1) {
            bulk_load(words + s * Cfg::ROWS * 4,
                      row_words + (size_t)mask_group<BK>(t) * mask_rows(Tq) * 4, Cfg::WORDS,
                      &full[s]);
          }
        }
      } else {
        for (int i = 0; i < n; ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], Cfg::STAGE_BYTES);
          bulk_load(ring + s * 4 * TILE, src + (size_t)i * 4 * TILE, Cfg::STAGE_BYTES, &full[s]);
        }
      }
    }
  } else {
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    consume<D, NWG, MASKED>(q, ring, reinterpret_cast<float*>(smem), full, empty, mask, words,
                            ents, n, o, lse, Tq, Tk, H, q_scale, drop);
  }
}

template <int D, int NWG, bool MASKED>
cudaError_t launch(const float* q, const float* k, const float* v, const int* tile_map,
                   const uint32_t* bits, float* image, float* o, float* lse, int B, int Tq,
                   int Tk, int H, float q_scale, Dropout drop, cudaStream_t stream) {
  constexpr int BK = f32_keys(D);
  const int n_tiles = (Tk + BK - 1) / BK;
  kv_image_kernel<D><<<dim3(n_tiles, H, B), 256, 0, stream>>>(k, v, image, Tk, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = flash_mha_kernel<D, NWG, MASKED>;
  const size_t smem = F32Cfg<D, NWG, MASKED>::SMEM;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = ROWS_WG * NWG;
  kernel<<<dim3((Tq + rows - 1) / rows, H, B), (NWG + 1) * 128, smem, stream>>>(
      q, image, nullptr, o, lse, Tq, Tk, H, q_scale, drop, tile_map, bits);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_rows(int block_rows, const float* q, const float* k, const float* v,
                        const int* tile_map, const uint32_t* bits, float* image, float* o,
                        float* lse, int B, int Tq, int Tk, int H, float q_scale, Dropout drop,
                        cudaStream_t stream) {
  if constexpr (F32Cfg<D, 1, MASKED>::Q_SMEM) {  // D = 128: 64 rows, Q's images fill the block
    return block_rows == 64 ? launch<D, 1, MASKED>(q, k, v, tile_map, bits, image, o, lse, B, Tq,
                                                   Tk, H, q_scale, drop, stream)
                            : cudaErrorInvalidValue;
  } else {
    return block_rows == 64 ? launch<D, 1, MASKED>(q, k, v, tile_map, bits, image, o, lse, B, Tq,
                                                   Tk, H, q_scale, drop, stream)
                            : launch<D, 2, MASKED>(q, k, v, tile_map, bits, image, o, lse, B, Tq,
                                                   Tk, H, q_scale, drop, stream);
  }
}

// ===========================================================================
// The bf16 route: q, k, v and o in bf16, every sum and the softmax in fp32.
//
// Bound: operations. A head does 4 Tq Tk D flops (two products) on
// 2 (Tq + Tk) D bf16 values in and Tq D out, several hundred flops per byte
// at the released shapes: the bound is 4 B H Tq Tk D at the dense bf16 rate
// (989 TFLOP/s), one wgmma product per matmul. Beside the products, the
// softmax takes one exp2 per score on the special-function unit, 16 per clock
// per SM against the tensor cores' 4096 flops per clock: at D = 64 a score's
// exp2 (1/16 clock) takes as long as its 4 D = 256 flops, so the kernel nears
// its bound only where the exponentials run under the products.
//
// Design, against what held the first bf16 kernel back (PERF.md):
// 1. The softmax under the products. Inside a consumer warpgroup the loop is
//    software-pipelined: tile i's S = Q K^T is issued together with tile
//    i - 1's O += P V, and tile i's softmax runs while that P V is on the
//    tensor cores (registers: S in fp32, the previous P as packed bf16 A
//    fragments, O; 64 + 32 + 32 at 128 keys and D = 64). Between the block's
//    warpgroups, named barriers pass the turn to issue products round robin,
//    so one warpgroup's softmax runs under another's products.
// 2. Tile widths: BK = 64 or 128 keys a tile (KEY_TILE_BF16 in
//    kernels/attention.py) and 128 or 192 query rows a block (two or three
//    consumer warpgroups of 64), all templated; chip_smoke.py sweeps them.
// 3. Loads: one producer thread issues tensor-memory-accelerator copies, a K
//    and a V tile per stage of a 4-stage ring against one mbarrier's byte
//    count, and each row block's Q into one of two buffers; no thread spends
//    instructions or registers on addresses. The tensor maps are 3-D,
//    (C, T, B), so a box past Tk (or Tq) is zero-filled instead of reading
//    the next item's rows. The producer warpgroup gives its registers to the
//    consumers (setmaxnreg 24 / 240 with two consumer warpgroups, 32 / 160
//    with three); no instance spills.
// 4. Per score: one FFMA and one exp2, p = 2^(s scale - m scale) with m the
//    raw row max (the scale folded in), then a max and an add; the keep
//    test only on a tile with a mask or past Tk; the -inf-safe rescale once
//    per row and tile.
// 5. The wave tail. With ctas = the number of SMs the grid is persistent:
//    block c walks range c of the (row block, key tile) units, cut as evenly
//    as they come (Schedule), so every SM does the same work whatever the
//    number of row blocks; a row block that two ranges share is written as
//    partial pieces (unnormalised o, scaled row max, row sum) to fp32
//    scratch and merged by flash_mha_bf16_combine_kernel. With ctas = the
//    number of row blocks, each block takes one, whole (the host's choice,
//    kernels/attention.py bf16_plan).
//
// 6. Under a keep-mask (what bounded the first masked kernel: every (row
//    block, key tile) unit visited, masked or not, and a byte per score
//    loaded from global memory after the S products' wait, on the chain the
//    next P V waits for; 4.2-5.1x the unmasked time, 1.4-2.5x SDPA with the
//    same mask, PERF.md): the schedule's units are the mask's tile map's
//    (the non-empty units, row block by row block in key order), so the
//    persistent ranges cut the work there is and the producer streams only
//    listed tiles; a full tile takes no test; a partial one's stage carries
//    its row block's mask words (ROWS x 4, one bulk copy on the stage's
//    barrier), which a consumer reads before the S products' wait, so the
//    keep test is a bit test and a select a score. Row blocks the map lists
//    as empty are filled with NaN (lse -inf) by the grid's blocks in turn.
//    This is flash_mha_bf16_masked_kernel; an unmasked launch runs the first
//    design's flash_mha_bf16_kernel, unchanged. Times on one H100 80GB HBM3
//    at 700.00 W (as for the fp32 route above): diag at freq self 0.1586 /
//    0.8635 ms -> 0.0239 / 0.1096; no empty unit 1.08-1.23x the unmasked
//    time (4.2-5.1x before); 0.17-0.64x SDPA with the mask (1.4-2.5x
//    slower before). Tried and dropped: one
//    pipeline across a block's pieces (a piece's first S issued with the
//    previous piece's last P V) was slower in turns, and 37 % slower where
//    ptxas serialised its wgmma groups (an accumulator zeroed in the loop).
//
// D = 128 (flash_mha_d128.cu): 64 keys a tile and 128 rows a block, the one
// plan whose ring of 4 stages fits beside the two Q images (193 KiB; 128
// keys would take 321), a slice in two boxes of 128 bytes, P V m64n128k16
// over both; the DROP instances add each stage's column terms (256 bytes):
// 194 KiB, 204 KiB masked (its words and offsets).
//
// Shared memory: a head's slice of a row is W bytes (W = 128 at D = 64 and
// 128, 64 at D = 32, and 32 at D = 48 in three boxes of 16 channels),
// swizzled at W by the tensor map (tensor_map.cuh, shared with the
// backward) and read by wgmma through descriptors of the same swizzle:
// K-major for Q and K (S = Q K^T, both operands from shared memory), and V
// MN-major with the transpose bit (O = P V, keys the reduction). P goes
// from the S accumulator to the A fragment by pairwise packing (MmaBf16).
// A fully masked row keeps l == 0 and gives 0 / 0 = NaN, as in the fp32 route.
//
// Training, as on the fp32 route: the Pallas kernel's hashed dropout of the
// probabilities (attention_dropout.cuh: global query row, key and batch-head
// salt, so every plan and schedule drops the same scores), applied to the
// unnormalised P after the row sum has taken it, before P is packed for
// P V. Where the caller asks, each row's log-sum-exp (base 2, of the scaled
// scores: m scale + log2 l) goes to `lse` for the backward
// (flash_mha_bwd.cu): from the store of a whole row block, or from
// flash_mha_bf16_combine_kernel for a merged one.
//
// What bounds the drop on this card: integer and logic issue. The hash is
// one murmur3 finalizer a score, which no tile shares; against it a score
// costs 1/16 clock of tensor-core work at D = 64 and one exp2. The
// finalizer's XORs and shifts run on the integer pipe, 16 lanes a clock per
// SM sub-partition, half the FMA pipe's rate. Measured (PERF.md), the time
// the drop adds is its integer-pipe instructions at that pipe's rate over
// the whole card, wherever they stand: between the products' issue and
// their wait, among the softmax's exponentials, or in the producer
// warpgroup's own warps (writing the tile's bits to shared memory); none
// hid them under the tensor cores, so the design cuts instructions (the
// first kernel took 13.6 a score: the counter's two products and XORs, the
// finalizer, a shift and compare, a select and the 1 / (1 - rate)
// multiply):
// - DROP is a template argument: the rate-0 instance has no dropout code.
// - The counter's XOR and the finalizer's first x ^= x >> 16 are linear over
//   GF(2), so each row's term is formed once a piece and each key's term once
//   a tile, by a producer warp into the stage beside the tile's K and V (one
//   8-byte read a lane for two keys); the compare is x >= t << 8 on the
//   finalizer's output (no shift). What stays a score: XOR, multiply, shift
//   and XOR, multiply, shift and XOR, compare, select: 9 instructions in the
//   SASS, and a quarter of a shared-memory read.
// - Kept P stays unscaled: o = acc (1 / (1 - rate)) / l at the store (or in
//   flash_mha_bf16_combine_kernel for a merged row block); lse is the
//   undropped one.
// - The drop runs after the softmax while the previous tile's P V is on the
//   tensor cores, and touches no register the wgmma holds.
// Times on one H100 80GB HBM3 at 700.00 W, freq self (2688 x 2688, 8 heads,
// D = 64), dropout 0.1, B = 1 / 8, the first kernel against this one in
// turns (chip_smoke.py --k3-pair): 0.0827 / 0.5378 ms -> 0.0714 / 0.4535 ms
// (rate 0: 0.0387 / 0.2480 -> 0.0382 / 0.2449). The drop still adds 0.21 ms
// at B = 8: 4.62e8 scores x 7 integer-pipe instructions over 132 SMs x 64 a
// clock; the byte-permute form of x >> 16 (PRMT for SHF) ran the same.
// ===========================================================================

template <int D, int BK, int NWG, bool DROP = false, bool MASKED = false>
struct Bf16Cfg {
  static constexpr int ROWS = ROWS_WG * NWG;     // query rows per block
  static constexpr uint32_t TILE = BK * D * 2;   // bytes of one K or V tile
  static constexpr uint32_t Q_BYTES = ROWS * D * 2;
  static constexpr int STAGES = 4;               // K/V tile pairs in the ring
  static constexpr int THREADS = (NWG + 1) * 128;
  // setmaxnreg's split of the block's registers (the launch gives each
  // thread 65536 / THREADS, rounded down to 8): what the producer warpgroup
  // gives up, the consumers take, or setmaxnreg.inc waits for ever. MASKED,
  // two consumer warpgroups: 40 / 232, the producer reading the tile map.
  static constexpr int PRODUCER_REGS = NWG == 2 ? (MASKED ? 40 : 24) : 32;
  static constexpr int CONSUMER_REGS = NWG == 2 ? (MASKED ? 232 : 240) : 160;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert((LAUNCH_REGS - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - LAUNCH_REGS) * 128 * NWG,
                "the consumers would take more registers than the producer gives up");
  // DROP: each stage's tile also carries the dropout's column terms of its keys
  static constexpr uint32_t COLS = DROP ? BK * 4 : 0;
  // MASKED: a partial tile's stage also carries its mask words, 4 a row
  // (mask_rows), each stage its unit, and the block the map's offsets
  static constexpr uint32_t WORDS = MASKED ? ROWS * 16 : 0;
  static constexpr int UNITS = MASKED ? STAGES : 0, OFFS = MASKED ? OFF_SMEM : 0;
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + STAGES * (2 * TILE + COLS + WORDS) +
                                 (UNITS + OFFS) * 4 + (2 * STAGES + 4) * 8;
  // Over half the SM's shared memory: one block per SM, so that the
  // consumers' setmaxnreg.inc finds the registers the producer gave up.
  static constexpr size_t SMEM_LAUNCH = SMEM > 118 * 1024 ? SMEM : 118 * 1024;
  static_assert(SMEM <= 227 * 1024, "the ring exceeds a block's shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(v[e]);
}
template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&v)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fence_operand(v[i][r]);
  }
}

// Issues S = Q K^T of one tile into s (raw scores, fp32, accumulator layout)
// as one wgmma group. q_wg: the warpgroup's 64 rows of Q's image, whose
// boxes lie q_box bytes apart; k_tile: the tile's K image.
template <int D, int BK>
__device__ __forceinline__ void score_issue(float (&s)[BK / 2], uint32_t q_wg, uint32_t q_box,
                                            uint32_t k_tile) {
  using I = HeadImage<D>;
  fence_all(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    // channels 16 ks..16 ks + 15: box 32 ks / W, 32 ks % W bytes into its rows
    const uint32_t box = 32 * ks / I::W, inner = 32 * ks % I::W;
    MmaBf16SS<BK>::run(s, swizzled_desc(q_wg + box * q_box + inner, 16, 8 * I::W, I::LAYOUT),
                       swizzled_desc(k_tile + box * BK * I::W + inner, 16, 8 * I::W, I::LAYOUT),
                       ks > 0);
  }
  wgmma_commit();
}

// Issues o += P V of one tile as one wgmma group; pa holds P as bf16 A
// fragments, one per 16 keys (they must stay untouched until the group is done).
template <int D, int BK>
__device__ __forceinline__ void value_issue(float (&o)[D / 2], uint32_t (&pa)[BK / 16][4],
                                            uint32_t v_tile) {
  using I = HeadImage<D>;
  fence_all(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // keys 16 kk..16 kk + 15: rows 16 kk.. of the tile; N (channels) runs over the boxes
    MmaBf16<D, 1>::run(o, pa[kk],
                       swizzled_desc(v_tile + kk * 16 * I::W, BK * I::W, 8 * I::W, I::LAYOUT), 1);
  }
  wgmma_commit();
}

// P (fp32, S accumulator layout) -> bf16 A fragments: columns 16 kk..16 kk + 15
// of the accumulator are registers 8 kk..8 kk + 7, pairwise.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&p)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
  }
}

// The online softmax of one tile for a thread's two rows: s (raw scores)
// becomes p = 2^(s scale - m scale) in place, m the running raw row max;
// alpha = 2^((m_old - m) scale) rescales the earlier o and l. -inf-safe: a
// row with no kept key so far keeps m = -inf, l = 0 (its base is 0).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float base[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // the four lanes of a row are adjacent
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 2));
    base[hf] = mx[hf] == -INFINITY ? 0.f : mx[hf] * scale;
    alpha[hf] = ex2(fmaf(m[hf], scale, -base[hf]));  // 2^-inf = 0
    m[hf] = mx[hf];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    s[e] = ex2(fmaf(s[e], scale, -base[(e >> 1) & 1]));
    sum[(e >> 1) & 1] += s[e];
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + sum[hf];
}

// The dropout of one tile of P (after its row sums), as the previous tile's
// P V runs: lane (g, c) holds rows `row` and `row + 8` (e >> 1 even, odd),
// keys k0 + 8 j + 2c + (e & 1) (j = e >> 2). rt: the row terms of its two
// rows (Dropout::row_term); kt: the tile's column terms (its stage's,
// written by the producer warpgroup) from key 2c on, so that a lane reads
// the pair of its keys 8 j + 2c, + 1 as one 8-byte word. Per score what
// stays of the hash and a select: the kept values stay unscaled, 1 / (1 -
// rate) multiplies o once at the end.
template <int BK>
__device__ __forceinline__ void drop_tile(float (&p)[BK / 2], const Dropout& drop,
                                          const uint32_t (&rt)[2], const uint32_t* kt) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const uint2 k = *reinterpret_cast<const uint2*>(kt + 8 * j);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) {
      p[e] = drop.kept(rt[(e >> 1) & 1] ^ (e & 1 ? k.y : k.x)) ? p[e] : 0.f;
    }
  }
}

// Row `row + 8 hf` of a thread's accumulator (columns 8 j + 2c, + 1), times
// keep_scale (the dropout's 1 / (1 - rate), or 1) and divided by its row sum,
// to bf16 at dst (that row's columns h D + 2c). 0 / 0 = NaN for a row with
// no kept key.
template <int D>
__device__ __forceinline__ void store_o(__nv_bfloat16* dst, const float (&v)[D / 2], int hf,
                                        float l, float keep_scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(v[4 * j + 2 * hf] * keep_scale / l,
                                                          v[4 * j + 2 * hf + 1] * keep_scale / l);
  }
}

// The persistent schedule. The R = B H ceil(Tq / ROWS) row blocks (x
// fastest, then the head, then the item) of n_tiles key tiles each make U =
// R n_tiles units, cut into G contiguous ranges as even as they come (the
// first U % G ranges one unit longer), one per block of the grid. A block
// walks its range row block by row block: all of a row block's tiles are a
// whole piece, written to o; the part of a row block where a range starts or
// ends is a partial piece, written unnormalised to a scratch slot (slot 2c
// for range c's first row block, 2c + 1 for its last) and merged by
// flash_mha_bf16_combine_kernel. G = R is the plain grid: a row block each.
struct Schedule {
  int n_tiles, q, rem;  // 32-bit: the host keeps R n_tiles under 2^31
  __host__ __device__ Schedule(int R, int n_tiles, int G)
      : n_tiles(n_tiles), q(R * n_tiles / G), rem(R * n_tiles % G) {}
  // the first unit of range c
  __host__ __device__ int lo(int c) const { return c * q + (c < rem ? c : rem); }
  // the range that holds unit u
  __host__ __device__ int range_of(int u) const {
    return u < rem * (q + 1) ? u / (q + 1) : rem + (u - rem * (q + 1)) / q;
  }
  // range c's scratch slot for row block r
  __host__ __device__ int slot(int c, int r) const {
    return r == lo(c) / n_tiles ? 2 * c : 2 * c + 1;
  }
  // row block r's first unit and units, and the row block of unit u
  __host__ __device__ int start(int r) const { return r * n_tiles; }
  __host__ __device__ int count(int) const { return n_tiles; }
  __host__ __device__ int row_of(int u) const { return u / n_tiles; }
};

// The units of a masked launch: row block r = x + n_x (h + H b) (x fastest,
// then the head, then the item) holds the key tiles the tile map lists for
// x, in key order (none for an empty row block); the units of all row blocks
// in order make U = B H per_bh.
struct Units {
  const int* off;  // the tile map's offsets, n_x + 1
  int n_x, per_bh;  // per_bh: the map's nnz, the units of one (batch, head)
  __host__ __device__ int count(int r) const {
    const int x = r % n_x;
    return off[x + 1] - off[x];
  }
  // the first unit of row block r
  __host__ __device__ int start(int r) const { return r / n_x * per_bh + off[r % n_x]; }
  // the row block that holds unit u (never an empty one)
  __host__ __device__ int row_of(int u) const {
    const int bh = u / per_bh, l = u % per_bh;
    int lo = 0, hi = n_x - 1;  // the last x with off[x] <= l
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= l) lo = mid; else hi = mid - 1;
    }
    return bh * n_x + lo;
  }
};

// The persistent schedule of a masked launch, as Schedule over its units:
// the U units cut into G contiguous ranges as even as they come (the first
// U % G ranges one unit longer), one per block; a row block that two ranges
// share is merged by flash_mha_bf16_combine_kernel from their pieces
// (slot 2c for range c's first row block, 2c + 1 for its last). G = R is the
// plain grid, a row block each (block_range).
struct UnitSchedule {
  Units un;
  int q, rem;  // 32-bit: the host keeps R n_tiles under 2^31
  __host__ __device__ UnitSchedule(Units un, int R, int G)
      : un(un), q(R / un.n_x * un.per_bh / G), rem(R / un.n_x * un.per_bh % G) {}
  // the first unit of range c
  __host__ __device__ int lo(int c) const { return c * q + (c < rem ? c : rem); }
  // the range that holds unit u
  __host__ __device__ int range_of(int u) const {
    return u < rem * (q + 1) ? u / (q + 1) : rem + (u - rem * (q + 1)) / q;
  }
  // as Schedule's
  __host__ __device__ int start(int r) const { return un.start(r); }
  __host__ __device__ int count(int r) const { return un.count(r); }
  __host__ __device__ int row_of(int u) const { return un.row_of(u); }
};

// The schedule of a launch over R row blocks of n_tiles key tiles in G
// ranges: a masked launch's over its tile map's units.
template <bool MASKED>
__device__ __forceinline__ auto launch_schedule(const int* tile_map, int n_x, int R, int n_tiles,
                                                int G) {
  if constexpr (MASKED) {
    return UnitSchedule(Units{tile_map + 2, n_x, tile_map[0]}, R, G);
  } else {
    return Schedule(R, n_tiles, G);
  }
}

// A block's share of a masked launch: its units [u0, u1) and the row blocks
// r0 .. r1 they lie in; with G = R (the plain grid) row block blockIdx.x,
// which may hold no unit. Each role of the kernel forms it after setmaxnreg,
// so that none of it lives across the register split (what does must fit
// the producer's few registers). off: the tile map's offsets, in shared
// memory.
struct BlockRange {
  Units un;
  int u0, u1, r0, r1;
};
__device__ __forceinline__ BlockRange block_range(const int* tile_map, const int* off, int n_x,
                                                  int R) {
  const Units un{off, n_x, tile_map[0]};
  if ((int)gridDim.x == R) {
    const int u0 = un.start(blockIdx.x);
    return {un, u0, u0 + un.count(blockIdx.x), (int)blockIdx.x, (int)blockIdx.x};
  }
  const UnitSchedule sched(un, R, gridDim.x);
  const int u0 = sched.lo(blockIdx.x), u1 = sched.lo(blockIdx.x + 1);
  if (u1 <= u0) return {un, u0, u1, 0, -1};
  return {un, u0, u1, un.row_of(u0), un.row_of(u1 - 1)};
}

// The row blocks the tile map lists as empty, which no range holds: each
// row NaN in o (bf16) and -inf in lse, as the plain softmax over no kept key
// gives; block c of the grid fills items c, c + G, ... of (empty row block,
// batch-head), by `threads` threads from `tid`.
template <int D, int ROWS>
__device__ void fill_empty(const int* empty, int n_empty, __nv_bfloat16* o, float* lse, int B,
                           int Tq, int H, int tid, int threads) {
  for (int item = blockIdx.x; item < n_empty * H * B; item += gridDim.x) {
    const int bh = item / n_empty, x = empty[item % n_empty];
    const int b = bh / H, h = bh % H;
    for (int i = tid; i < ROWS * (D / 2); i += threads) {
      const int row = x * ROWS + i / (D / 2);
      if (row < Tq) {
        *reinterpret_cast<uint32_t*>(o + ((size_t)b * Tq + row) * H * D + h * D +
                                     2 * (i % (D / 2))) = 0x7fc07fc0u;  // two bf16 NaNs
      }
    }
    if (lse != nullptr) {
      for (int i = tid; i < ROWS && x * ROWS + i < Tq; i += threads) {
        lse[(size_t)bh * Tq + x * ROWS + i] = -INFINITY;
      }
    }
  }
}

// Grid (G): range blockIdx.x of the schedule. A scratch slot holds ROWS x D
// of unnormalised o (the dropout's scale not applied), then ROWS x (the
// scaled row max, the row sum), fp32. lse: null, or (B H, Tq) fp32. DROP:
// the instance with the hashed dropout (drop.rate > 0); the other has no
// dropout code. The unmasked launches' kernel, the first design's: `mask`
// is always null (mask_tile says why it stays; a masked launch takes
// flash_mha_bf16_masked_kernel).
template <int D, int BK, int NWG, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_mha_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ part, float* __restrict__ lse, int B, int Tq, int Tk,
                      int H, float scale, Dropout drop) {
  using Cfg = Bf16Cfg<D, BK, NWG, DROP>;
  using I = HeadImage<D>;
  constexpr int STAGES = Cfg::STAGES, ROWS = Cfg::ROWS, SLOT = ROWS * (D + 2);
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  // two Q images, then the ring (stage s: K tile, V tile), then (DROP) each
  // stage's column terms, then the barriers; every image 1024-byte aligned
  // (the swizzle atoms' alignment).
  unsigned char* base = bf16_smem + ((1024 - (smem_addr(bf16_smem) & 1023)) & 1023);
  const uint32_t q_img = smem_addr(base), ring = q_img + 2 * Cfg::Q_BYTES;
  uint32_t* cols = reinterpret_cast<uint32_t*>(base + 2 * Cfg::Q_BYTES + STAGES * 2 * Cfg::TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(cols + STAGES * Cfg::COLS / 4);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 2;

  const int n_x = (Tq + ROWS - 1) / ROWS, n_tiles = (Tk + BK - 1) / BK;
  const Schedule sched(n_x * H * B, n_tiles, gridDim.x);
  const int u0 = sched.lo(blockIdx.x), u1 = sched.lo(blockIdx.x + 1);
  const int r0 = u0 / n_tiles, r1 = (u1 - 1) / n_tiles;  // the row blocks it touches
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's arrival, plus the bytes (DROP: and the column terms' warp)
      mbar_init(&full[s], DROP ? 33 : 1);
      mbar_init(&empty[s], 4 * NWG);  // every consumer warp, after its products read the tiles
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 4 * NWG);  // every consumer warp, after its last S of the piece
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // The producer warpgroup: one thread issues the copies; with DROP the
    // next warp writes each tile's column terms into its stage (once a tile,
    // where every consumer lane would form its own).
    setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      prefetch_tensormap(&q_map);
      prefetch_tensormap(&k_map);
      prefetch_tensormap(&v_map);
      int it = 0;  // tiles streamed through the ring so far
      for (int r = r0; r <= r1; ++r) {
        const int p = r - r0, qb = p & 1;
        const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
        const int tb = max(u0, r * n_tiles) - r * n_tiles;
        const int te = min(u1, (r + 1) * n_tiles) - r * n_tiles;
        if (p >= 2) mbar_wait(&q_empty[qb], ((p >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qb], Cfg::Q_BYTES);
#pragma unroll
        for (int j = 0; j < I::BOXES; ++j) {
          tma_load_3d(q_img + qb * Cfg::Q_BYTES + j * ROWS * I::W, &q_map, h * D + j * (I::W / 2),
                      x * ROWS, b, &q_full[qb]);
        }
        for (int t = tb; t < te; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], 2 * Cfg::TILE);
          const uint32_t k_dst = ring + s * 2 * Cfg::TILE, v_dst = k_dst + Cfg::TILE;
#pragma unroll
          for (int j = 0; j < I::BOXES; ++j) {
            tma_load_3d(k_dst + j * BK * I::W, &k_map, h * D + j * (I::W / 2), t * BK, b, &full[s]);
            tma_load_3d(v_dst + j * BK * I::W, &v_map, h * D + j * (I::W / 2), t * BK, b, &full[s]);
          }
        }
      }
    } else if (DROP && warp == 4 * NWG + 1) {
      for (int u = u0; u < u1; ++u) {  // the block's units in order: tile u % n_tiles
        const int it = u - u0, s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const uint32_t k = (uint32_t)((u % n_tiles) * BK + lane) * 0x85EBCA77u;
#pragma unroll
        for (int q = 0; q < BK / 32; ++q) {
          cols[s * BK + 32 * q + lane] = Dropout::col_term(k + (uint32_t)(32 * q) * 0x85EBCA77u);
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {  // NWG consumer warpgroups of 64 query rows
    setmaxnreg_inc<Cfg::CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, c = lane % 4;
    const int rr = wg * ROWS_WG + (warp % 4) * 16 + g;  // the thread's first row in the block
    // The turn to issue products passes round robin between the warpgroups:
    // warpgroup w waits at barrier 1 + w, then opens 1 + (w + 1) % NWG (two
    // warpgroups' threads each); warpgroup 0 opens its own first.
    if (wg == 0) named_bar_arrive(1, 256);
    const int next_bar = 1 + (wg + 1) % NWG;
    const bool masked = mask != nullptr;
    const int C = H * D;
    int it = 0;
    for (int r = r0; r <= r1; ++r) {
      const int p = r - r0, qb = p & 1;
      const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
      const int tb = max(u0, r * n_tiles) - r * n_tiles;
      const int te = min(u1, (r + 1) * n_tiles) - r * n_tiles;
      const int n = te - tb, row = x * ROWS + rr;
      const uint32_t q_wg = q_img + qb * Cfg::Q_BYTES + wg * ROWS_WG * I::W;
      uint32_t rt[2];  // the dropout's row terms
      if constexpr (DROP) {
        const uint32_t salt = drop.salt(b * H + h);
        rt[0] = Dropout::row_term(row, salt);
        rt[1] = Dropout::row_term(row + 8, salt);
      }

      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float s[BK / 2];
      uint32_t pa[BK / 16][4];

      mbar_wait(&q_full[qb], (p >> 1) & 1);
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      named_bar_sync(1 + wg, 256);
      score_issue<D, BK>(s, q_wg, ROWS * I::W, ring + (it % STAGES) * 2 * Cfg::TILE);
      named_bar_arrive(next_bar, 256);
      wgmma_wait<0>();
      fence_all(s);
      if (masked || (tb + 1) * BK > Tk) mask_tile<BK>(s, mask, tb * BK, row, c, Tq, Tk);
      softmax_tile<BK>(s, m, l, alpha, scale);
      if constexpr (DROP) drop_tile<BK>(s, drop, rt, cols + (it % STAGES) * BK + 2 * c);
      pack_p<BK>(pa, s);
      for (int i = 1; i < n; ++i) {
        const int j = it + i, st = j % STAGES, prev = (j - 1) % STAGES;
        mbar_wait(&full[st], (j / STAGES) & 1);
        named_bar_sync(1 + wg, 256);
        score_issue<D, BK>(s, q_wg, ROWS * I::W, ring + st * 2 * Cfg::TILE);
        value_issue<D, BK>(acc, pa, ring + prev * 2 * Cfg::TILE + Cfg::TILE);
        named_bar_arrive(next_bar, 256);
        wgmma_wait<1>();  // this tile's S; the previous tile's P V still runs
        fence_all(s);
        const int k0 = (tb + i) * BK;
        if (masked || k0 + BK > Tk) mask_tile<BK>(s, mask, k0, row, c, Tq, Tk);
        softmax_tile<BK>(s, m, l, alpha, scale);
        if constexpr (DROP) drop_tile<BK>(s, drop, rt, cols + st * BK + 2 * c);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(pa);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
        pack_p<BK>(pa, s);
      }
      if (lane == 0) mbar_arrive(&q_empty[qb]);  // every S of the piece is done
      const int last = (it + n - 1) % STAGES;
      named_bar_sync(1 + wg, 256);
      value_issue<D, BK>(acc, pa, ring + last * 2 * Cfg::TILE + Cfg::TILE);
      named_bar_arrive(next_bar, 256);
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(pa);
      if (lane == 0) mbar_arrive(&empty[last]);
      it += n;

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // the row sums over the row's four lanes
        l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 1);
        l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 2);
      }
      if (tb == 0 && te == n_tiles) {  // a whole row block: o = acc / l
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = row + 8 * hf;
          if (r >= Tq) continue;
          store_o<D>(o + ((size_t)b * Tq + r) * C + h * D + 2 * c, acc, hf, l[hf],
                     DROP ? drop.scale : 1.f);
          if (lse != nullptr && c == 0) {
            lse[((size_t)b * H + h) * Tq + r] = m[hf] * scale + log2f(l[hf]);
          }
        }
        continue;
      }
      // a partial piece: unnormalised, to its scratch slot
      float* mine = part + (size_t)sched.slot(blockIdx.x, r) * SLOT;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* dst = mine + (rr + 8 * hf) * D + 2 * c;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<float2*>(dst + 8 * jj) =
              make_float2(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
        }
        if (c == 0) {
          *reinterpret_cast<float2*>(mine + ROWS * D + (rr + 8 * hf) * 2) =
              make_float2(m[hf] == -INFINITY ? -INFINITY : m[hf] * scale, l[hf]);
        }
      }
    }
  }
}

// The masked launches' kernel: as flash_mha_bf16_kernel (grid, scratch
// slots, lse, DROP), over the units of the mask's tile map for this plan
// (tile_map and bits, see mask_rows): a partial tile's stage carries its
// mask words, a full one takes no test, row blocks with no unit are filled.
template <int D, int BK, int NWG, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_mha_bf16_masked_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const int* __restrict__ tile_map, const uint32_t* __restrict__ bits,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                             float* __restrict__ lse, int B, int Tq, int Tk, int H, float scale,
                             Dropout drop) {
  using Cfg = Bf16Cfg<D, BK, NWG, DROP, true>;
  using I = HeadImage<D>;
  constexpr int STAGES = Cfg::STAGES, ROWS = Cfg::ROWS, SLOT = ROWS * (D + 2);
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  // two Q images, then the ring (stage s: K tile, V tile), then (DROP) each
  // stage's column terms, each stage's mask words and unit, then the
  // barriers; every image 1024-byte aligned (the swizzle atoms' alignment).
  unsigned char* base = bf16_smem + ((1024 - (smem_addr(bf16_smem) & 1023)) & 1023);
  const uint32_t q_img = smem_addr(base), ring = q_img + 2 * Cfg::Q_BYTES;
  uint32_t* cols = reinterpret_cast<uint32_t*>(base + 2 * Cfg::Q_BYTES + STAGES * 2 * Cfg::TILE);
  uint32_t* words = cols + STAGES * Cfg::COLS / 4;
  int* ents = reinterpret_cast<int*>(words + STAGES * Cfg::WORDS / 4);
  int* off_smem = ents + Cfg::UNITS;
  uint64_t* full = reinterpret_cast<uint64_t*>(off_smem + Cfg::OFFS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 2;

  const int n_x = (Tq + ROWS - 1) / ROWS;
  for (int i = threadIdx.x; i <= n_x; i += blockDim.x) off_smem[i] = tile_map[2 + i];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's arrival, plus the bytes (DROP: and the column terms' warp)
      mbar_init(&full[s], DROP ? 33 : 1);
      mbar_init(&empty[s], 4 * NWG);  // every consumer warp, after its products read the tiles
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 4 * NWG);  // every consumer warp, after its last S of the piece
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int* ent = tile_map + 3 + n_x;  // the units' tiles, by (b, h) group

  if (warp >= 4 * NWG) {
    // The producer warpgroup: one thread issues the copies; with DROP the
    // next warp writes each tile's column terms into its stage (once a tile,
    // where every consumer lane would form its own).
    setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    const auto [un, u0, u1, r0, r1] = block_range(tile_map, off_smem, n_x, n_x * H * B);
    if (threadIdx.x == 128 * NWG) {
      prefetch_tensormap(&q_map);
      prefetch_tensormap(&k_map);
      prefetch_tensormap(&v_map);
      int it = 0, pieces = 0;  // tiles streamed through the ring, pieces begun
      for (int r = r0; r <= r1; ++r) {
        const int s0 = un.start(r);
        const int tb = max(u0, s0) - s0, te = min(u1, s0 + un.count(r)) - s0;
        if (te <= tb) continue;  // a row block with no unit
        const int p = pieces++, qb = p & 1;
        const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
        if (p >= 2) mbar_wait(&q_empty[qb], ((p >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qb], Cfg::Q_BYTES);
#pragma unroll
        for (int j = 0; j < I::BOXES; ++j) {
          tma_load_3d(q_img + qb * Cfg::Q_BYTES + j * ROWS * I::W, &q_map, h * D + j * (I::W / 2),
                      x * ROWS, b, &q_full[qb]);
        }
        for (int i = tb; i < te; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          // the unit's entry, tile << 1 | partial, staged before the arrival
          // (which releases it)
          const int unit = ent[s0 - r / n_x * un.per_bh + i], t = unit >> 1;
          ents[s] = unit;
          mbar_arrive_expect_tx(&full[s], 2 * Cfg::TILE + (unit & 1 ? Cfg::WORDS : 0));
          const uint32_t k_dst = ring + s * 2 * Cfg::TILE, v_dst = k_dst + Cfg::TILE;
#pragma unroll
          for (int j = 0; j < I::BOXES; ++j) {
            tma_load_3d(k_dst + j * BK * I::W, &k_map, h * D + j * (I::W / 2), t * BK, b, &full[s]);
            tma_load_3d(v_dst + j * BK * I::W, &v_map, h * D + j * (I::W / 2), t * BK, b, &full[s]);
          }
          if (unit & 1) {
            bulk_load(words + s * Cfg::WORDS / 4,
                      bits + ((size_t)(BK == 128 ? t : t >> 1) * mask_rows(Tq) + x * ROWS) * 4,
                      Cfg::WORDS, &full[s]);
          }
        }
      }
    } else if (DROP && warp == 4 * NWG + 1) {
      for (int u = u0; u < u1; ++u) {  // the block's units in order
        const int it = u - u0, s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const int t = ent[u % un.per_bh] >> 1;
        const uint32_t k = (uint32_t)(t * BK + lane) * 0x85EBCA77u;
#pragma unroll
        for (int q = 0; q < BK / 32; ++q) {
          cols[s * BK + 32 * q + lane] = Dropout::col_term(k + (uint32_t)(32 * q) * 0x85EBCA77u);
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {  // NWG consumer warpgroups of 64 query rows
    setmaxnreg_inc<Cfg::CONSUMER_REGS>();
    const auto [un, u0, u1, r0, r1] = block_range(tile_map, off_smem, n_x, n_x * H * B);
    const int wg = warp / 4, g = lane / 4, c = lane % 4;
    const int rr = wg * ROWS_WG + (warp % 4) * 16 + g;  // the thread's first row in the block
    // The turn to issue products passes round robin between the warpgroups:
    // warpgroup w waits at barrier 1 + w, then opens 1 + (w + 1) % NWG (two
    // warpgroups' threads each); warpgroup 0 opens its own first.
    if (wg == 0) named_bar_arrive(1, 256);
    const int next_bar = 1 + (wg + 1) % NWG;
    const int C = H * D;
    int it = 0, pieces = 0;
    for (int r = r0; r <= r1; ++r) {
      const int s0 = un.start(r);
      const int tb = max(u0, s0) - s0, te = min(u1, s0 + un.count(r)) - s0;
      const int n = te - tb;
      if (n <= 0) continue;  // a row block with no unit
      const int p = pieces++, qb = p & 1;
      const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
      const int row = x * ROWS + rr;
      const uint32_t q_wg = q_img + qb * Cfg::Q_BYTES + wg * ROWS_WG * I::W;
      uint32_t rt[2];  // the dropout's row terms
      if constexpr (DROP) {
        // the global row: a launch on a piece of a longer call's rows starts at row0
        const uint32_t salt = drop.salt(b * H + h);
        rt[0] = Dropout::row_term(row + drop.row0, salt);
        rt[1] = Dropout::row_term(row + drop.row0 + 8, salt);
      }

      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float s[BK / 2];
      uint32_t pa[BK / 16][4], w[2];

      // A tile's unit (tile << 1 | partial) and, for a partial one, its mask
      // words come from its stage in shared memory; a full tile takes no
      // test (bits past Tk are 0: no test of the keys' range).
      mbar_wait(&q_full[qb], (p >> 1) & 1);
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      named_bar_sync(1 + wg, 256);
      score_issue<D, BK>(s, q_wg, ROWS * I::W, ring + (it % STAGES) * 2 * Cfg::TILE);
      named_bar_arrive(next_bar, 256);
      wgmma_wait<0>();
      fence_all(s);
      if (const int unit = ents[it % STAGES]; unit & 1) {
        load_words<BK>(w, words + (it % STAGES) * Cfg::WORDS / 4, rr, c, unit >> 1);
        keep_bits<BK>(s, w);
      }
      softmax_tile<BK>(s, m, l, alpha, scale);
      if constexpr (DROP) drop_tile<BK>(s, drop, rt, cols + (it % STAGES) * BK + 2 * c);
      pack_p<BK>(pa, s);
      for (int i = 1; i < n; ++i) {
        const int j = it + i, st = j % STAGES, prev = (j - 1) % STAGES;
        mbar_wait(&full[st], (j / STAGES) & 1);
        named_bar_sync(1 + wg, 256);
        score_issue<D, BK>(s, q_wg, ROWS * I::W, ring + st * 2 * Cfg::TILE);
        value_issue<D, BK>(acc, pa, ring + prev * 2 * Cfg::TILE + Cfg::TILE);
        named_bar_arrive(next_bar, 256);
        wgmma_wait<1>();  // this tile's S; the previous tile's P V still runs
        fence_all(s);
        if (const int unit = ents[st]; unit & 1) {
          load_words<BK>(w, words + st * Cfg::WORDS / 4, rr, c, unit >> 1);
          keep_bits<BK>(s, w);
        }
        softmax_tile<BK>(s, m, l, alpha, scale);
        if constexpr (DROP) drop_tile<BK>(s, drop, rt, cols + st * BK + 2 * c);
        wgmma_wait<0>();
        fence_all(acc);
        fence_all(pa);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
        pack_p<BK>(pa, s);
      }
      if (lane == 0) mbar_arrive(&q_empty[qb]);  // every S of the piece is done
      const int last = (it + n - 1) % STAGES;
      named_bar_sync(1 + wg, 256);
      value_issue<D, BK>(acc, pa, ring + last * 2 * Cfg::TILE + Cfg::TILE);
      named_bar_arrive(next_bar, 256);
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(pa);
      if (lane == 0) mbar_arrive(&empty[last]);
      it += n;

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // the row sums over the row's four lanes
        l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 1);
        l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 2);
      }
      if (tb == 0 && te == un.count(r)) {  // a whole row block: o = acc / l
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = row + 8 * hf;
          if (r >= Tq) continue;
          store_o<D>(o + ((size_t)b * Tq + r) * C + h * D + 2 * c, acc, hf, l[hf],
                     DROP ? drop.scale : 1.f);
          if (lse != nullptr && c == 0) {
            lse[((size_t)b * H + h) * Tq + r] = m[hf] * scale + log2f(l[hf]);
          }
        }
        continue;
      }
      // a partial piece: unnormalised, to its scratch slot (the block's first
      // piece lies in its first row block)
      float* mine = part + (size_t)(p == 0 ? 2 * blockIdx.x : 2 * blockIdx.x + 1) * SLOT;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* dst = mine + (rr + 8 * hf) * D + 2 * c;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<float2*>(dst + 8 * jj) =
              make_float2(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
        }
        if (c == 0) {
          *reinterpret_cast<float2*>(mine + ROWS * D + (rr + 8 * hf) * 2) =
              make_float2(m[hf] == -INFINITY ? -INFINITY : m[hf] * scale, l[hf]);
        }
      }
    }
    fill_empty<D, ROWS>(ent + un.per_bh, tile_map[1], o, lse, B, Tq, H, threadIdx.x, NWG * 128);
  }
}

// Merges the partial pieces of each row block that two or more ranges of
// the schedule share: per row, M = the max of the pieces' scaled maxima, w =
// 2^(M_piece - M) (base 0 where every M is -inf: 0 / 0 = NaN, as a fully
// masked row gives), o = keep_scale sum w o_piece / sum w l_piece, rounded to
// bf16 (keep_scale: the dropout's 1 / (1 - rate), or 1).
// Grid (G - 1, ceil(ROWS D / (2 ITEMS 256))): blockIdx.x + 1 is a range
// boundary c; the first boundary inside a row block merges it (the others
// return). A thread takes ITEMS (row, channel pair) items and issues the
// loads of all their pieces before it waits on any. The thread of a row's
// first pair also writes its log-sum-exp, base + log2 l, where lse is given.
// MASKED: the ranges cut the units of the tile map (tile_map, for the plan;
// launch_schedule), else every row block's n_tiles tiles.
constexpr int COMBINE_ITEMS = 4;

template <int D, int ROWS, bool MASKED>
__global__ void __launch_bounds__(256)
flash_mha_bf16_combine_kernel(const float* __restrict__ part, const int* __restrict__ tile_map,
                              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
                              int Tq, int H, int n_tiles, int G, float keep_scale) {
  constexpr int SLOT = ROWS * (D + 2), PAIRS = ROWS * (D / 2), N = COMBINE_ITEMS;
  const int n_x = (Tq + ROWS - 1) / ROWS;
  const auto sched = launch_schedule<MASKED>(tile_map, n_x, n_x * H * B, n_tiles, G);
  const int c = blockIdx.x + 1, start = sched.lo(c), r = sched.row_of(start), s0 = sched.start(r);
  if (start == s0 || sched.lo(c - 1) > s0) return;
  const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
  // range c - 1's piece is its last (slot 2c - 1) unless it starts at this
  // row block's first unit; every later range starts in the row block (slot 2c')
  const int c0 = c - 1, c1 = sched.range_of(s0 + sched.count(r) - 1);
  const float* first = part + (size_t)(sched.lo(c0) == s0 ? 2 * c0 : 2 * c0 + 1) * SLOT;
  int rr[N], pair[N];
  float top[N], l[N], base[N];
  float2 v[N], ml[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {  // items i: consecutive blocks of 256 (row, pair)s
    const int idx = min(((int)blockIdx.y * N + i) * (int)blockDim.x + (int)threadIdx.x, PAIRS - 1);
    rr[i] = idx / (D / 2);
    pair[i] = idx % (D / 2);
    ml[i] = __ldcg(reinterpret_cast<const float2*>(first + ROWS * D + rr[i] * 2));
    v[i] = __ldcg(reinterpret_cast<const float2*>(first + rr[i] * D + 2 * pair[i]));
    top[i] = ml[i].x;
  }
  for (int cc = c0 + 1; cc <= c1; ++cc) {  // usually one more piece
    const float* piece = part + (size_t)(2 * cc) * SLOT;
    float2 mlc[N], vc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mlc[i] = __ldcg(reinterpret_cast<const float2*>(piece + ROWS * D + rr[i] * 2));
      vc[i] = __ldcg(reinterpret_cast<const float2*>(piece + rr[i] * D + 2 * pair[i]));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {  // rescale the running sums to the new max
      const float t = fmaxf(top[i], mlc[i].x);
      base[i] = t == -INFINITY ? 0.f : t;
      const float w0 = ex2((cc == c0 + 1 ? ml[i].x : top[i]) - base[i]);
      const float w = ex2(mlc[i].x - base[i]);
      const float l0 = cc == c0 + 1 ? ml[i].y : l[i];
      l[i] = fmaf(w, mlc[i].y, w0 * l0);
      v[i] = make_float2(fmaf(w, vc[i].x, w0 * v[i].x), fmaf(w, vc[i].y, w0 * v[i].y));
      top[i] = t;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = ((int)blockIdx.y * N + i) * (int)blockDim.x + (int)threadIdx.x;
    const int row = x * ROWS + rr[i];
    if (idx < PAIRS && row < Tq) {
      *reinterpret_cast<uint32_t*>(o + ((size_t)b * Tq + row) * H * D + h * D + 2 * pair[i]) =
          pack_bf16(v[i].x * keep_scale / l[i], v[i].y * keep_scale / l[i]);
      if (lse != nullptr && pair[i] == 0) {
        lse[((size_t)b * H + h) * Tq + row] = base[i] + log2f(l[i]);
      }
    }
  }
}

// Bring-up: one S tile (64 x BK) and one P V tile alone, for one warpgroup,
// through the kernel's copies (tensor maps), image, descriptors and fragment
// maps. q (64, D), k and v (BK, D) bf16, p (64, BK) fp32 -> s_out = Q K^T
// (64, BK) and o_out = bf16(P) V (64, D), fp32.
template <int D, int BK>
__global__ void __launch_bounds__(128)
flash_mha_bf16_tiles_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, const float* p,
                            float* s_out, float* o_out) {
  using I = HeadImage<D>;
  constexpr uint32_t Q_BYTES = ROWS_WG * D * 2, TILE = BK * D * 2;
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  unsigned char* base = bf16_smem + ((1024 - (smem_addr(bf16_smem) & 1023)) & 1023);
  const uint32_t q_img = smem_addr(base), k_img = q_img + Q_BYTES, v_img = k_img + TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + Q_BYTES + 2 * TILE);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, Q_BYTES + 2 * TILE);
    for (int j = 0; j < I::BOXES; ++j) {
      tma_load_3d(q_img + j * ROWS_WG * I::W, &q_map, j * (I::W / 2), 0, 0, bar);
      tma_load_3d(k_img + j * BK * I::W, &k_map, j * (I::W / 2), 0, 0, bar);
      tma_load_3d(v_img + j * BK * I::W, &v_map, j * (I::W / 2), 0, 0, bar);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int row = warp * 16 + g;
  float s[BK / 2];
  score_issue<D, BK>(s, q_img, ROWS_WG * I::W, k_img);
  wgmma_wait<0>();
  fence_all(s);
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = row + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * c + (e & 1);
    s_out[r * BK + col] = s[e];
    s[e] = p[r * BK + col];
  }
  uint32_t pa[BK / 16][4];
  pack_p<BK>(pa, s);
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  value_issue<D, BK>(acc, pa, v_img);
  wgmma_wait<0>();
  fence_all(acc);
  fence_all(pa);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    o_out[(row + 8 * ((e >> 1) & 1)) * D + 8 * (e >> 2) + 2 * c + (e & 1)] = acc[e];
  }
}

// ---- host side of the bf16 route ----

using bf16 = __nv_bfloat16;

template <int D, int BK, int NWG, bool MASKED>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const int* tile_map,
                const uint32_t* bits, bf16* o, float* part, float* lse, int B, int Tq, int Tk,
                int H, float scale, int ctas, Dropout drop, cudaStream_t stream) {
  using Cfg = Bf16Cfg<D, BK, NWG>;
  const int C = H * D, n_x = (Tq + Cfg::ROWS - 1) / Cfg::ROWS, n_tiles = (Tk + BK - 1) / BK;
  const long long R = (long long)n_x * H * B;
  if (ctas < 1 || ctas > R * n_tiles || R * n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bool pieces = false;  // does a range start inside a row block?
  if constexpr (!MASKED) {
    const Schedule sched((int)R, n_tiles, ctas);
    for (int c = 1; c < ctas && !pieces; ++c) pieces = sched.lo(c) % n_tiles != 0;
    if (pieces && part == nullptr) return (int)cudaErrorInvalidValue;
  } else {
    // the map lives on the card: the caller, which holds its host copy, says
    // whether ranges split row blocks by passing part (kernels/attention.py)
    if (bits == nullptr || n_x >= OFF_SMEM) return (int)cudaErrorInvalidValue;
    pieces = part != nullptr && ctas != R;
  }
  CUtensorMap qm, km, vm;
  int err = tensor_map::head_map<D, 2>(&qm, q, B, Tq, C, Cfg::ROWS);
  if (err == 0) err = tensor_map::head_map<D, 2>(&km, k, B, Tk, C, BK);
  if (err == 0) err = tensor_map::head_map<D, 2>(&vm, v, B, Tk, C, BK);
  if (err != 0) return err;
  const bool dropping = drop.rate > 0.f;
  cudaError_t e;
  if constexpr (MASKED) {
    auto kernel = flash_mha_bf16_masked_kernel<D, BK, NWG, false>;
    size_t smem = Bf16Cfg<D, BK, NWG, false, true>::SMEM_LAUNCH;
    if (dropping) {  // the dropout instances
      kernel = flash_mha_bf16_masked_kernel<D, BK, NWG, true>;
      smem = Bf16Cfg<D, BK, NWG, true, true>::SMEM_LAUNCH;
    }
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<ctas, Cfg::THREADS, smem, stream>>>(qm, km, vm, tile_map, bits, o, part, lse, B, Tq,
                                                 Tk, H, scale, drop);
  } else {
    auto kernel = flash_mha_bf16_kernel<D, BK, NWG, false>;
    size_t smem = Cfg::SMEM_LAUNCH;
    if (dropping) {
      kernel = flash_mha_bf16_kernel<D, BK, NWG, true>;
      smem = Bf16Cfg<D, BK, NWG, true>::SMEM_LAUNCH;
    }
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<ctas, Cfg::THREADS, smem, stream>>>(qm, km, vm, nullptr, o, part, lse, B, Tq, Tk, H,
                                                 scale, drop);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || !pieces) return (int)e;
  constexpr int PER_BLOCK = COMBINE_ITEMS * 256, PAIRS = Cfg::ROWS * (D / 2);
  const dim3 grid(ctas - 1, (PAIRS + PER_BLOCK - 1) / PER_BLOCK);
  auto combine = flash_mha_bf16_combine_kernel<D, Cfg::ROWS, MASKED>;
  combine<<<grid, 256, 0, stream>>>(part, tile_map, o, lse, B, Tq, H, n_tiles, ctas, drop.scale);
  return (int)cudaGetLastError();
}

template <int D, bool MASKED>
int dispatch_bf16(int key_tile, int block_rows, const bf16* q, const bf16* k, const bf16* v,
                  const int* tile_map, const uint32_t* bits, bf16* o, float* part, float* lse,
                  int B, int Tq, int Tk, int H, float scale, int ctas, Dropout drop,
                  cudaStream_t s) {
  if constexpr (D == 128) {
    // 64 keys, 128 rows: the plan whose ring of 4 stages fits beside the two
    // Q images (193 KiB; 128 keys would need 321)
    if (key_tile == 64 && block_rows == 128)
      return launch_bf16<D, 64, 2, MASKED>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                           scale, ctas, drop, s);
    return (int)cudaErrorInvalidValue;
  } else {
    if (key_tile == 64 && block_rows == 128)
      return launch_bf16<D, 64, 2, MASKED>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                           scale, ctas, drop, s);
    if (key_tile == 64 && block_rows == 192)
      return launch_bf16<D, 64, 3, MASKED>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                           scale, ctas, drop, s);
    if (key_tile == 128 && block_rows == 128)
      return launch_bf16<D, 128, 2, MASKED>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                            scale, ctas, drop, s);
    if (key_tile == 128 && block_rows == 192)
      return launch_bf16<D, 128, 3, MASKED>(q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                            scale, ctas, drop, s);
    return (int)cudaErrorInvalidValue;
  }
}

// The fp32 route's launch at head dim D, unmasked or MASKED (flash_mha_f32).
template <bool MASKED>
int run_f32(const float* q, const float* k, const float* v, const int* tile_map,
            const unsigned int* bits, float* image, float* o, float* lse, int B, int Tq, int Tk,
            int H, int D, float q_scale, int block_rows, Dropout drop, cudaStream_t s) {
  switch (D) {
    case 32:
      return (int)launch_rows<32, MASKED>(block_rows, q, k, v, tile_map, bits, image, o, lse, B,
                                          Tq, Tk, H, q_scale, drop, s);
    case 48:
      return (int)launch_rows<48, MASKED>(block_rows, q, k, v, tile_map, bits, image, o, lse, B,
                                          Tq, Tk, H, q_scale, drop, s);
    case 64:
      return (int)launch_rows<64, MASKED>(block_rows, q, k, v, tile_map, bits, image, o, lse, B,
                                          Tq, Tk, H, q_scale, drop, s);
    case 128:
      return flash_mha_f32_d128(MASKED, q, k, v, tile_map, bits, image, o, lse, B, Tq, Tk, H,
                                q_scale, block_rows, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 route's launch at head dim D, unmasked or MASKED (flash_mha_bf16).
template <bool MASKED>
int run_bf16(const bf16* q, const bf16* k, const bf16* v, const int* tile_map,
             const unsigned int* bits, bf16* o, float* part, float* lse, int B, int Tq, int Tk,
             int H, int D, float scale, int key_tile, int block_rows, int ctas, Dropout drop,
             cudaStream_t s) {
  switch (D) {
    case 32:
      return dispatch_bf16<32, MASKED>(key_tile, block_rows, q, k, v, tile_map, bits, o, part,
                                       lse, B, Tq, Tk, H, scale, ctas, drop, s);
    case 48:
      return dispatch_bf16<48, MASKED>(key_tile, block_rows, q, k, v, tile_map, bits, o, part,
                                       lse, B, Tq, Tk, H, scale, ctas, drop, s);
    case 64:
      return dispatch_bf16<64, MASKED>(key_tile, block_rows, q, k, v, tile_map, bits, o, part,
                                       lse, B, Tq, Tk, H, scale, ctas, drop, s);
    case 128:
      return flash_mha_bf16_d128(MASKED, q, k, v, tile_map, bits, o, part, lse, B, Tq, Tk, H,
                                 scale, key_tile, block_rows, ctas, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D, int BK>
int launch_tiles(const bf16* q, const bf16* k, const bf16* v, const float* p, float* s_out,
                 float* o_out, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = tensor_map::head_map<D, 2>(&qm, q, 1, ROWS_WG, D, ROWS_WG);
  if (err == 0) err = tensor_map::head_map<D, 2>(&km, k, 1, BK, D, BK);
  if (err == 0) err = tensor_map::head_map<D, 2>(&vm, v, 1, BK, D, BK);
  if (err != 0) return err;
  constexpr int smem = 1024 + (ROWS_WG + 2 * BK) * D * 2 + 8;
  auto kernel = flash_mha_bf16_tiles_kernel<D, BK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, 128, smem, stream>>>(qm, km, vm, p, s_out, o_out);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_tiles(int key_tile, const bf16* q, const bf16* k, const bf16* v, const float* p,
                   float* s_out, float* o_out, cudaStream_t s) {
  if (key_tile == 64) return launch_tiles<D, 64>(q, k, v, p, s_out, o_out, s);
  if (key_tile == 128) return launch_tiles<D, 128>(q, k, v, p, s_out, o_out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The masked launches, defined in flash_mha_masked.cu (run_f32<true>,
// run_bf16<true>): the C entries call them when given a tile map.
int flash_mha_f32_masked(const float* q, const float* k, const float* v, const int* tile_map,
                         const unsigned int* bits, float* image, float* o, float* lse, int B,
                         int Tq, int Tk, int H, int D, float q_scale, int block_rows,
                         Dropout drop, cudaStream_t s);
int flash_mha_bf16_masked(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* tile_map, const unsigned int* bits,
                          __nv_bfloat16* o, float* part, float* lse, int B, int Tq, int Tk,
                          int H, int D, float scale, int key_tile, int block_rows, int ctas,
                          Dropout drop, cudaStream_t s);
