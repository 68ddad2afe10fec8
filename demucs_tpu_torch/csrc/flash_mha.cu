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
// heads are read in place at column h*D. An optional keep-mask (Tq, Tk) of
// bytes is shared by batch and heads: masked scores are -inf, and the rescale
// is -inf-safe as in the Pallas kernel, so a row with no kept key gives
// 0 / 0 = NaN, as the plain softmax over all -inf does.
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
//   (64 or 128 query rows per block).
// - Train-time dropout on the attention probabilities, the Pallas kernel's
//   own (attention_dropout.cuh): a counter hash of (global query row, key,
//   seed + batch-head salt), so the pattern does not depend on the tiles.
//   The row sum l takes p before the drop, o the dropped p / (1 - rate).
//   Where the caller asks, each row's log-sum-exp (base 2, of the scaled
//   scores: m + log2 l) goes to `lse` for the backward (flash_mha_bwd.cu).

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_dropout.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;       // keys per tile
constexpr int ROWS_WG = 64;  // query rows per consumer warpgroup
constexpr int STAGES = 2;     // K/V tiles in flight per block (3 is no faster on the H100)
constexpr unsigned FULL_MASK = 0xffffffffu;

// Float offset of (key j, channel c) in a tile's K part: core matrices of
// 8 keys x 4 channels, those of one group of 8 keys side by side.
template <int D>
__host__ __device__ constexpr int k_offset(int j, int c) {
  return ((j >> 3) * (D / 4) + (c >> 2)) * 32 + (j & 7) * 4 + (c & 3);
}

// Float offset of (key j, channel c) in a tile's V^T part: core matrices of
// 8 channels x 4 k-positions, those of one group of 8 channels side by side;
// key j sits at k-position 8 (j / 8) + (j % 8) / 2 + 4 (j % 2).
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

// o = P V of one tile for one warpgroup, 3xTF32; p holds P in the S
// accumulator layout.
template <int D>
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

// The float4 walk of kv_image_kernel over a tile's image: float4 f of a
// part is row f % 8 of core matrix f / 8. True if each value lands where
// k_offset and v_offset (the layout the descriptors describe) put it.
template <int D>
constexpr bool image_walk_matches_offsets() {
  for (int f = 0; f < BK * D / 4; ++f) {
    const int cm = f >> 3, r = f & 7, kc = cm % (BK / 4);
    for (int e = 0; e < 4; ++e) {
      if (k_offset<D>(8 * (cm / (D / 4)) + r, 4 * (cm % (D / 4)) + e) != 4 * f + e) return false;
      if (v_offset(8 * (kc >> 1) + (kc & 1) + 2 * e, 8 * (cm / (BK / 4)) + r) != 4 * f + e) {
        return false;
      }
    }
  }
  return true;
}
static_assert(image_walk_matches_offsets<32>() && image_walk_matches_offsets<48>() &&
                  image_walk_matches_offsets<64>(),
              "kv_image_kernel's walk disagrees with the image layout");

// hi and lo parts of four values (see tf32_hi).
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// k, v (B, Tk, H*D) -> image (B, H, n_tiles, 4, BK * D): per tile K hi, K lo,
// V^T hi, V^T lo at k_offset / v_offset, zero past Tk. Grid (n_tiles, H, B).
// The tile's rows of k and v go through shared memory, so that both the
// reads and the writes are whole float4s of consecutive addresses.
template <int D>
__global__ void __launch_bounds__(256)
kv_image_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ image, int Tk, int H) {
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
    // V^T: channel 8 (cm / 16) + r, k-positions 4 kc + 0..3 of core column
    // kc = cm % 16, which are keys j0, j0 + 2, j0 + 4, j0 + 6
    const int ch = 8 * (cm / (BK / 4)) + r, kc = cm % (BK / 4);
    const int j0 = 8 * (kc >> 1) + (kc & 1);
    split4(make_float4(vs[j0 * LD + ch], vs[(j0 + 2) * LD + ch], vs[(j0 + 4) * LD + ch],
                       vs[(j0 + 6) * LD + ch]),
           hi, lo);
    dst[2 * N4 + f] = hi;
    dst[3 * N4 + f] = lo;
  }
}

// The consumer warpgroups of flash_mha_kernel.
template <int D, int NWG>
__device__ __forceinline__ void consume(const float* __restrict__ q, const float* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const unsigned char* __restrict__ mask,
                                        float* __restrict__ o, float* __restrict__ lse,
                                        int Tq, int Tk, int H, float q_scale, Dropout drop) {
  constexpr int TILE = BK * D;
  const int b = blockIdx.z, h = blockIdx.y;
  const int n_tiles = (Tk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A consumer warp: rows `row` and `row + 8` of its 16, columns 2c, 2c + 1
  // of each group of 8 in the accumulators.
  const int g = lane / 4, c = lane % 4;
  const int row = blockIdx.x * (ROWS_WG * NWG) + warp * 16 + g;
  const int C = H * D;
  uint32_t qhi[D / 8][4], qlo[D / 8][4];
  {
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
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const float* tile = ring + st * 4 * TILE;
    float s[BK / 2];
    score_tile<D>(s, qhi, qlo, tile, tile + TILE);

    const int k0 = i * BK;
    if (mask != nullptr || k0 + BK > Tk) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const int r = row + 8 * ((e >> 1) & 1);
        bool keep = key < Tk;
        if (keep && mask != nullptr && r < Tq) keep = mask[(size_t)r * Tk + key] != 0;
        if (!keep) s[e] = -INFINITY;
      }
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
    value_tile<D>(pv, s, tile + 2 * TILE, tile + 3 * TILE);
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = fmaf(acc[e], alpha[(e >> 1) & 1], pv[e]);
  }

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

template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_mha_kernel(const float* __restrict__ q, const float* __restrict__ image,
                 const unsigned char* __restrict__ mask, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float q_scale, Dropout drop) {
  constexpr int TILE = BK * D;  // floats of one part of a tile's image
  constexpr uint32_t STAGE_BYTES = 4 * TILE * sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const int n_tiles = (Tk + BK - 1) / BK;
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
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        bulk_load(ring + s * 4 * TILE, src + (size_t)i * 4 * TILE, STAGE_BYTES, &full[s]);
      }
    }
  } else {
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    consume<D, NWG>(q, ring, full, empty, mask, o, lse, Tq, Tk, H, q_scale, drop);
  }
}

template <int D>
constexpr size_t SMEM_BYTES = STAGES * 4 * BK * D * sizeof(float) + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM_BYTES<64> <= 227 * 1024, "the ring exceeds a block's shared memory");

template <int D, int NWG>
cudaError_t launch(const float* q, const float* k, const float* v, const unsigned char* mask,
                   float* image, float* o, float* lse, int B, int Tq, int Tk, int H,
                   float q_scale, Dropout drop, cudaStream_t stream) {
  const int n_tiles = (Tk + BK - 1) / BK;
  kv_image_kernel<D><<<dim3(n_tiles, H, B), 256, 0, stream>>>(k, v, image, Tk, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = SMEM_BYTES<D>;
  err = cudaFuncSetAttribute(flash_mha_kernel<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = ROWS_WG * NWG;
  flash_mha_kernel<D, NWG><<<dim3((Tq + rows - 1) / rows, H, B), (NWG + 1) * 128, smem, stream>>>(
      q, image, mask, o, lse, Tq, Tk, H, q_scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(int block_rows, const float* q, const float* k, const float* v,
                        const unsigned char* mask, float* image, float* o, float* lse, int B,
                        int Tq, int Tk, int H, float q_scale, Dropout drop,
                        cudaStream_t stream) {
  return block_rows == 64
             ? launch<D, 1>(q, k, v, mask, image, o, lse, B, Tq, Tk, H, q_scale, drop, stream)
             : launch<D, 2>(q, k, v, mask, image, o, lse, B, Tq, Tk, H, q_scale, drop, stream);
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
// Shared memory: a head's slice of a row is W bytes (W = 128 at D = 64, 64 at
// D = 32, and 32 at D = 48 in three boxes of 16 channels), swizzled at W by
// the tensor map and read by wgmma through descriptors of the same swizzle:
// K-major for Q and K (S = Q K^T, both operands from shared memory), and
// V MN-major with the transpose bit (O = P V, keys the reduction). P goes
// from the S accumulator to the A fragment by pairwise packing (MmaBf16).
// A fully masked row keeps l == 0 and gives 0 / 0 = NaN, as in the fp32 route.
//
// Training, as on the fp32 route: the Pallas kernel's hashed dropout of the
// probabilities (attention_dropout.cuh: global query row, key and batch-head
// salt, so every plan and schedule drops the same scores), applied to the
// unnormalised P after the row sum has taken it, before P is packed for
// P V; at rate 0 no hash runs. Where the caller asks, each row's
// log-sum-exp (base 2, of the scaled scores: m scale + log2 l) goes to `lse`
// for the backward (flash_mha_bwd.cu): from the store of a whole row block,
// or from flash_mha_bf16_combine_kernel for a merged one.
// ===========================================================================

// The shared-memory image of a head slice: rows of W bytes, BOXES boxes of
// W / 2 channels side by side, wgmma's layout type for W.
template <int D>
struct HeadImage {
  static constexpr int W = (2 * D) % 128 == 0 ? 128 : (2 * D) % 64 == 0 ? 64 : 32;
  static constexpr int BOXES = 2 * D / W;
  static constexpr uint64_t LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;
};

template <int D, int BK, int NWG>
struct Bf16Cfg {
  static constexpr int ROWS = ROWS_WG * NWG;     // query rows per block
  static constexpr uint32_t TILE = BK * D * 2;   // bytes of one K or V tile
  static constexpr uint32_t Q_BYTES = ROWS * D * 2;
  static constexpr int STAGES = 4;               // K/V tile pairs in the ring
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int PRODUCER_REGS = NWG == 2 ? 24 : 32;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * TILE + (2 * STAGES + 4) * 8;
  // Over half the SM's shared memory: one block per SM, so that the
  // consumers' setmaxnreg.inc finds the registers the producer gave up.
  static constexpr size_t SMEM_LAUNCH = SMEM > 118 * 1024 ? SMEM : 118 * 1024;
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

// Sets the scores of dropped keys (past Tk, or masked) to -inf. Lane (g, c)
// of a warp holds rows `row` and `row + 8`, columns 8 j + 2c and 8 j + 2c + 1.
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

// The dropout of one tile of P (after its row sums): lane (g, c) holds rows
// `row` and `row + 8` (global query rows), keys k0 + 8 j + 2c and + 1.
template <int BK>
__device__ __forceinline__ void drop_tile(float (&p)[BK / 2], const Dropout& drop, uint32_t salt,
                                          int k0, int row, int c) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
    p[e] = drop.keep(row + 8 * ((e >> 1) & 1), key, salt) ? p[e] * drop.scale : 0.f;
  }
}

// Row `row + 8 hf` of a thread's accumulator (columns 8 j + 2c, + 1), divided
// by its row sum, to bf16 at dst (that row's columns h D + 2c). 0 / 0 = NaN
// for a row with no kept key.
template <int D>
__device__ __forceinline__ void store_o(__nv_bfloat16* dst, const float (&v)[D / 2], int hf,
                                        float l) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + 8 * j) =
        pack_bf16(v[4 * j + 2 * hf] / l, v[4 * j + 2 * hf + 1] / l);
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
};

// Grid (G): range blockIdx.x of the schedule. A scratch slot holds ROWS x D
// of unnormalised o, then ROWS x (the scaled row max, the row sum), fp32.
// lse: null, or (B H, Tq) fp32.
template <int D, int BK, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_mha_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ part, float* __restrict__ lse, int B, int Tq, int Tk,
                      int H, float scale, Dropout drop) {
  using Cfg = Bf16Cfg<D, BK, NWG>;
  using I = HeadImage<D>;
  constexpr int STAGES = Cfg::STAGES, ROWS = Cfg::ROWS, SLOT = ROWS * (D + 2);
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  // two Q images, then the ring (stage s: K tile, V tile), then the
  // barriers; every image 1024-byte aligned (the swizzle atoms' alignment).
  unsigned char* base = bf16_smem + ((1024 - (smem_addr(bf16_smem) & 1023)) & 1023);
  const uint32_t q_img = smem_addr(base), ring = q_img + 2 * Cfg::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * Cfg::Q_BYTES + STAGES * 2 * Cfg::TILE);
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
      mbar_init(&full[s], 1);          // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 4 * NWG);  // every consumer warp, after its products read the tiles
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 4 * NWG);  // every consumer warp, after its last S of the piece
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues the copies
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
      const uint32_t salt = drop.salt(b * H + h);

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
      if (drop.rate > 0.f) drop_tile<BK>(s, drop, salt, tb * BK, row, c);
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
        if (drop.rate > 0.f) drop_tile<BK>(s, drop, salt, k0, row, c);
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
          store_o<D>(o + ((size_t)b * Tq + r) * C + h * D + 2 * c, acc, hf, l[hf]);
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

// Merges the partial pieces of each row block that two or more ranges of
// the schedule share: per row, M = the max of the pieces' scaled maxima, w =
// 2^(M_piece - M) (base 0 where every M is -inf: 0 / 0 = NaN, as a fully
// masked row gives), o = sum w o_piece / sum w l_piece, rounded to bf16.
// Grid (G - 1, ceil(ROWS D / (2 ITEMS 256))): blockIdx.x + 1 is a range
// boundary c; the first boundary inside a row block merges it (the others
// return). A thread takes ITEMS (row, channel pair) items and issues the
// loads of all their pieces before it waits on any. The thread of a row's
// first pair also writes its log-sum-exp, base + log2 l, where lse is given.
constexpr int COMBINE_ITEMS = 4;

template <int D, int ROWS>
__global__ void __launch_bounds__(256)
flash_mha_bf16_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int B, int Tq, int H, int n_tiles, int G) {
  constexpr int SLOT = ROWS * (D + 2), PAIRS = ROWS * (D / 2), N = COMBINE_ITEMS;
  const int n_x = (Tq + ROWS - 1) / ROWS;
  const Schedule sched(n_x * H * B, n_tiles, G);
  const int c = blockIdx.x + 1, start = sched.lo(c), r = start / n_tiles;
  if (start % n_tiles == 0 || sched.lo(c - 1) > r * n_tiles) return;
  const int x = r % n_x, h = r / n_x % H, b = r / (n_x * H);
  // range c - 1's piece is its last (slot 2c - 1) unless it starts at this
  // row block's first tile; every later range starts in the row block (slot 2c')
  const int c0 = c - 1, c1 = sched.range_of((r + 1) * n_tiles - 1);
  const float* first = part + (size_t)(sched.lo(c0) == r * n_tiles ? 2 * c0 : 2 * c0 + 1) * SLOT;
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
          pack_bf16(v[i].x / l[i], v[i].y / l[i]);
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

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The tensor map of x (B, T, C) bf16 as the 3-D tensor (C, T, B), innermost
// first: boxes of W / 2 channels x `rows` rows x 1 item, swizzled at W,
// zero-filled outside the tensor.
template <int D>
int head_map(CUtensorMap* map, const void* x, int B, int T, int C, int rows) {
  using I = HeadImage<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {I::W / 2, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = I::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : I::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

using bf16 = __nv_bfloat16;

template <int D, int BK, int NWG>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask, bf16* o,
                float* part, float* lse, int B, int Tq, int Tk, int H, float scale, int ctas,
                Dropout drop, cudaStream_t stream) {
  using Cfg = Bf16Cfg<D, BK, NWG>;
  const int C = H * D, n_tiles = (Tk + BK - 1) / BK;
  const long long R = (long long)((Tq + Cfg::ROWS - 1) / Cfg::ROWS) * H * B;
  if (ctas < 1 || ctas > R * n_tiles || R * n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Schedule sched((int)R, n_tiles, ctas);
  bool pieces = false;  // does a range start inside a row block?
  for (int c = 1; c < ctas && !pieces; ++c) pieces = sched.lo(c) % n_tiles != 0;
  if (pieces && part == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = head_map<D>(&qm, q, B, Tq, C, Cfg::ROWS);
  if (err == 0) err = head_map<D>(&km, k, B, Tk, C, BK);
  if (err == 0) err = head_map<D>(&vm, v, B, Tk, C, BK);
  if (err != 0) return err;
  auto kernel = flash_mha_bf16_kernel<D, BK, NWG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Cfg::SMEM_LAUNCH);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, Cfg::THREADS, Cfg::SMEM_LAUNCH, stream>>>(qm, km, vm, mask, o, part, lse, B, Tq,
                                                           Tk, H, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || !pieces) return (int)e;
  constexpr int PER_BLOCK = COMBINE_ITEMS * 256, PAIRS = Cfg::ROWS * (D / 2);
  flash_mha_bf16_combine_kernel<D, Cfg::ROWS>
      <<<dim3(ctas - 1, (PAIRS + PER_BLOCK - 1) / PER_BLOCK), 256, 0, stream>>>(
          part, o, lse, B, Tq, H, n_tiles, ctas);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_bf16(int key_tile, int block_rows, const bf16* q, const bf16* k, const bf16* v,
                  const unsigned char* mask, bf16* o, float* part, float* lse, int B, int Tq,
                  int Tk, int H, float scale, int ctas, Dropout drop, cudaStream_t s) {
  if (key_tile == 64 && block_rows == 128)
    return launch_bf16<D, 64, 2>(q, k, v, mask, o, part, lse, B, Tq, Tk, H, scale, ctas, drop, s);
  if (key_tile == 64 && block_rows == 192)
    return launch_bf16<D, 64, 3>(q, k, v, mask, o, part, lse, B, Tq, Tk, H, scale, ctas, drop, s);
  if (key_tile == 128 && block_rows == 128)
    return launch_bf16<D, 128, 2>(q, k, v, mask, o, part, lse, B, Tq, Tk, H, scale, ctas, drop,
                                  s);
  if (key_tile == 128 && block_rows == 192)
    return launch_bf16<D, 128, 3>(q, k, v, mask, o, part, lse, B, Tq, Tk, H, scale, ctas, drop,
                                  s);
  return (int)cudaErrorInvalidValue;
}

template <int D, int BK>
int launch_tiles(const bf16* q, const bf16* k, const bf16* v, const float* p, float* s_out,
                 float* o_out, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = head_map<D>(&qm, q, 1, ROWS_WG, D, ROWS_WG);
  if (err == 0) err = head_map<D>(&km, k, 1, BK, D, BK);
  if (err == 0) err = head_map<D>(&vm, v, 1, BK, D, BK);
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

extern "C" {

// q (B, Tq, H*D), k/v (B, Tk, H*D), mask (Tq, Tk) bytes or null -> o (B, Tq, H*D).
// image: scratch of B * H * ceil(Tk / 64) * 4 * 64 * D floats. q_scale =
// log2(e) / sqrt(D); block_rows 64 or 128 query rows per block. lse: null, or
// (B * H, Tq) floats for each row's base-2 log-sum-exp. Dropout of the
// probabilities at `rate` (0: none) under `seed` (attention_dropout.cuh).
int flash_mha_f32(const float* q, const float* k, const float* v, const unsigned char* mask,
                  float* image, float* o, float* lse, int B, int Tq, int Tk, int H, int D,
                  float q_scale, int block_rows, float rate, int seed, void* stream) {
  if (Tk <= 0 || (block_rows != 64 && block_rows != 128)) return (int)cudaErrorInvalidValue;
  if (!(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  switch (D) {
    case 32:
      return (int)launch_rows<32>(block_rows, q, k, v, mask, image, o, lse, B, Tq, Tk, H,
                                  q_scale, drop, s);
    case 48:
      return (int)launch_rows<48>(block_rows, q, k, v, mask, image, o, lse, B, Tq, Tk, H,
                                  q_scale, drop, s);
    case 64:
      return (int)launch_rows<64>(block_rows, q, k, v, mask, image, o, lse, B, Tq, Tk, H,
                                  q_scale, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 route: q (B, Tq, H*D), k/v (B, Tk, H*D), o (B, Tq, H*D), all bf16
// with 16-byte aligned bases; mask as for flash_mha_f32. scale = log2(e) /
// sqrt(D), applied to the fp32 scores. key_tile 64 or 128 keys, block_rows
// 128 or 192 query rows; ctas blocks in the grid, each a range of the
// persistent schedule (Schedule; part: fp32 scratch of 2 ctas block_rows
// (D + 2) floats, which may be null when no range starts inside a row
// block). lse and the dropout's rate and seed as for flash_mha_f32. Returns
// a cudaError_t, or ENCODE_FAILED + the CUresult of a failed tensor-map
// encode.
int flash_mha_bf16(const void* q, const void* k, const void* v, const unsigned char* mask,
                   void* o, float* part, float* lse, int B, int Tq, int Tk, int H, int D,
                   float scale, int key_tile, int block_rows, int ctas, float rate, int seed,
                   void* stream) {
  if (Tk <= 0 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  switch (D) {
    case 32:
      return dispatch_bf16<32>(key_tile, block_rows, qb, kb, vb, mask, ob, part, lse, B, Tq, Tk,
                               H, scale, ctas, drop, s);
    case 48:
      return dispatch_bf16<48>(key_tile, block_rows, qb, kb, vb, mask, ob, part, lse, B, Tq, Tk,
                               H, scale, ctas, drop, s);
    case 64:
      return dispatch_bf16<64>(key_tile, block_rows, qb, kb, vb, mask, ob, part, lse, B, Tq, Tk,
                               H, scale, ctas, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
