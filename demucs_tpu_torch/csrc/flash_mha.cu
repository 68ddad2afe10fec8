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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

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
                                        float* __restrict__ o, int Tq, int Tk, int H,
                                        float q_scale) {
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
                 const unsigned char* __restrict__ mask, float* __restrict__ o, int Tq, int Tk,
                 int H, float q_scale) {
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
    consume<D, NWG>(q, ring, full, empty, mask, o, Tq, Tk, H, q_scale);
  }
}

template <int D>
constexpr size_t SMEM_BYTES = STAGES * 4 * BK * D * sizeof(float) + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM_BYTES<64> <= 227 * 1024, "the ring exceeds a block's shared memory");

template <int D, int NWG>
cudaError_t launch(const float* q, const float* k, const float* v, const unsigned char* mask,
                   float* image, float* o, int B, int Tq, int Tk, int H, float q_scale,
                   cudaStream_t stream) {
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
      q, image, mask, o, Tq, Tk, H, q_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(int block_rows, const float* q, const float* k, const float* v,
                        const unsigned char* mask, float* image, float* o, int B, int Tq,
                        int Tk, int H, float q_scale, cudaStream_t stream) {
  return block_rows == 64
             ? launch<D, 1>(q, k, v, mask, image, o, B, Tq, Tk, H, q_scale, stream)
             : launch<D, 2>(q, k, v, mask, image, o, B, Tq, Tk, H, q_scale, stream);
}

// ===========================================================================
// The bf16 route: q, k, v and o in bf16, every sum and the softmax in fp32.
//
// Bound: operations, 4 Tq Tk D flops per head at the dense bf16 rate (989
// TFLOP/s), one wgmma product each where the fp32 route needs three.
//
// Design (what 16-bit wgmma changes against the fp32 route):
// - No layout pass. A K or V tile of 64 keys sits in shared memory as core
//   matrices of 8 keys x 8 channels (16-byte rows): core matrix (key block
//   rb, channel block cb) at ((rb * D/8) + cb) * 128 bytes. Each 16-byte
//   chunk of a key row lands there by its own cp.async, so the producer
//   warpgroup copies k and v from their (B, Tk, H*D) layout directly (zero
//   past Tk). For S = Q K^T that image is B K-major (channels are the
//   reduction); for O = P V the same image of V is B MN-major (keys are the
//   reduction, channels contiguous), which 16-bit wgmma reads with its
//   transpose bit. No V^T, no hi/lo split, no scratch tensor. The producer
//   closes one cp.async group per tile and announces tile i (its copies
//   landed, a proxy fence, then the full barrier) after issuing tile i + LAG,
//   so LAG + 1 tiles are in flight in a ring of STAGES_BF16 (4 x 16 KB at
//   D = 64).
// - S (64 x 64 per warpgroup) = Q K^T: D/16 wgmma m64n64k16, A = Q from
//   registers (bf16 pairs loaded from global as they are), fp32 accumulator.
//   The softmax scale log2(e)/sqrt(D) multiplies S in fp32: q is never
//   rounded after scaling. Each tile's S, softmax and P V run one after the
//   other in a warpgroup; the block's two consumer warpgroups overlap.
//   (Issuing S of tile i + 1 before the softmax of tile i, into a second set
//   of registers, ran slower on the H100: PERF.md.)
// - P = exp2(S - m) in fp32, packed pairwise to bf16: the accumulator of a
//   16-bit product is the A fragment of the next one (MmaBf16), so P goes to
//   P V with no shuffle and keys stay in their order.
// - O (64 x D) += P V: 4 wgmma m64nDk16 into o itself, rescaled by alpha
//   first (the accumulation's truncation is far below bf16's step).
// - A fully masked row keeps l == 0 and gives 0 / 0 = NaN, as in the fp32
//   route. 128 query rows per block: two consumer warpgroups and one
//   producer warpgroup.
// ===========================================================================

constexpr int ROWS_BF16 = 2 * ROWS_WG;  // query rows per block of the bf16 route
constexpr int STAGES_BF16 = 4;          // K/V tile pairs in the ring
constexpr int LAG_BF16 = 2;             // tiles issued ahead of the one announced

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies keys [key0, key0 + 64) of one head (src = k or v at (b, 0, h*D),
// row stride C) into a tile image at `dst` (shared), 16 bytes per cp.async,
// zero past Tk. The image is walked linearly (thread f writes bytes
// 16 f .. 16 f + 15: no bank conflicts): chunk f is row f % 8 of core matrix
// f / 8, i.e. key 8 (f / 8 / (D/8)) + f % 8, channels 8 ((f / 8) % (D/8)) + 0..7.
template <int D>
__device__ __forceinline__ void copy_tile_bf16(uint32_t dst, const __nv_bfloat16* src, int key0,
                                               int Tk, int C, int tid, int nthreads) {
  constexpr int CHUNKS = BK * D / 8;
  for (int f = tid; f < CHUNKS; f += nthreads) {
    const int cm = f >> 3;
    const int key = key0 + 8 * (cm / (D / 8)) + (f & 7), cb = cm % (D / 8);
    const bool ok = key < Tk;
    cp_async_16(dst + 16 * f, src + (size_t)(ok ? key : 0) * C + 8 * cb, ok ? 16 : 0);
  }
}

// Byte strides of the tile image for wgmma's descriptors: next 8 channels,
// next 8 keys.
template <int D>
struct TileStrides {
  static constexpr uint32_t CHANNELS = 128, KEYS = 16 * D;
};

// Issues S = Q K^T of one tile into s (raw scores, fp32, accumulator layout)
// as one wgmma group; s is valid after a wgmma wait that covers the group.
template <int D>
__device__ __forceinline__ void score_issue_bf16(float (&s)[BK / 2], const uint32_t (&qa)[D / 16][4],
                                                 uint32_t k_tile) {
  // B K-major: LBO = along the reduction (channels), SBO = along N (keys)
  constexpr uint32_t LBO = TileStrides<D>::CHANNELS, SBO = TileStrides<D>::KEYS;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) fence_operand(s[e]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    MmaBf16<BK, 0>::run(s, qa[ks], smem_desc(k_tile + 2 * 128 * ks, LBO, SBO), ks > 0);
  }
  wgmma_commit();
}

// Issues o += P V of one tile as one wgmma group; pa holds P as bf16 A fragments.
template <int D>
__device__ __forceinline__ void value_issue_bf16(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                                 uint32_t v_tile) {
  // B = V MN-major (transposed): LBO along the reduction (keys), SBO along N (channels)
  constexpr uint32_t LBO = TileStrides<D>::KEYS, SBO = TileStrides<D>::CHANNELS;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) fence_operand(o[e]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    MmaBf16<D, 1>::run(o, pa[kk], smem_desc(v_tile + 2 * TileStrides<D>::KEYS * kk, LBO, SBO), 1);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_all(float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(v[e]);
}

template <int D>
__device__ __forceinline__ void load_q_bf16(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* q0,
                                            bool ok0, bool ok1, int C, int c) {
  const __nv_bfloat16* q1 = q0 + (size_t)8 * C;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int col = 16 * ks + 2 * c;
    qa[ks][0] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + col) : 0u;
    qa[ks][1] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + col) : 0u;
    qa[ks][2] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + col + 8) : 0u;
    qa[ks][3] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + col + 8) : 0u;
  }
}

template <int D>
__global__ void __launch_bounds__(3 * 128, 1)
flash_mha_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
                      __nv_bfloat16* __restrict__ o, int Tq, int Tk, int H, float scale) {
  constexpr uint32_t TILE_BYTES = BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES_BF16 * 2 * TILE_BYTES);
  uint64_t* empty = full + STAGES_BF16;
  const uint32_t ring = smem_addr(smem);  // stage s: K tile, then V tile

  const int b = blockIdx.z, h = blockIdx.y, C = H * D;
  const int n_tiles = (Tk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_BF16; ++s) {
      mbar_init(&full[s], 128);   // every producer thread, after its copies landed
      mbar_init(&empty[s], 8);    // every consumer warp, after its products read the tiles
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    const int tid = threadIdx.x - 256;
    const size_t head = (size_t)b * Tk * C + (size_t)h * D;
    for (int i = 0; i < n_tiles + LAG_BF16; ++i) {
      if (i < n_tiles) {
        const int s = i % STAGES_BF16;
        if (i >= STAGES_BF16) mbar_wait(&empty[s], ((i / STAGES_BF16) - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE_BYTES;
        copy_tile_bf16<D>(dst, k + head, i * BK, Tk, C, tid, 128);
        copy_tile_bf16<D>(dst + TILE_BYTES, v + head, i * BK, Tk, C, tid, 128);
      }
      cp_async_commit();  // one group per tile (empty past the last one)
      if (i >= LAG_BF16) {
        // tile i - LAG landed: make the copies visible to wgmma, then announce it
        cp_async_wait_group<LAG_BF16>();
        fence_proxy_async();
        mbar_arrive(&full[(i - LAG_BF16) % STAGES_BF16]);
      }
    }
    return;
  }

  const int g = lane / 4, c = lane % 4;
  const int row = blockIdx.x * ROWS_BF16 + warp * 16 + g;
  uint32_t qa[D / 16][4];
  load_q_bf16<D>(qa, q + ((size_t)b * Tq + row) * C + h * D, row < Tq, row + 8 < Tq, C, c);

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES_BF16;
    mbar_wait(&full[st], (i / STAGES_BF16) & 1);
    const uint32_t tile = ring + st * 2 * TILE_BYTES;
    float s[BK / 2];
    score_issue_bf16<D>(s, qa, tile);
    wgmma_wait_all();
    fence_all(s);

    const int k0 = i * BK;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] *= scale;
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
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL_MASK, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      base[hf] = m_new == -INFINITY ? 0.f : m_new;  // -inf-safe, as in the fp32 route
      alpha[hf] = exp2f(m[hf] - base[hf]);
      m[hf] = m_new;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = exp2f(s[e] - base[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + sum[hf];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    value_issue_bf16<D>(acc, pa, tile + TILE_BYTES);
    wgmma_wait_all();
    fence_all(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 1);
    l[hf] += __shfl_xor_sync(FULL_MASK, l[hf], 2);
    const int r = row + 8 * hf;
    if (r < Tq) {
      __nv_bfloat16* dst = o + ((size_t)b * Tq + r) * C + h * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hf] / l[hf], acc[4 * j + 2 * hf + 1] / l[hf]);
      }
    }
  }
}

template <int D>
constexpr size_t SMEM_BYTES_BF16 = STAGES_BF16 * 2 * BK * D * 2 + 2 * STAGES_BF16 * sizeof(uint64_t);
static_assert(SMEM_BYTES_BF16<64> <= 227 * 1024, "the bf16 ring exceeds a block's shared memory");
// The producer announces tile i at its turn i + LAG, after waiting for the
// stage of tile i + LAG - STAGES_BF16 to be free: that tile must be before i.
static_assert(LAG_BF16 < STAGES_BF16, "the bf16 pipeline would deadlock");

template <int D>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const unsigned char* mask, __nv_bfloat16* o, int B, int Tq, int Tk, int H,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = SMEM_BYTES_BF16<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_mha_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_mha_bf16_kernel<D><<<dim3((Tq + ROWS_BF16 - 1) / ROWS_BF16, H, B), 3 * 128, smem, stream>>>(
      q, k, v, mask, o, Tq, Tk, H, scale);
  return cudaGetLastError();
}

// Bring-up: one S tile and one P V tile alone, for one warpgroup, through
// the functions the kernel runs (tile image, descriptors, fragment maps).
// q, k, v (64, D) bf16, p (64, 64) fp32 -> s_out = Q K^T (64, 64) and
// o_out = bf16(P) V (64, D), fp32.
template <int D>
__global__ void __launch_bounds__(128)
bf16_tiles_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  const float* p, float* s_out, float* o_out) {
  __shared__ __align__(128) unsigned char tiles[2 * BK * D * 2];
  const uint32_t k_tile = smem_addr(tiles), v_tile = k_tile + BK * D * 2;
  copy_tile_bf16<D>(k_tile, k, 0, BK, D, threadIdx.x, 128);
  copy_tile_bf16<D>(v_tile, v, 0, BK, D, threadIdx.x, 128);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int row = warp * 16 + g;
  uint32_t qa[D / 16][4];
  load_q_bf16<D>(qa, q + (size_t)row * D, true, true, D, c);
  float s[BK / 2];
  score_issue_bf16<D>(s, qa, k_tile);
  wgmma_wait_all();
  fence_all(s);
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = row + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * c + (e & 1);
    s_out[r * BK + col] = s[e];
    s[e] = p[r * BK + col];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  value_issue_bf16<D>(acc, pa, v_tile);
  wgmma_wait_all();
  fence_all(acc);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    o_out[(row + 8 * ((e >> 1) & 1)) * D + 8 * (e >> 2) + 2 * c + (e & 1)] = acc[e];
  }
}

}  // namespace

extern "C" {

// q (B, Tq, H*D), k/v (B, Tk, H*D), mask (Tq, Tk) bytes or null -> o (B, Tq, H*D).
// image: scratch of B * H * ceil(Tk / 64) * 4 * 64 * D floats. q_scale =
// log2(e) / sqrt(D); block_rows 64 or 128 query rows per block.
int flash_mha_f32(const float* q, const float* k, const float* v, const unsigned char* mask,
                  float* image, float* o, int B, int Tq, int Tk, int H, int D, float q_scale,
                  int block_rows, void* stream) {
  if (Tk <= 0 || (block_rows != 64 && block_rows != 128)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return (int)launch_rows<32>(block_rows, q, k, v, mask, image, o, B, Tq, Tk, H, q_scale, s);
    case 48:
      return (int)launch_rows<48>(block_rows, q, k, v, mask, image, o, B, Tq, Tk, H, q_scale, s);
    case 64:
      return (int)launch_rows<64>(block_rows, q, k, v, mask, image, o, B, Tq, Tk, H, q_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 route: q (B, Tq, H*D), k/v (B, Tk, H*D), o (B, Tq, H*D), all bf16
// with 16-byte aligned rows; mask as for flash_mha_f32. scale = log2(e) /
// sqrt(D), applied to the fp32 scores.
int flash_mha_bf16(const void* q, const void* k, const void* v, const unsigned char* mask,
                   void* o, int B, int Tq, int Tk, int H, int D, float scale, void* stream) {
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  using bf = __nv_bfloat16;
  const bf *qb = (const bf*)q, *kb = (const bf*)k, *vb = (const bf*)v;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return (int)launch_bf16<32>(qb, kb, vb, mask, (bf*)o, B, Tq, Tk, H, scale, s);
    case 48:
      return (int)launch_bf16<48>(qb, kb, vb, mask, (bf*)o, B, Tq, Tk, H, scale, s);
    case 64:
      return (int)launch_bf16<64>(qb, kb, vb, mask, (bf*)o, B, Tq, Tk, H, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One S tile and one P V tile of the bf16 route alone (bf16_tiles_kernel).
int flash_mha_bf16_tiles(const void* q, const void* k, const void* v, const float* p,
                         float* s_out, float* o_out, int D, void* stream) {
  using bf = __nv_bfloat16;
  const bf *qb = (const bf*)q, *kb = (const bf*)k, *vb = (const bf*)v;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      bf16_tiles_kernel<32><<<1, 128, 0, s>>>(qb, kb, vb, p, s_out, o_out);
      break;
    case 48:
      bf16_tiles_kernel<48><<<1, 128, 0, s>>>(qb, kb, vb, p, s_out, o_out);
      break;
    case 64:
      bf16_tiles_kernel<64><<<1, 128, 0, s>>>(qb, kb, vb, p, s_out, o_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
