// K3: multi-head attention over projected q/k/v with an online softmax, fp32
// in and out, both products on the tensor cores (sm_90a wgmma) in the
// three-term TF32 split.
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

}  // extern "C"
