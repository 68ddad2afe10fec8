// K3's backward at head dim 128, both routes, unmasked and MASKED, by
// default and under the deterministic order (a head of 64 < d < 128
// channels comes here padded with zero channels, kernels/attention.py).
// Replaces the gradient of demucs_tpu/ops/pallas/attention.py:103
// (flash_mha) at any head dim (:117): the Pallas kernel has no backward, and
// JAX trains through XLA's dense attention at every head dim.
//
// What bounds it: room, not work, as the D = 128 forwards. The d <= 64
// layouts doubled (flash_mha_bwd.cuh):
// - fp32 (F32Bwd, 64 keys a block, 32 queries a tile): raw K and V and
//   their lo parts 128 KiB, the (Q, dO) ring 64, the tile's lo parts 32,
//   K^T hi and lo 64, the passed images 128, dS 16: about 430 KiB of the 227
//   a block may have; dK and dV with each tile's own accumulators would take
//   256 registers a thread.
// - bf16 (Bf16Bwd): two consumer warpgroups (128 keys) 256 KiB.
//
// bf16: Bf16Bwd<128, 1, ORDERED, MASKED> of flash_mha_bwd.cuh, one consumer
// warpgroup of 64 keys, one block per SM. Shared memory: K and V 2 x 16 KiB,
// the (Q, dO) ring 3 x 32 KiB (deterministic: 2 stages), two dS^T tiles 16
// KiB, the dQ staging 32 KiB (deterministic: a ring of two, 64 KiB), the
// stats, barriers and alignment 2.7 KiB (masked: 1.5 KiB of bits more):
// 178.7 KiB, 180.2 masked.
// Registers: dK and dV 64 + 64 a thread, S^T and dP^T 32 + 32, Z P and dS^T
// as bf16 fragments 16 + 16; dQ = dS K in two halves of 64 channels (K's two
// 128-byte boxes), 32 registers each, staged one after the other (whole, its
// 64 would pass 255 beside dK and dV); P and dS in four quarters of 16
// queries, each with its 4 + 4 of the tile's lse and D (with all 32 held,
// the instances spilled 4-256 bytes). No setmaxnreg: the launch gives every
// thread 255; ptxas on the H100 build: 242 (ordered 250, masked 239 and 245),
// no spill. The rest (the copies, the walks, the deterministic order and its
// cooperative grid, the masked tile maps and bits) is the d <= 64 design's,
// unchanged.
//
// fp32: the products in 3xTF32 (hi and lo of each operand, a_lo b_hi + a_hi
// b_lo + a_hi b_hi) on the tensor cores by mma.sync m16n8k8 (TF32 in, fp32
// accumulate), the work split as in FlashAttention-2, two kernels:
// - dK, dV (bwd_dkdv_f32_d128): a block of 64 keys (4 warps of 16) of one
//   (batch, head) walks the query tiles of 32 (under a mask the units of the
//   backward's tile map of plan (64, 32), a partial one's bits from
//   pack_mask_bits_bwd). Per tile, warp w: S^T and dP^T of its 16 keys x 32
//   queries (A = K or V, B = Q or dO, all from shared memory), P and dS by
//   probs_and_ds (the accumulator's lanes are the wgmma kernels'), then dV +=
//   (Z P)^T dO and dK += dS^T Q with A passed from those accumulators in
//   registers (k-position c of a group of 8 is query 2c, c + 4 is 2c + 1; B
//   read in that order).
// - dQ (bwd_dq_f32_d128): a block of 64 queries (4 warps of 16) walks the key
//   tiles of 32 (under a mask the units of the forward's tile map of plan
//   (64, 32), a partial one's bits from pack_mask_bits), recomputes S and dP
//   (A = Q or dO, B = K or V), dS, and dQ += dS K. Each query's dQ is summed
//   inside one block, in key order: no atomics and no order to fix, so the
//   deterministic flag needs no instance of its own and repeats bit for bit.
// mma.sync reads both operands from registers, so each is split into hi and
// lo as it is read from shared memory: no lo images. Each tile's products go
// to a fresh 16 x 8 accumulator per 8 channels, added to dK, dV or dQ in
// fp32 (the tensor core's accumulation truncates, as the forward's P V).
// Shared memory a block: its own 64 rows of K and V (or Q and dO) and the
// tile's 32 rows of Q and dO (or K and V), 128 floats a row padded to 132 so
// that a fragment's 32 reads hit 32 banks: 192 x 528 bytes and the tile's
// stats, 99.3 KiB, two blocks an SM. Registers: dK and dV (dQ) 64 each a
// thread, S^T and dP^T 16 each, a passed operand's hi and lo 32 (ptxas: the
// dK / dV kernel 254, masked 255; dQ 215, 221; no spill). The cost of
// the simple form: the two kernels do 3 x 7 products for the function's 5
// (S and dP twice), mma.sync issues 16 x 8 per instruction against wgmma's
// 64 x N, and every operand is split as it is read.

#pragma once

#include "flash_mha_bwd.cuh"

namespace {

constexpr int LD = 132;  // floats a row of a tile in shared memory: 128 channels, 4 of padding

// d (16 x 8) += a (16 x 8, TF32) b (8 x 8, TF32), one warp (PTX ISA, mma
// .m16n8k8 .tf32; g = lane / 4, c = lane % 4): a = A[g][c], A[g + 8][c],
// A[g][c + 4], A[g + 8][c + 4]; b = B[c][g], B[c + 4][g]; d = D[g][2c],
// D[g][2c + 1], D[g + 8][2c], D[g + 8][2c + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, hi = tf32_hi(x), as the words mma.sync reads.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split_tf32(float x) {
  const float h = tf32_hi(x);
  return Split{__float_as_uint(h), __float_as_uint(x - h)};
}

// One k-step in 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], Split b0, Split b1) {
  mma_tf32(d, al, b0.hi, b1.hi);
  mma_tf32(d, ah, b0.lo, b1.lo);
  mma_tf32(d, ah, b0.hi, b1.hi);
}

// The A fragment of rows r, r + 8 and columns k, k + 4 of a tile in shared
// memory, split.
__device__ __forceinline__ void a_frag(const float* t, int r, int k, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float x[4] = {t[r * LD + k], t[(r + 8) * LD + k], t[r * LD + k + 4],
                      t[(r + 8) * LD + k + 4]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split s = split_tf32(x[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

// The A fragments of a 16 x 32 accumulator x (x[j] the columns 8 j .. 8 j +
// 7, in the accumulator's lanes) in the passed order: k-position c of group j
// is column 8 j + 2c, c + 4 is 8 j + 2c + 1; split.
__device__ __forceinline__ void passed_frags(const float (&x)[4][4], uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float xs[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split s = split_tf32(xs[e]);
      hi[j][e] = s.hi;
      lo[j][e] = s.lo;
    }
  }
}

// acc (16 x 128) += x (16 x 32, passed: `hi`, `lo`) . t (32 rows of 128 in
// shared memory), each 8 columns a fresh accumulator added in fp32.
__device__ __forceinline__ void add_product(float (&acc)[16][4], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], const float* t, int g,
                                            int c) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* col = t + (8 * j + 2 * c) * LD + 8 * n + g;
      mma3(part, hi[j], lo[j], split_tf32(col[0]), split_tf32(col[LD]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// s (16 x 32) = a (16 rows of the block's tile `at`, from row r) . t^T (t: 32
// rows of 128 in shared memory), over the 128 channels.
__device__ __forceinline__ void score_frags(float (&s)[4][4], const float* at, int r,
                                            const float* t, int g, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
  for (int kc = 0; kc < 16; ++kc) {
    uint32_t ah[4], al[4];
    a_frag(at, r, 8 * kc + c, ah, al);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = t + (8 * j + g) * LD + 8 * kc + c;
      mma3(s[j], ah, al, split_tf32(row[0]), split_tf32(row[4]));
    }
  }
}

// Rows r0 .. r0 + ROWS - 1 of head h of a (B, T, H * 128) fp32 tensor into a
// tile in shared memory, zeros past T; by the block's 128 threads.
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b, int T,
                                          int H, int h, int r0) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * 32; i += 128) {
    const int r = i / 32, f = i % 32;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) {
      x = reinterpret_cast<const float4*>(src + ((size_t)b * T + r0 + r) * H * 128 + h * 128)[f];
    }
    reinterpret_cast<float4*>(dst + r * LD)[f] = x;
  }
}

constexpr size_t DKDV_SMEM = (size_t)(2 * 64 + 2 * 32) * LD * 4 + 64 * 4;
constexpr size_t DQ_SMEM = (size_t)(2 * 64 + 2 * 32) * LD * 4;

// dK and dV of key block x (64 keys) of (batch b, head h): grid (ceil(Tk /
// 64), H, B), 128 threads. stats: bwd_prep_kernel<float, 128, 64>'s.
template <bool MASKED>
__global__ void __launch_bounds__(128, 2)
bwd_dkdv_f32_d128(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ stats, float* __restrict__ dk, float* __restrict__ dv,
                  int Tq, int Tk, int H, float scale, float sm_scale, Dropout drop,
                  const int* __restrict__ tile_map, const unsigned char* __restrict__ bits) {
  extern __shared__ __align__(16) float smem_f32[];
  float* const ks = smem_f32;       // the block's keys
  float* const vs = ks + 64 * LD;
  float* const qs = vs + 64 * LD;   // the tile's queries
  float* const dos = qs + 32 * LD;
  float* const lse_s = dos + 32 * LD;  // the tile's lse, then its D
  const int b = blockIdx.z, h = blockIdx.y, x = blockIdx.x, j0 = x * 64, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int row0 = 16 * warp + g;  // the thread's first key in the block
  const int n_st = (Tq + 63) / 64;  // the stats' tiles of 64 queries
  const uint32_t salt = drop.salt(bh);
  const bool edge = j0 + 64 > Tk;
  int n = (Tq + 31) / 32;  // the block's units: its listed query tiles, or every tile
  const int* ent = nullptr;
  if constexpr (MASKED) {
    const Units un = units_of(tile_map, x, false);
    ent = un.ent;
    n = un.n;
  }
  load_tile<64>(ks, k, b, Tk, H, h, j0);
  load_tile<64>(vs, v, b, Tk, H, h, j0);

  float acc_dk[16][4], acc_dv[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;
  }
  for (int it = 0; it < n; ++it) {
    int t = it;
    bool partial = false;
    if constexpr (MASKED) {
      t = ent[it] >> 1;
      partial = ent[it] & 1;
    }
    const int i0 = t * 32;
    __syncthreads();  // every warp is done with the last tile
    load_tile<32>(qs, q, b, Tq, H, h, i0);
    load_tile<32>(dos, dout, b, Tq, H, h, i0);
    if (threadIdx.x < 64) {
      const int i = i0 + threadIdx.x % 32;
      lse_s[threadIdx.x] = stats[((size_t)bh * n_st + i / 64) * 128 + (threadIdx.x / 32) * 64 +
                                 i % 64];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];  // S^T, dP^T: the warp's 16 keys x the tile's 32 queries
    score_frags(st, ks, row0, qs, g, c);
    score_frags(dpt, vs, row0, dos, g, c);
    float(&st16)[16] = reinterpret_cast<float(&)[16]>(st);
    float(&dpt16)[16] = reinterpret_cast<float(&)[16]>(dpt);
    if (MASKED && partial) {
      const unsigned char* w = bits + ((size_t)t * mask_rows(Tk) + j0 + row0) * 4 + c;
      const uint32_t wd[2] = {w[0], w[8 * 4]};
      probs_and_ds_bits<32>(st16, dpt16, lse_s, lse_s + 32, j0 + row0, i0, c, wd, scale, drop,
                            salt);
    } else if (!MASKED && edge) {
      probs_and_ds<32, true>(st16, dpt16, lse_s, lse_s + 32, j0 + row0, i0, c, nullptr, Tq, Tk,
                             scale, drop, salt);
    } else {
      probs_and_ds<32, false>(st16, dpt16, lse_s, lse_s + 32, j0 + row0, i0, c, nullptr, Tq, Tk,
                              scale, drop, salt);
    }
    uint32_t ah[4][4], al[4][4];
    passed_frags(st, ah, al);  // Z P
    add_product(acc_dv, ah, al, dos, g, c);
    passed_frags(dpt, ah, al);  // dS
    add_product(acc_dk, ah, al, qs, g, c);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = j0 + row0 + 8 * hf;
    if (key >= Tk) continue;
    const size_t at = ((size_t)b * Tk + key) * H * 128 + h * 128 + 2 * c;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(dk + at + 8 * i) =
          make_float2(acc_dk[i][2 * hf] * sm_scale, acc_dk[i][2 * hf + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + at + 8 * i) =
          make_float2(acc_dv[i][2 * hf], acc_dv[i][2 * hf + 1]);
    }
  }
}

// dQ of row block x (64 queries) of (batch b, head h): grid (ceil(Tq / 64),
// H, B), 128 threads; under a mask fwd_map is the forward's tile map of
// plan (64, 32) (kernels/attention.py tile_map: [nnz, n_empty, off, ent,
// empty]) and fwd_bits the forward's packed mask (pack_mask_bits: word c of
// (group t / 4, row) holds key tile t's keys 8 j + 2c + b at bit 8 (t % 4)
// + 2 j + b).
template <bool MASKED>
__global__ void __launch_bounds__(128, 2)
bwd_dq_f32_d128(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ stats, float* __restrict__ dq, int Tq, int Tk, int H,
                float scale, float sm_scale, Dropout drop, const int* __restrict__ fwd_map,
                const unsigned* __restrict__ fwd_bits) {
  extern __shared__ __align__(16) float smem_f32[];
  float* const qs = smem_f32;  // the block's queries
  float* const dos = qs + 64 * LD;
  float* const ks = dos + 64 * LD;  // the tile's keys
  float* const vs = ks + 32 * LD;
  const int b = blockIdx.z, h = blockIdx.y, x = blockIdx.x, i0 = x * 64, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int row0 = 16 * warp + g;  // the thread's first query in the block
  const uint32_t salt = drop.salt(bh);
  // the thread's two rows' lse and D (the stats' tile x holds the block's 64 rows)
  const float* st = stats + ((size_t)bh * gridDim.x + x) * 128;
  const float l[2] = {st[row0], st[row0 + 8]}, dd[2] = {st[64 + row0], st[64 + row0 + 8]};
  int n = (Tk + 31) / 32;  // the block's units: its listed key tiles, or every tile
  const int* ent = nullptr;
  if constexpr (MASKED) {
    ent = fwd_map + 3 + gridDim.x + fwd_map[2 + x];
    n = fwd_map[3 + x] - fwd_map[2 + x];
  }
  load_tile<64>(qs, q, b, Tq, H, h, i0);
  load_tile<64>(dos, dout, b, Tq, H, h, i0);

  float acc_dq[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[i][e] = 0.f;
  }
  for (int it = 0; it < n; ++it) {
    int t = it;
    bool partial = false;
    if constexpr (MASKED) {
      t = ent[it] >> 1;
      partial = ent[it] & 1;
    }
    const int k0 = t * 32;
    __syncthreads();  // every warp is done with the last tile
    load_tile<32>(ks, k, b, Tk, H, h, k0);
    load_tile<32>(vs, v, b, Tk, H, h, k0);
    __syncthreads();

    float s[4][4], dp[4][4];  // S, dP: the warp's 16 queries x the tile's 32 keys
    score_frags(s, qs, row0, ks, g, c);
    score_frags(dp, dos, row0, vs, g, c);
    uint32_t wd[2] = {0u, 0u};  // a partial unit: the lane's bits of its two rows
    if (MASKED && partial) {
      const unsigned* w = fwd_bits + ((size_t)(t >> 2) * mask_rows(Tq) + i0 + row0) * 4 + c;
      wd[0] = w[0] >> (8 * (t & 3));
      wd[1] = w[8 * 4] >> (8 * (t & 3));
    }
    const bool edge = !MASKED && k0 + 32 > Tk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hf = r >> 1, key = k0 + 8 * j + 2 * c + (r & 1);
        const float p = ex2(fmaf(s[j][r], scale, -l[hf]));
        float z = 1.f;
        if (drop.rate > 0.f) z = drop.keep(i0 + row0 + 8 * hf, key, salt) ? drop.scale : 0.f;
        const float ds = p * fmaf(dp[j][r], z, -dd[hf]);
        bool keep = true;
        if (MASKED && partial) keep = (wd[hf] >> (2 * j + (r & 1))) & 1u;
        if (edge) keep = key < Tk;
        s[j][r] = keep ? ds : 0.f;
      }
    }
    uint32_t ah[4][4], al[4][4];
    passed_frags(s, ah, al);  // dS
    add_product(acc_dq, ah, al, ks, g, c);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = i0 + row0 + 8 * hf;
    if (row >= Tq) continue;
    float* at = dq + ((size_t)b * Tq + row) * H * 128 + h * 128 + 2 * c;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(at + 8 * i) =
          make_float2(acc_dq[i][2 * hf] * sm_scale, acc_dq[i][2 * hf + 1] * sm_scale);
    }
  }
}

// The fp32 route at D = 128: the row stats, then the two kernels, on `stream`.
template <bool MASKED>
int launch_f32_d128(const float* q, const float* k, const float* v, const float* o,
                    const float* dout, const float* lse, const int* tile_map,
                    const unsigned char* bits, const int* fwd_map, const unsigned* fwd_bits,
                    float* stats, float* dq, float* dk, float* dv, int B, int Tq, int Tk, int H,
                    float scale, float sm_scale, Dropout drop, cudaStream_t stream) {
  if (MASKED && (fwd_map == nullptr || fwd_bits == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * ((Tq + 63) / 64) * 64 * H;
  bwd_prep_kernel<float, 128, 64><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, stats, B, Tq, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kv_kernel = bwd_dkdv_f32_d128<MASKED>;
  auto q_kernel = bwd_dq_f32_d128<MASKED>;
  e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DKDV_SMEM);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DQ_SMEM);
  }
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<dim3((Tk + 63) / 64, H, B), 128, DKDV_SMEM, stream>>>(
      q, k, v, dout, stats, dk, dv, Tq, Tk, H, scale, sm_scale, drop, tile_map, bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q_kernel<<<dim3((Tq + 63) / 64, H, B), 128, DQ_SMEM, stream>>>(
      q, k, v, dout, stats, dq, Tq, Tk, H, scale, sm_scale, drop, fwd_map, fwd_bits);
  return (int)cudaGetLastError();
}

// dispatch_bwd's D = 128 case (the C entries' arguments; keys: 64).
template <bool MASKED>
int bwd_d128(int bf16_route, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, const int* tile_map, const unsigned char* bits,
             const int* fwd_map, const unsigned* fwd_bits, float* stats, float* dq_acc,
             unsigned* turns, void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
             int keys, float scale, float sm_scale, Dropout drop, cudaStream_t s) {
  if (keys != 64) return (int)cudaErrorInvalidValue;
  if (bf16_route) {
    const MaskArgs m{nullptr, tile_map, bits, nullptr, nullptr};
    return Routes<bf16, MASKED>::template keys_run<128, 1>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, lse,
        m, stats, dq_acc, turns, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, Tq, Tk, H, scale, sm_scale,
        drop, s);
  }
  // turns are not read: the fp32 route's dQ has no order to fix
  return launch_f32_d128<MASKED>((const float*)q, (const float*)k, (const float*)v,
                                 (const float*)o, (const float*)dout, lse, tile_map, bits,
                                 fwd_map, fwd_bits, stats, (float*)dq, (float*)dk, (float*)dv, B,
                                 Tq, Tk, H, scale, sm_scale, drop, s);
}

// ordered_plan_entry's D = 128 case: the bf16 route's deterministic grid;
// the fp32 route has none (refused).
template <bool MASKED>
int bwd_d128_plan(int bf16_route, int keys, int B, int Tq, int Tk, int H, int* plan) {
  OrderedPlan p{};
  int e = (int)cudaErrorInvalidValue;
  if (bf16_route && keys == 64) {
    e = (int)ordered_plan<Bf16Bwd<128, 1, true, MASKED>>(B, Tq, Tk, H, &p);
  }
  const int out[] = {p.n_qt, p.n_kb, p.per_sm, p.sms, p.grid, p.stagger, p.ring};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return e;
}

}  // namespace
