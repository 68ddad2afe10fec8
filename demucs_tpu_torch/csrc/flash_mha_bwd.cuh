// K3's backward: the gradients of flash_mha.cu's two routes (fp32 and bf16),
//
//   o_i = sum_j Z_ij P_ij v_j,  P_ij = softmax_j(q_i . k_j / sqrt(D), masked),
//   Z_ij = keep_ij / (1 - rate) (the forward's hashed dropout, or 1),
//
// from q, k, v, o, dO and the forward's per-row log-sum-exp (base 2, of the
// scores scaled by log2(e) / sqrt(D)):
//
//   dV_j = sum_i Z_ij P_ij dO_i
//   dS_ij = P_ij (Z_ij dO_i . v_j - D_i),  D_i = dO_i . o_i
//   dQ_i = sum_j dS_ij k_j / sqrt(D),  dK_j = sum_i dS_ij q_i / sqrt(D)
//
// (sum_j P_ij Z_ij dO_i . v_j is dO_i . o_i, so D needs no second pass over
// the keys). Layouts as the forward: q, o, dO, dQ (B, Tq, H*D), k, v, dK, dV
// (B, Tk, H*D), row-major, all of one element type (fp32 or bf16), a head at
// column h*D; the keep-mask (Tq, Tk) bytes shared by batch and heads; lse
// (B*H, Tq) fp32. A fully masked row gives zero gradients (the plain version
// gives NaN there, ROADMAP C).
//
// Replaces the gradient of demucs_tpu/ops/pallas/attention.py:103
// (flash_mha): the Pallas kernel has no backward, and JAX trains through
// XLA's dense attention (demucs_tpu/ops/attention.py), whose gradient this is.
//
// Bound: operations. Five products of 2 Tq Tk D flops per head (S, dP, dV,
// dK, dQ) on 4 (Tq + Tk) D values in and 2 (Tq + Tk) D out, hundreds of
// flops per byte at the released shapes. bf16: one bf16 wgmma per product,
// fp32 accumulation: 5 x 2 B H Tq Tk D over 989 TFLOP/s; Z P and dS enter
// their products as bf16 (rounded from fp32), dQ, dK and dV come out in
// bf16. fp32: each product as three TF32 wgmma (the 3xTF32 split of
// flash_mha.cu, for fp32 accuracy): 3 x 5 x 2 B H Tq Tk D over 495 TFLOP/s;
// the operand images the fp32 route lays out in shared memory are its own
// cost, not the function's.
//
// Design, against what held the first (mma.sync) kernels back:
// 1. Legacy instructions -> every product is a wgmma, each consumer
//    warpgroup owning 64 keys (wgmma's M).
// 2. No copy pipeline -> one producer thread brings K and V once, then Q,
//    dO (tensor-memory-accelerator copies, tensor_map.cuh's 3-D maps, zeros
//    past Tq) and the tile's lse and D (a bulk copy of bwd_prep_kernel's
//    padded stats) into a ring of STAGES tiles against mbarriers.
// 3. Seven products for five -> one pass, keys outer: a block owns KEYS keys
//    of one (batch, head) and walks every tile of QT queries. Per tile each
//    consumer warpgroup computes S^T = K Q^T and dP^T = V dO^T (its 64 keys
//    x QT queries), then P = 2^(S^T scale - lse), Z and dS^T in fp32
//    registers (probs_and_ds), dV += (Z P)^T dO and dK += dS^T Q with A from
//    those registers, and dQ for the tile, dS K over the block's keys, with
//    dS through shared memory. The tile's dQ goes through a shared-memory
//    staging into a fp32 scratch (dq_acc) by one bulk reduction
//    (cp.reduce.async.bulk add.f32, in L2), and a small epilogue writes dq.
//    By default the blocks of a head add in the order they finish, so dQ's
//    last bits may differ from run to run (tests/test_torch_cuda.py bounds
//    two launches); dK and dV do not. Given `turns` (the wrapper passes them
//    under torch.use_deterministic_algorithms), each tile's parts add in an
//    order fixed by the shape alone (Walk), and dQ repeats bit for bit. That
//    order must cost no handoff in the consumers' path and no chain across a
//    head's blocks: each key block walks the tiles from a tile of its own
//    and the order follows the walks (Walk), writers outside the consumer
//    warpgroups wait for the turns and the additions (bf16: a ring of
//    stagings and bulk reductions; fp32, whose shared memory is full: a warp
//    that takes the staging into registers and adds by vector atomics), and
//    the grid is cooperative so that every block waited on is resident
//    (bwd_kernel).
// 4. 16-bit fragment reads across rows -> operands from shared memory by
//    descriptor, the transposed ones with wgmma's transpose bit (bf16) or
//    laid out transposed (fp32, below); dS^T in a swizzled tile.
// 5. exp2f per score -> one FFMA and one ex2.approx; the drop's hash only at
//    rate > 0 (its keep test an integer compare, attention_dropout.cuh); the
//    keep test only in a block that runs past Tk (the unmasked instances'
//    `mask` is always null: the wrapper's masked launches take the MASKED
//    instances); a row past Tq has lse = +inf (P = 0), so ragged query tiles
//    need no test.
// 6. Under a keep-mask (the MASKED instances, flash_mha_bwd_masked.cu). What
//    bounded the first masked backward: every key block visited every query
//    tile, kept or not, and under the mask each score loaded its byte
//    (probs_and_ds's byte test) between S^T / dP^T and the dV / dK products
//    that wait for it; bf16 1.8-2.3x SDPA's backward with the same mask
//    (PERF.md). Now the mask comes as the backward's tile map, built once
//    per mask on the host (kernels/attention.py bwd_tile_map: per key block
//    the query tiles that keep a score, full or partial, and each unit's
//    turn in the deterministic order) and as bits in the order of S^T's
//    lanes (mask_rows below). A key block walks its listed units only: the
//    producer streams their Q, dO and stats alone, a full unit takes no test,
//    and a partial one's bits come into its stage with one bulk copy on the
//    stage's barrier, so the keep test is a bit test and a select a score,
//    no global load. The ring's counts run over the listed units (u0 the sum
//    of the block's earlier items' units), a key block with no unit still
//    writes dK = dV = 0, a query tile no block visits keeps dQ = 0 (dq_acc
//    is zeroed), and under the deterministic order each tile's parts are
//    added in the unmasked order (Walk) restricted to the blocks that visit it (the
//    turns from the map): no block waits on one that skips the tile.
//
// The routes share the block (bwd_kernel: roles, ring, copies), the
// probabilities, drop and dS, the dQ reduction, the prep kernel and the
// launch. Their operands and products are their own, as the tensor core
// reads bf16 and fp32 operands differently:
// - bf16 (Bf16Bwd): QT = 64, KEYS = 64 or 128 (one or two consumer
//   warpgroups; kernels/attention.py bwd_keys), every operand the copies'
//   swizzled image as it lands. S^T, dP^T: MmaBf16SS<64>, both K-major; dV,
//   dK: A the accumulator packed pairwise to bf16, B the dO or Q tile
//   MN-major (MmaBf16<D, 1>); dQ = dS K: A = the dS^T tile MN-major, B = K
//   MN-major (MmaBf16SS<D, 1, 1>), over all the block's keys, issued by one
//   warpgroup a tile in turn (it alone waits for the other's dS^T).
// - fp32 (F32Bwd): each product in three TF32 parts (3xTF32); wgmma reads
//   32-bit operands from shared memory only K-major, with no transpose. The
//   tensor core reads an fp32 operand as its TF32 truncation, so the raw
//   K, V, Q and dO tiles are the hi parts of S^T's and dP^T's operands and
//   only their lo parts are written (in the same layout); K^T (A of dQ^T =
//   K^T dS^T, keys in dS's order), Q^T and dO^T (B of dK, dV, queries in
//   the order of the passed accumulator's k-positions, as flash_mha.cu's
//   V^T) and dS (B of dQ^T) are images split hi/lo. They fill the shared
//   memory: one consumer warpgroup (64 keys), tiles of 32 queries; the
//   producer warpgroup's other three warps build the next tile's Q^T and
//   dO^T; dQ^T's staging reuses dS's image. The tensor core's accumulation
//   truncates, so each tile's dV and dK have accumulators of their own,
//   added in fp32 (as flash_mha.cu's P V); the images are the kernel's own
//   cost, not the function's.
// - At D = 128 (flash_mha_bwd_d128.cuh, sources of their own): bf16
//   Bf16Bwd<128, 1> (one consumer warpgroup, one block an SM, dQ in two
//   halves of 64 channels); fp32 two kernels of its own (dK and dV by key
//   block, dQ by row block, mma.sync in 3xTF32), as the images above would
//   take about 430 KiB there.
//
// This header holds the device code and the host launch of both routes;
// flash_mha_bwd.cu instantiates the unmasked instances and exports their C
// entries, flash_mha_bwd_masked.cu the MASKED ones (two sources, built in
// parallel).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_dropout.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

// The head dim 128 launches, defined in flash_mha_bwd_d128.cu (unmasked)
// and flash_mha_bwd_masked_d128.cu (MASKED), each a source of its own linked
// into its library (kernels/_build.py PARTS): dispatch_bwd and
// ordered_plan_entry call them at D = 128. Arguments as dispatch_bwd's, the
// keep-mask's as MaskArgs' fields (fwd_map, fwd_bits: the forward's tile map
// for 64 rows and 32 keys and its bits, which the fp32 route's dQ kernel
// reads). flash_mha_bwd_d128.cuh holds the design.
int flash_mha_bwd_d128(int bf16_route, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse, const int* tile_map,
                       const unsigned char* bits, const int* fwd_map, const unsigned* fwd_bits,
                       float* stats, float* dq_acc, unsigned* turns, void* dq, void* dk, void* dv,
                       int B, int Tq, int Tk, int H, int keys, float scale, float sm_scale,
                       Dropout drop, cudaStream_t s);
int flash_mha_bwd_masked_d128(int bf16_route, const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* lse,
                              const int* tile_map, const unsigned char* bits, const int* fwd_map,
                              const unsigned* fwd_bits, float* stats, float* dq_acc,
                              unsigned* turns, void* dq, void* dk, void* dv, int B, int Tq,
                              int Tk, int H, int keys, float scale, float sm_scale, Dropout drop,
                              cudaStream_t s);
int flash_mha_bwd_d128_plan(int bf16_route, int keys, int B, int Tq, int Tk, int H, int* plan);
int flash_mha_bwd_masked_d128_plan(int bf16_route, int keys, int B, int Tq, int Tk, int H,
                                   int* plan);

namespace {

using namespace hopper;
using tensor_map::RowImage;
using bf16 = __nv_bfloat16;

constexpr int KEYS_WG = 64;  // keys per consumer warpgroup (wgmma's M)
// named barriers: 1 + w, the dS^T of a tile whose dQ warpgroup w issues
// (bf16); 3 + w, warpgroup w alone; the whole block between two items of the
// deterministic grid
constexpr int BAR_DS0 = 1, BAR_WG0 = 3, BAR_ITEM = 5;
// The barriers' bytes: full and empty per stage of the Q/dO ring, kv_full
// and kv_empty per K/V buffer (2 at most), aux (4), dq_full and dq_empty per
// slot of the deterministic dQ ring (at most MAX_SLOTS), and two ints (the
// deterministic grid's next items).
constexpr int MAX_SLOTS = 3;
constexpr size_t bar_bytes(int stages) { return (2 * stages + 8 + 2 * MAX_SLOTS) * 8 + 8; }

// ---- a keep-mask as the MASKED instances read it (kernels/attention.py MaskTiles) ----
// The tile map of the launch's plan (KEYS keys a block, QT queries a tile;
// bwd_tile_map), int32:
//   [nnz, n_kb, off[0 .. n_kb], ent[0 .. nnz), rot[0 .. n_kb), turn_s[0 .. nnz),
//    turn_p[0 .. nnz)]
// ent lists the (key block, query tile) units that keep a score, key block
// by key block (off: each block's first) in tile order, as tile << 1 |
// partial: a full unit keeps every score of its queries below Tq and lies
// inside Tk, a partial one does not (a key block past Tk is partial, and its
// bits are 0 there: keys past Tk take no other test). rot: the entry that
// starts a block's staggered walk (the first listed tile at or after its
// Walk::o). turn_s, turn_p: each unit's place among the blocks that visit its
// tile, in the staggered and in the plain deterministic order (bwd_order
// restricted to them: kernels/attention.py bwd_order_masked).
// bits (n_qt, mask_rows(Tk), 4) of QT / 4 bits each (uint8 at QT = 32,
// uint16 at QT = 64): element c of (query tile t, key j) holds the queries
// lane c holds of key j in S^T, t QT + 8 i + 2 c + b at bit 2 i + b (0 past
// Tq and past Tk). A key block's elements of one tile are contiguous, so a
// partial unit's come in with one bulk copy (KEYS x 4 elements).
__host__ __device__ constexpr int mask_rows(int Tk) { return (Tk + 383) / 384 * 384; }

// A key block's units under a mask in its walk's order: unit k is entry
// at(k) of its list (rotated to the staggered walk's start, or from tile 0).
struct Units {
  const int* ent;   // the block's entries, tile order
  const int* turn;  // each entry's place in its tile's order (the launch's)
  int n, rot;       // its units; the entry its walk starts at
  __device__ __forceinline__ int at(int k) const {
    const int i = k + rot;
    return i < n ? i : i - n;
  }
};
__device__ __forceinline__ Units units_of(const int* __restrict__ map, int x, bool stagger) {
  const int nnz = map[0], n_kb = map[1], o = map[2 + x];
  const int* ent = map + 3 + n_kb;
  const int* rot = ent + nnz;
  return Units{ent + o, rot + n_kb + (stagger ? 0 : nnz) + o, map[3 + x] - o,
               stagger ? rot[x] : 0};
}

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

// The dot of two 16-byte vectors of T, in fp32.
__device__ __forceinline__ float dot16(uint4 x, uint4 y, float) {
  const float4 a = *reinterpret_cast<float4*>(&x), b = *reinterpret_cast<float4*>(&y);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot16(uint4 x, uint4 y, bf16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(a[e]), w = __bfloat1622float2(b[e]);
    acc += u.x * w.x + u.y * w.y;
  }
  return acc;
}

// Per (batch, padded query row, head): the row's lse and D = dO . o into
// stats (B*H, n_qt, 2, QT) (a tile's QT lse, then its QT D: one bulk copy);
// rows past Tq get lse = +inf (P = 0) and D = 0.
template <typename T, int D, int QT>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ stats, int B, int Tq, int H) {
  constexpr int VEC = 16 / sizeof(T);
  const int n_qt = (Tq + QT - 1) / QT, rows = n_qt * QT;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * rows * H) return;
  const int h = idx % H;
  const int i = idx / H % rows, b = idx / H / rows;
  const int bh = b * H + h;
  float l = INFINITY, dd = 0.f;
  if (i < Tq) {
    const size_t at = ((size_t)b * Tq + i) * H * D + h * D;
    const uint4* x = reinterpret_cast<const uint4*>(o + at);
    const uint4* y = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
    for (int f = 0; f < D / VEC; ++f) dd += dot16(x[f], y[f], T());
    l = lse[(size_t)bh * Tq + i];
  }
  float* st = stats + ((size_t)bh * n_qt + i / QT) * 2 * QT + i % QT;
  st[0] = l;
  st[QT] = dd;
}

// dQ's fp32 sums, dq_acc (B*H, n_qt, a tile): each query tile's sums lie in
// the order of the accumulator fragments that add them (a tile's bulk
// reduction is one contiguous copy, its staging in shared memory written
// without bank conflicts): float2 ((w (N / 8) + j) 2 + hf) 32 + lane of a
// tile holds the values of rows 16 w + g + 8 hf, columns 8 j + 2c, + 1 of
// the product (lane = 4 g + c). bf16: rows the QT = 64 queries, columns the
// D channels; fp32 (dQ^T): rows the D channels, columns the QT = 32 queries.
template <int N>
__host__ __device__ constexpr int frag_index(int row, int col) {
  return ((((row >> 4) * (N / 8) + (col >> 3)) * 2 + ((row >> 3) & 1)) * 32 + 4 * (row & 7) +
          ((col & 7) >> 1)) * 2 + (col & 1);
}

// dq (B, Tq, H*D) bf16 from the bf16 route's sums: one thread per (batch,
// query, head, 8 channels), two float4 loads, one 16-byte store.
template <int D>
__global__ void __launch_bounds__(256)
bwd_dq_bf16_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int B, int Tq, int H) {
  constexpr int QT = 64;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * Tq * H * (D / 8)) return;
  const int j = idx % (D / 8), h = idx / (D / 8) % H;
  const size_t bq = idx / (D / 8) / H;  // b * Tq + q
  const int q = bq % Tq, b = bq / Tq, n_qt = (Tq + QT - 1) / QT;
  const float4* src = reinterpret_cast<const float4*>(
      acc + ((size_t)(b * H + h) * n_qt + q / QT) * QT * D + frag_index<D>(q % QT, 8 * j));
  const float4 x = src[0], y = src[1];
  reinterpret_cast<uint4*>(dq + bq * H * D + h * D)[j] = make_uint4(
      pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}

// dq (B, Tq, H*D) fp32 from the fp32 route's sums of dQ^T: one thread per
// (batch, query, head, 8 channels).
template <int D>
__global__ void __launch_bounds__(256)
bwd_dq_f32_kernel(const float* __restrict__ acc, float* __restrict__ dq, int B, int Tq, int H) {
  constexpr int QT = 32;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * Tq * H * (D / 8)) return;
  const int j = idx % (D / 8), h = idx / (D / 8) % H;
  const size_t bq = idx / (D / 8) / H;
  const int q = bq % Tq, b = bq / Tq, n_qt = (Tq + QT - 1) / QT;
  const float* src = acc + ((size_t)(b * H + h) * n_qt + q / QT) * QT * D;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = src[frag_index<QT>(8 * j + e, q % QT)];
  float4* dst = reinterpret_cast<float4*>(dq + bq * H * D + h * D + 8 * j);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The probabilities and dS of one warpgroup's tile, in place: st (S^T, 64
// keys x N queries) becomes Z P, dpt (dP^T) becomes dS^T. Lane (g, c) of
// warp w holds keys key0 and key0 + 8 (key0 = the block's first key + 16 w +
// g), queries i0 + 8 j + 2c + {0, 1}; lse_t, dd_t: the tile's lse and D.
// EDGE: the block has a mask or runs past Tk (the keep test and the mask
// byte run only then); a dropped key gets P = dS = 0.
template <int N, bool EDGE>
__device__ __forceinline__ void probs_and_ds(float (&st)[N / 2], float (&dpt)[N / 2],
                                             const float* lse_t, const float* dd_t, int key0,
                                             int i0, int c, const unsigned char* __restrict__ mask,
                                             int Tq, int Tk, float scale, const Dropout& drop,
                                             uint32_t salt) {
  float l[N / 4], d[N / 4];  // the thread's queries 8 j + 2c + e at 2 j + e
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * c);
    const float2 y = *reinterpret_cast<const float2*>(dd_t + 8 * j + 2 * c);
    l[2 * j] = x.x;
    l[2 * j + 1] = x.y;
    d[2 * j] = y.x;
    d[2 * j + 1] = y.y;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int ci = 2 * (e >> 2) + (e & 1);
    const int qi = i0 + 8 * (e >> 2) + 2 * c + (e & 1);
    const int key = key0 + 8 * ((e >> 1) & 1);
    const float p = ex2(fmaf(st[e], scale, -l[ci]));
    float z = 1.f;
    if (drop.rate > 0.f) z = drop.keep(qi, key, salt) ? drop.scale : 0.f;
    float pz = p * z, ds = p * fmaf(dpt[e], z, -d[ci]);
    if constexpr (EDGE) {
      bool keep = key < Tk;
      if (keep && mask != nullptr && qi < Tq) keep = mask[(size_t)qi * Tk + key] != 0;
      if (!keep) pz = ds = 0.f;
    }
    st[e] = pz;
    dpt[e] = ds;
  }
}

// probs_and_ds of a partial unit under a mask: wd holds the lane's bits of
// its keys key0 and key0 + 8 (element e's at bit 2 (e >> 2) + (e & 1) of
// wd[(e >> 1) & 1]); a masked score gets P = dS = 0 by one select, no load.
// A full unit takes probs_and_ds<N, false>: no test.
template <int N>
__device__ __forceinline__ void probs_and_ds_bits(float (&st)[N / 2], float (&dpt)[N / 2],
                                                  const float* lse_t, const float* dd_t, int key0,
                                                  int i0, int c, const uint32_t (&wd)[2],
                                                  float scale, const Dropout& drop, uint32_t salt) {
  float l[N / 4], d[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * c);
    const float2 y = *reinterpret_cast<const float2*>(dd_t + 8 * j + 2 * c);
    l[2 * j] = x.x;
    l[2 * j + 1] = x.y;
    d[2 * j] = y.x;
    d[2 * j + 1] = y.y;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int ci = 2 * (e >> 2) + (e & 1);
    const float p = ex2(fmaf(st[e], scale, -l[ci]));
    float z = 1.f;
    if (drop.rate > 0.f) {
      z = drop.keep(i0 + 8 * (e >> 2) + 2 * c + (e & 1), key0 + 8 * ((e >> 1) & 1), salt)
              ? drop.scale
              : 0.f;
    }
    const bool keep = (wd[(e >> 1) & 1] >> ci) & 1u;
    st[e] = keep ? p * z : 0.f;
    dpt[e] = keep ? p * fmaf(dpt[e], z, -d[ci]) : 0.f;
  }
}

// One tile's dQ from the staging into its sums in dq_acc, by one thread: an
// atomic addition in whatever order the blocks come (the default).
__device__ __forceinline__ void reduce_dq(float* dst, const void* stage, uint32_t bytes) {
  bulk_reduce_add_f32(dst, stage, bytes);
  bulk_commit();
}

// The work of one block: key block x of (batch b, head h), and its walk over
// the head's n_qt query tiles. The default launch gives each block one item,
// from its grid coordinates, walked in tile order. Under the deterministic
// order (kernels/attention.py bwd_order is the CPU twin) each key block's dQ
// parts of a tile are added in a fixed order, counted by the tile's counter
// in `turns` (zeroed by the launch): block x waits until the counter reads
// its position in that order, adds, and adds 1 once its addition is
// complete. Two orders:
// - staggered: block x starts its walk at its own tile o_x = x n_qt / n_kb
//   and wraps round; on each tile the blocks add in the order of the step at
//   which their walks reach it, ties by x. When the blocks run in lockstep, a
//   block's predecessor on a tile reached it a step or more earlier, so no
//   block waits, and there is no chain across the head's blocks.
// - plain (key-block order): every block walks from tile 0 and block x adds
//   after x - 1.
// In both, every wait points to a block at a strictly smaller (step, x), and
// no block holds a turn while it waits for another (its addition to a tile
// completes before it waits on the next), so the waits form no cycle as long
// as the blocks waited on are resident; bwd_kernel's cooperative grid makes
// them so (see there).
struct Walk {
  int b, h, x, n_qt, n_kb;
  int o;         // the first tile of the walk
  bool stagger;  // the staggered order; else the plain one
  int lead;      // turn()'s terms that do not depend on the tile
  __device__ __forceinline__ int tile(int k) const {
    const int t = o + k;
    return t < n_qt ? t : t - n_qt;
  }
  // the blocks whose walk starts at tile v or before: ceil((v + 1) n_kb / n_qt)
  __device__ __forceinline__ int upto(int v) const { return ((v + 1) * n_kb + n_qt - 1) / n_qt; }
  // this block's position in tile t's order: the blocks whose start lies
  // (cyclically) after o and at or before t reach t at an earlier step,
  //   upto(t) - upto(o), or n_kb - upto(o) + upto(t) when t < o;
  // those that start at o too and have a smaller x tie before it,
  //   x - upto(o - 1)
  __device__ __forceinline__ unsigned turn(int t) const {
    return stagger ? lead + upto(t) + (t < o ? n_kb : 0) : x;
  }
};

// Item i of the deterministic grid (key block fastest, then head, batch).
__device__ __forceinline__ Walk walk_of(int i, int H, int n_qt, int n_kb, bool stagger) {
  const int head = i / n_kb, x = i % n_kb;
  Walk w{head / H, head % H, x, n_qt, n_kb, stagger ? x * n_qt / n_kb : 0, stagger, 0};
  if (stagger) w.lead = x - w.upto(w.o - 1) - w.upto(w.o);
  return w;
}

// ===========================================================================
// The bf16 route.
// ===========================================================================

// The deterministic order's handoffs, for consume and the writers: a tile's
// dQ staging is full (the consumers') and free again (the writer's), per
// slot of the ring of stagings; the turns.
struct Handoff {
  uint64_t* dq_full;
  uint64_t* dq_empty;
  unsigned* turns;
  uint64_t* kv_empty;  // the consumers are done with a K/V buffer (the next item's)
};

template <int D_, int NWG_, bool ORDERED_, bool MASKED_ = false>
struct Bf16Bwd {
  using T = bf16;
  static constexpr int D = D_, NWG = NWG_, ELEM = 2;
  static constexpr bool ORDERED = ORDERED_, MASKED = MASKED_;
  // Deterministic order: a ring of DQ_SLOTS dQ stagings, each added by a
  // writer of its own, the producer warpgroup's warps 1..WRITERS (idle
  // otherwise); one consumer warpgroup (two blocks an SM) has room for two
  // stagings only with a Q/dO ring of two stages.
  static constexpr int DQ_SLOTS = ORDERED ? (NWG == 2 ? 3 : 2) : NWG;
  static constexpr int WRITERS = ORDERED ? DQ_SLOTS : 0;  // a warp each
  static constexpr int WRITER_LANES = 1;                   // a writer is one thread
  static constexpr int QT = 64, KEYS = KEYS_WG * NWG, STAGES = ORDERED && NWG == 1 ? 2 : 3;
  static constexpr int HELPERS = 0;
  // K and V buffers: a block of the deterministic grid walks several items,
  // and with two consumer warpgroups the next item's K and V load while the
  // consumers finish the last's
  static constexpr int KV_BUFS = ORDERED && NWG == 2 ? 2 : 1;
  static constexpr int THREADS = 128 * (NWG + 1);
  // two consumer warpgroups hold 240 registers (one block per SM); one holds
  // 216 with two blocks per SM. The deterministic order's writers need 40 in
  // the producer warpgroup (232 for two consumer warpgroups), its consumers
  // 224 of one (32 for the producer warpgroup): with fewer, either spills.
  // MASKED, two consumer warpgroups: 40 / 232, the producer reading the map.
  // D = 128 (one consumer warpgroup, flash_mha_bwd_d128.cu): one block per
  // SM (its shared memory), no setmaxnreg: every thread may hold 255.
  static constexpr int MIN_BLOCKS = NWG == 1 && D <= 64 ? 2 : 1;
  static constexpr int PRODUCER_REGS =
      D == 128 ? 0 : ORDERED ? (NWG == 1 ? 32 : 40) : (NWG == 1 || MASKED ? 40 : 24);
  static constexpr int CONSUMER_REGS =
      D == 128 ? 0
      : ORDERED ? (NWG == 1 ? 224 : 232) : (NWG == 1 ? 216 : MASKED ? 232 : 240);
  // setmaxnreg's split of the block's registers (the launch gives each
  // thread 65536 / (THREADS MIN_BLOCKS), rounded down to 8): what the
  // producer warpgroup gives up, the consumers take, or setmaxnreg.inc waits
  // for ever
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * MIN_BLOCKS) / 8 * 8;
  static_assert((LAUNCH_REGS - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - LAUNCH_REGS) * 128 * NWG,
                "the consumers would take more registers than the producer gives up");
  using I = RowImage<2 * D>;
  static constexpr uint32_t Q_BYTES = QT * D * 2;     // a Q or dO tile image
  static constexpr uint32_t KV_BYTES = KEYS * D * 2;  // the K or V image
  static constexpr uint32_t STAGE = 2 * Q_BYTES;
  static constexpr uint32_t DS_BYTES = KEYS * QT * 2;  // dS^T: KEYS rows of 128 bytes
  static constexpr uint32_t DQ_BYTES = QT * D * 4;     // a tile's dQ, fp32, to reduce
  // MASKED: a partial unit's bits (KEYS x 4 uint16) in its stage, and each
  // stage's unit (tile << 1 | partial)
  static constexpr uint32_t WORDS = MASKED ? KEYS * 4 * 2 : 0, UNIT_BYTES = MASKED ? 16 : 0;
  // shared memory: K, V (per buffer), the ring of (Q, dO) tiles, two dS^T
  // tiles, the dQ stagings (one per warpgroup, or the deterministic ring),
  // the ring's stats, (MASKED) its bits and units, the barriers (every image
  // 1024-byte aligned)
  static constexpr uint32_t K_DST = 0, RING = 2 * KV_BUFS * KV_BYTES;  // V after each K
  static constexpr uint32_t DS = RING + STAGES * STAGE, DQ = DS + 2 * DS_BYTES;
  static constexpr uint32_t STATS = DQ + DQ_SLOTS * DQ_BYTES;
  static constexpr uint32_t BITS = STATS + STAGES * 2 * QT * 4, UNITS = BITS + STAGES * WORDS;
  static constexpr uint32_t BARS = UNITS + UNIT_BYTES;
  static constexpr size_t SMEM = 1024 + BARS + bar_bytes(STAGES);
  static constexpr size_t SMEM_LAUNCH = NWG == 1 || SMEM > 118 * 1024 ? SMEM : 118 * 1024;
  static_assert(SMEM <= (MIN_BLOCKS == 2 ? 113 : 227) * 1024,
                "shared memory over the plan's blocks");
  static_assert(DQ_SLOTS <= MAX_SLOTS && WRITERS <= 3 && STAGES <= 4,
                "the ring's barriers, writers or units");

  static __device__ void consume(unsigned char* base, uint64_t* full, uint64_t* empty,
                                 uint64_t* kv_full, uint64_t* aux, const Walk& w, uint32_t u0,
                                 int item, const Units& un, const Handoff& hand,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ dq_acc, T* __restrict__ dk,
                                 T* __restrict__ dv, int Tq, int Tk, int H, float scale,
                                 float sm_scale, Dropout drop);
  // Writer `wr` (the deterministic order; lane 0 of producer warp 1 + wr):
  // the item's steps u = wr (mod DQ_SLOTS), from slot wr of the ring: wait
  // for the staging, the turn, reduce, free the staging once read, pass the
  // turn once the addition is complete. MASKED: the item's listed units,
  // each tile's turn from the map.
  static __device__ void write(unsigned char* base, const Walk& w, uint32_t u0, const Units& un,
                               const Handoff& hand, float* __restrict__ dq_acc, int H, int wr) {
    const size_t head = (size_t)(w.b * H + w.h) * w.n_qt;
    float* const acc = dq_acc + head * QT * D;
    unsigned* const turns = hand.turns + head;
    const int n = MASKED ? un.n : w.n_qt;
    for (int k = (wr - (int)(u0 % DQ_SLOTS) + DQ_SLOTS) % DQ_SLOTS; k < n; k += DQ_SLOTS) {
      mbar_wait(&hand.dq_full[wr], ((u0 + k) / DQ_SLOTS) & 1);
      int t;
      unsigned mine;
      if constexpr (MASKED) {
        const int i = un.at(k);
        t = un.ent[i] >> 1;
        mine = un.turn[i];
      } else {
        t = w.tile(k);
        mine = w.turn(t);
      }
      turn_wait(turns + t, mine);
      reduce_dq(acc + t * QT * D, base + DQ + wr * DQ_BYTES, DQ_BYTES);
      bulk_wait_read<0>();
      mbar_arrive(&hand.dq_empty[wr]);
      turn_pass(turns + t);
    }
  }
  // dQ's sums to bf16
  static void epilogue(const float* acc, T* dq, int B, int Tq, int H, cudaStream_t stream) {
    const size_t n = (size_t)B * Tq * H * (D / 8);
    bwd_dq_bf16_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(acc, dq, B, Tq, H);
  }
};

template <int D, int NWG, bool ORDERED, bool MASKED>
__device__ void Bf16Bwd<D, NWG, ORDERED, MASKED>::consume(
    unsigned char* base, uint64_t* full, uint64_t* empty, uint64_t* kv_full, uint64_t*,
    const Walk& w, uint32_t u0, int item_, const Units& un, const Handoff& hand,
    const unsigned char* __restrict__ mask, float* __restrict__ dq_acc, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, float scale, float sm_scale, Dropout drop) {
  constexpr int W = I::W;
  constexpr uint64_t L = I::LAYOUT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, wi = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int b = w.b, h = w.h, j0 = w.x * KEYS;
  const int n_qt = w.n_qt, C = H * D;
  // this item's K/V buffer, and which of its fills this is
  const int item = MASKED ? item_ : u0 / n_qt, kb = item % KV_BUFS;
  const uint32_t k_img = smem_addr(base + K_DST + kb * 2 * KV_BYTES), v_img = k_img + KV_BYTES;
  const uint32_t ring = smem_addr(base + RING);
  const float* stats_s = reinterpret_cast<const float*>(base + STATS);
  const int row0 = KEYS_WG * wg + 16 * wi + g;  // the thread's first key in the block
  const bool edge = mask != nullptr || j0 + KEYS > Tk;
  const uint32_t salt = drop.salt(b * H + h);
  const int n = MASKED ? un.n : n_qt;  // the item's units: its listed tiles, or every tile

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  mbar_wait(&kv_full[kb], (item / KV_BUFS) & 1);

  for (int k = 0; k < n; ++k) {
    // step u of the block's walks (its earlier items' steps included), on tile t
    const uint32_t u = u0 + k;
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    int t = ORDERED ? w.tile(k) : k;
    uint32_t wd[2] = {0u, 0u};  // MASKED, a partial unit: the lane's bits of its two keys
    bool partial = false;
    if constexpr (MASKED) {  // the unit and its bits, from the stage
      const int unit = reinterpret_cast<const int*>(base + UNITS)[s];
      t = unit >> 1;
      partial = unit & 1;
      if (partial) {
        const uint16_t* bits = reinterpret_cast<const uint16_t*>(base + BITS + s * WORDS);
        wd[0] = bits[row0 * 4 + c];
        wd[1] = bits[(row0 + 8) * 4 + c];
      }
    }
    const int i0 = t * QT;
    const uint32_t q_img = ring + s * STAGE, do_img = q_img + Q_BYTES;

    // S^T = K Q^T and dP^T = V dO^T (this warpgroup's 64 keys x 64 queries)
    float st[QT / 2], dpt[QT / 2];
    fence_all(st);
    fence_all(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      // channels 16 ks..16 ks + 15: box 32 ks / W, 32 ks % W bytes into its rows
      const uint32_t box = 32 * ks / W, inner = 32 * ks % W;
      const uint32_t a = box * KEYS * W + KEYS_WG * wg * W + inner, bq = box * QT * W + inner;
      MmaBf16SS<QT>::run(st, swizzled_desc(k_img + a, 16, 8 * W, L),
                         swizzled_desc(q_img + bq, 16, 8 * W, L), ks > 0);
      MmaBf16SS<QT>::run(dpt, swizzled_desc(v_img + a, 16, 8 * W, L),
                         swizzled_desc(do_img + bq, 16, 8 * W, L), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(st);
    fence_all(dpt);

    const float* lse_t = stats_s + s * 2 * QT;
    if constexpr (D == 128) {
      // four quarters of 16 queries, each with its 4 + 4 of the tile's lse
      // and D: all 32 held at once beside dK's and dV's 128 spilled
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float(&sh)[8] = reinterpret_cast<float(&)[8]>(st[8 * h]);
        float(&dh)[8] = reinterpret_cast<float(&)[8]>(dpt[8 * h]);
        const float* lh = lse_t + 16 * h;
        if (MASKED && partial) {
          const uint32_t wh[2] = {wd[0] >> (4 * h), wd[1] >> (4 * h)};
          probs_and_ds_bits<16>(sh, dh, lh, lh + QT, j0 + row0, i0 + 16 * h, c, wh, scale, drop,
                                salt);
        } else if (!MASKED && edge) {
          probs_and_ds<16, true>(sh, dh, lh, lh + QT, j0 + row0, i0 + 16 * h, c, mask, Tq, Tk,
                                 scale, drop, salt);
        } else {
          probs_and_ds<16, false>(sh, dh, lh, lh + QT, j0 + row0, i0 + 16 * h, c, mask, Tq, Tk,
                                  scale, drop, salt);
        }
      }
    } else if (MASKED && partial) {
      probs_and_ds_bits<QT>(st, dpt, lse_t, lse_t + QT, j0 + row0, i0, c, wd, scale, drop, salt);
    } else if (!MASKED && edge) {
      probs_and_ds<QT, true>(st, dpt, lse_t, lse_t + QT, j0 + row0, i0, c, mask, Tq, Tk, scale,
                             drop, salt);
    } else {
      probs_and_ds<QT, false>(st, dpt, lse_t, lse_t + QT, j0 + row0, i0, c, mask, Tq, Tk, scale,
                              drop, salt);
    }
    // Z P and dS^T as bf16 A fragments: 16 queries per fragment, pairwise
    uint32_t pz[QT / 16][4], dsf[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pz[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsf[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }

    // dV += (Z P)^T dO, dK += dS^T Q: queries the reduction, the tiles MN-major
    fence_all(acc_dv);
    fence_all(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      MmaBf16<D, 1>::run(acc_dv, pz[kk],
                         swizzled_desc(do_img + kk * 16 * W, QT * W, 8 * W, L), 1);
      MmaBf16<D, 1>::run(acc_dk, dsf[kk],
                         swizzled_desc(q_img + kk * 16 * W, QT * W, 8 * W, L), 1);
    }
    wgmma_commit();

    // dS^T to shared memory: KEYS rows (keys) of 64 queries, swizzled at 128
    // bytes; lane (g, c) writes queries 8 j + 2c, + 1 of its two rows
    unsigned char* ds_tile = base + DS + (u & 1) * DS_BYTES;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf;
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ds_tile + r * 128 + ((j ^ (r & 7)) << 4) + 4 * c) =
            dsf[j >> 1][2 * (j & 1) + hf];
      }
    }
    fence_proxy_async();
    // Warpgroup u % NWG issues this tile's dQ: it waits for every
    // warpgroup's dS^T, the others only announce theirs. (A warpgroup that
    // writes this buffer again, two tiles on, has passed the next tile's
    // barrier, which the issuing warpgroup opens after this dQ is done.)
    const int owner = u % NWG;
    if (wg != owner) {
      named_bar_arrive(BAR_DS0 + owner, 128 * NWG);
      wgmma_wait<0>();
    } else {  // this tile's dQ = dS K over the block's keys
      if (!ORDERED && threadIdx.x % 128 == 0) bulk_wait_read<0>();  // its staging is free again
      named_bar_sync(BAR_DS0 + owner, 128 * NWG);
      const uint32_t ds_img = smem_addr(ds_tile);
      int slot;
      float2* stage;
      if constexpr (D == 128) {
        // dQ in two halves of 64 channels (K's two boxes), each staged before
        // the next: a 64 x 128 accumulator beside dK's and dV's would not fit
        // in 255 registers
        slot = ORDERED ? u % DQ_SLOTS : wg;
        if (ORDERED && u >= DQ_SLOTS) mbar_wait(&hand.dq_empty[slot], (u / DQ_SLOTS - 1) & 1);
        stage = reinterpret_cast<float2*>(base + DQ + slot * DQ_BYTES);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float dq[32];
          fence_all(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk) {
            MmaBf16SS<64, 1, 1>::run(
                dq, swizzled_desc(ds_img + kk * 16 * 128, KEYS * 128, 8 * 128, 1),
                swizzled_desc(k_img + half * KEYS * W + kk * 16 * W, KEYS * W, 8 * W, L), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_all(dq);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              stage[((wi * (D / 8) + 8 * half + j) * 2 + hf) * 32 + lane] =
                  make_float2(dq[4 * j + 2 * hf] * sm_scale, dq[4 * j + 2 * hf + 1] * sm_scale);
            }
          }
        }
      } else {
        float dq[D / 2];
        fence_all(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          MmaBf16SS<D, 1, 1>::run(dq, swizzled_desc(ds_img + kk * 16 * 128, KEYS * 128, 8 * 128, 1),
                                  swizzled_desc(k_img + kk * 16 * W, KEYS * W, 8 * W, L), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_all(dq);
        // to the staging in fragment order, then one bulk reduction into the
        // tile's sums (rows past Tq add zeros to the padding): by this
        // warpgroup's first thread, or (deterministic) by the slot's writer
        slot = ORDERED ? u % DQ_SLOTS : wg;
        if (ORDERED && u >= DQ_SLOTS) mbar_wait(&hand.dq_empty[slot], (u / DQ_SLOTS - 1) & 1);
        stage = reinterpret_cast<float2*>(base + DQ + slot * DQ_BYTES);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            stage[((wi * (D / 8) + j) * 2 + hf) * 32 + lane] =
                make_float2(dq[4 * j + 2 * hf] * sm_scale, dq[4 * j + 2 * hf + 1] * sm_scale);
          }
        }
      }
      fence_proxy_async();
      named_bar_sync(BAR_WG0 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        if constexpr (ORDERED) {
          mbar_arrive(&hand.dq_full[slot]);
        } else {
          const size_t tile = (size_t)(b * H + h) * n_qt + t;
          reduce_dq(dq_acc + tile * QT * D, stage, DQ_BYTES);
        }
      }
    }
    fence_all(acc_dv);
    fence_all(acc_dk);
    fence_all(pz);
    fence_all(dsf);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp's products are done with the stage
  }
  // the last reductions have landed (deterministic: the writers wait for theirs)
  if (!ORDERED && threadIdx.x % 128 == 0) bulk_wait_all();
  if (ORDERED && lane == 0) mbar_arrive(&hand.kv_empty[kb]);  // this warp is done with K, V

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = j0 + row0 + 8 * hf;
    if (key >= Tk) continue;
    const size_t at = ((size_t)b * Tk + key) * C + h * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(acc_dk[4 * j + 2 * hf] * sm_scale, acc_dk[4 * j + 2 * hf + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(acc_dv[4 * j + 2 * hf], acc_dv[4 * j + 2 * hf + 1]);
    }
  }
}

// ===========================================================================
// The fp32 route (3xTF32).
// ===========================================================================

// Float offset of (row r, reduction index k) in a K-major operand image of
// core matrices (8 rows x 4 values, 128 contiguous bytes), those of one group
// of 8 rows side by side over the K reduction values: descriptor LBO = 128
// (the next 4 values), SBO = 32 K (the next 8 rows); a step of 8 values is
// 256 bytes.
template <int K>
__host__ __device__ constexpr int kmajor(int r, int k) {
  return ((r >> 3) * (K / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// Float offset of (row n, query j) in the image of a B operand against a
// passed accumulator, K = J queries (flash_mha.cu's V^T): core matrices of 8
// rows x 4 k-positions, query j of each group of 8 at k-position (j % 8) / 2
// + 4 (j % 2): LBO = 128, SBO = 32 J.
template <int J>
__host__ __device__ constexpr int passed(int n, int j) {
  return ((n >> 3) * (J / 4) + 2 * (j >> 3) + (j & 1)) * 32 + (n & 7) * 4 + ((j & 7) >> 1);
}

// The float4 walks of the image builders: float4 f of an image is row f % 8
// of core matrix f / 8.
template <int R, int K>
constexpr bool kmajor_walk_ok() {
  for (int f = 0; f < R * K / 4; ++f) {
    const int cm = f >> 3, r = f & 7;
    for (int e = 0; e < 4; ++e) {
      if (kmajor<K>(8 * (cm / (K / 4)) + r, 4 * (cm % (K / 4)) + e) != 4 * f + e) return false;
    }
  }
  return true;
}
template <int N, int J>
constexpr bool passed_walk_ok() {
  for (int f = 0; f < N * J / 4; ++f) {
    const int cm = f >> 3, r = f & 7, kc = cm % (J / 4);
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * (kc >> 1) + (kc & 1) + 2 * e;
      if (passed<J>(8 * (cm / (J / 4)) + r, j) != 4 * f + e) return false;
    }
  }
  return true;
}
static_assert(kmajor_walk_ok<64, 64>() && passed_walk_ok<32, 32>() && passed_walk_ok<48, 32>() &&
                  passed_walk_ok<64, 32>(),
              "an image builder's walk disagrees with its layout");

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_hi(x);
  lo = x - hi;
}
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

template <int D_, bool ORDERED_, bool MASKED_ = false>
struct F32Bwd {
  using T = float;
  static constexpr int D = D_, NWG = 1, ELEM = 4;
  static constexpr bool ORDERED = ORDERED_, MASKED = MASKED_;
  static constexpr int QT = 32, KEYS = KEYS_WG, STAGES = 2, MIN_BLOCKS = 1, THREADS = 256;
  // the producer warpgroup's other three warps build the passed images; under
  // the deterministic order the last of them is the writer instead (the
  // shared memory is full: it takes each step's staging into its registers)
  static constexpr int WRITERS = ORDERED ? 1 : 0, HELPERS = 3 - WRITERS, DQ_SLOTS = 1;
  static constexpr int WRITER_LANES = 32, KV_BUFS = 1;
  static constexpr int PRODUCER_REGS = 0, CONSUMER_REGS = 0;  // no setmaxnreg: 255 for all
  using I = RowImage<4 * D>;                         // a raw fp32 row of a head
  static constexpr uint32_t Q_BYTES = QT * D * 4;    // a raw Q or dO tile
  static constexpr uint32_t KV_BYTES = KEYS * D * 4;  // raw K or V
  static constexpr uint32_t STAGE = 2 * Q_BYTES;
  // The raw K, V, Q and dO tiles (fp32, swizzled K-major by the copies) are
  // the hi parts of the operands that wgmma reads K-major over the channels:
  // the tensor core reads an fp32 operand as its TF32 truncation, tf32_hi
  // (held on the card: tests/test_torch_cuda.py, the fp32 backward to 1e-4).
  // The lo parts lie in the same layout. The rest are images (floats): K^T
  // (A of dQ^T: 64 rows, D channels and padding, x 64 keys); per tile Q^T,
  // dO^T (B of dK, dV: D x 32 passed queries); dS (B of dQ^T: 32 queries x
  // 64 keys); each hi then lo.
  // Shared memory: raw K, V, their lo parts, the ring of raw (Q, dO) tiles,
  // the lo parts of the tile's Q and dO, K^T, two buffers of passed images
  // (Q^T hi, lo, dO^T hi, lo), dS, the ring's stats, the barriers.
  static constexpr uint32_t KT_IMG = 64 * KEYS * 4, Q_IMG = QT * D * 4, DS_IMG = QT * KEYS * 4;
  static constexpr uint32_t K_DST = 0, V_DST = KV_BYTES, K_LO = 2 * KV_BYTES;
  static constexpr uint32_t V_LO = K_LO + KV_BYTES, RING = V_LO + KV_BYTES;
  static constexpr uint32_t QN_LO = RING + STAGES * STAGE, DON_LO = QN_LO + Q_BYTES;
  static constexpr uint32_t TR_BYTES = 4 * Q_IMG;
  static constexpr uint32_t KT_HI = DON_LO + Q_BYTES, TR = KT_HI + 2 * KT_IMG;
  static constexpr uint32_t DS_HI = TR + 2 * TR_BYTES;
  // a tile's dQ^T (fp32) is staged for its reduction where its dS was
  static constexpr uint32_t DQ_BYTES = QT * D * 4, DQ = DS_HI, STATS = DS_HI + 2 * DS_IMG;
  static_assert(DQ_BYTES <= 2 * DS_IMG, "dQ^T's staging fits in dS's image");
  // MASKED: a partial unit's bits (KEYS x 4 bytes) in its stage, and each
  // stage's unit (tile << 1 | partial)
  static constexpr uint32_t WORDS = MASKED ? KEYS * 4 : 0, UNIT_BYTES = MASKED ? 16 : 0;
  static constexpr uint32_t BITS = STATS + STAGES * 2 * QT * 4, UNITS = BITS + STAGES * WORDS;
  static constexpr uint32_t BARS = UNITS + UNIT_BYTES;
  static constexpr size_t SMEM = 1024 + BARS + bar_bytes(STAGES);
  static constexpr size_t SMEM_LAUNCH = SMEM;
  static_assert(SMEM <= 227 * 1024, "the fp32 images exceed a block's shared memory");

  static __device__ void consume(unsigned char* base, uint64_t* full, uint64_t* empty,
                                 uint64_t* kv_full, uint64_t* aux, const Walk& w, uint32_t u0,
                                 int item, const Units& un, const Handoff& hand,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ dq_acc, T* __restrict__ dk,
                                 T* __restrict__ dv, int Tq, int Tk, int H, float scale,
                                 float sm_scale, Dropout drop);
  // The writer warp (the deterministic order): each step's dQ^T staging into
  // its registers (D / 4 float4s a lane), the staging freed, the turn (every
  // lane's acquire load is the same one load), the addition by vector
  // atomics (red.global.add.v4.f32), then each lane's fence and the release.
  // MASKED: the item's listed units, each tile's turn from the map.
  static __device__ void write(unsigned char* base, const Walk& w, uint32_t u0, const Units& un,
                               const Handoff& hand, float* __restrict__ dq_acc, int H, int) {
    constexpr int N = DQ_BYTES / 16 / 32;
    const int lane = threadIdx.x % 32;
    const int n = MASKED ? un.n : w.n_qt;
    for (int k = 0; k < n; ++k) {
      const uint32_t u = u0 + k;
      mbar_wait(hand.dq_full, u & 1);
      float4 x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const float4*>(base + DQ)[lane + 32 * i];
      __syncwarp();
      if (lane == 0) mbar_arrive(hand.dq_empty);
      int t;
      unsigned mine;
      if constexpr (MASKED) {
        const int i = un.at(k);
        t = un.ent[i] >> 1;
        mine = un.turn[i];
      } else {
        t = w.tile(k);
        mine = w.turn(t);
      }
      const size_t tile = (size_t)(w.b * H + w.h) * w.n_qt + t;
      turn_acquire(hand.turns + tile, mine);
      float4* dst = reinterpret_cast<float4*>(dq_acc + tile * QT * D);
#pragma unroll
      for (int i = 0; i < N; ++i) atomicAdd(dst + lane + 32 * i, x[i]);
      __threadfence();
      __syncwarp();
      if (lane == 0) turn_release(hand.turns + tile);
    }
  }
  // dQ^T's sums to dQ
  static void epilogue(const float* acc, T* dq, int B, int Tq, int H, cudaStream_t stream) {
    const size_t n = (size_t)B * Tq * H * (D / 8);
    bwd_dq_f32_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(acc, dq, B, Tq, H);
  }

  // element (r, ch) of a raw tile of `rows` rows at `raw` (swizzled at W)
  static __device__ __forceinline__ float raw1(const unsigned char* raw, int rows, int r, int ch) {
    return *reinterpret_cast<const float*>(raw + I::offset(rows, r, 4 * ch));
  }
  // the lo part of a raw tile of BYTES bytes, in its layout: every load
  // issued before the first store
  template <uint32_t BYTES>
  static __device__ __forceinline__ void build_lo(unsigned char* lo, const unsigned char* raw) {
    constexpr int N = BYTES / 16 / 128;
    static_assert(N * 16 * 128 == BYTES, "a whole number of float4s a thread");
    float4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const float4*>(raw)[threadIdx.x + 128 * i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float4 h4, l4;
      split4(x[i], h4, l4);
      reinterpret_cast<float4*>(lo)[threadIdx.x + 128 * i] = l4;
    }
  }
  // The passed images (D x QT, hi and lo) of a tile's raw Q and dO, by
  // `threads` threads from `tid`, two float4s of each a round, loads first.
  static __device__ __forceinline__ void build_passed(float* q_hi, float* do_hi,
                                                      const unsigned char* raw_q,
                                                      const unsigned char* raw_do, int tid,
                                                      int threads) {
    constexpr int N = D * QT / 4;
    for (int f0 = tid; f0 < N; f0 += 2 * threads) {
      float4 xq[2], xo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = min(f0 + i * threads, N - 1), cm = x >> 3, r = x & 7;
        const int ch = 8 * (cm / (QT / 4)) + r, kc = cm % (QT / 4), q0 = 8 * (kc >> 1) + (kc & 1);
        xq[i] = make_float4(raw1(raw_q, QT, q0, ch), raw1(raw_q, QT, q0 + 2, ch),
                            raw1(raw_q, QT, q0 + 4, ch), raw1(raw_q, QT, q0 + 6, ch));
        xo[i] = make_float4(raw1(raw_do, QT, q0, ch), raw1(raw_do, QT, q0 + 2, ch),
                            raw1(raw_do, QT, q0 + 4, ch), raw1(raw_do, QT, q0 + 6, ch));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = f0 + i * threads;
        if (x >= N) break;
        float4 h4, l4;
        split4(xq[i], h4, l4);
        reinterpret_cast<float4*>(q_hi)[x] = h4;
        reinterpret_cast<float4*>(q_hi + N * 4)[x] = l4;
        split4(xo[i], h4, l4);
        reinterpret_cast<float4*>(do_hi)[x] = h4;
        reinterpret_cast<float4*>(do_hi + N * 4)[x] = l4;
      }
    }
  }

  // The helper warps: step u's passed images into buffer u % 2, once its
  // raw tiles are in and the products of step u - 2 are done with the buffer.
  static __device__ void help(unsigned char* base, uint64_t* full, uint64_t* empty,
                              uint64_t* aux, int n, uint32_t u0) {  // n: the item's steps
    uint64_t* tr_full = aux;
    uint64_t* tr_empty = aux + 2;
    float* const f = reinterpret_cast<float*>(base);
    const int tid = threadIdx.x - 128 * NWG - 32;
    for (uint32_t u = u0; u < u0 + n; ++u) {
      const int s = u % STAGES, buf = u & 1;
      if (u >= 2) mbar_wait(&tr_empty[buf], ((u >> 1) - 1) & 1);
      mbar_wait(&full[s], (u / STAGES) & 1);
      const unsigned char* raw_q = base + RING + s * STAGE;
      const uint32_t tr = TR + buf * TR_BYTES;
      build_passed(f + tr / 4, f + (tr + 2 * Q_IMG) / 4, raw_q, raw_q + Q_BYTES, tid,
                   32 * HELPERS);
      fence_proxy_async();
      __syncwarp();
      if (threadIdx.x % 32 == 0) {
        mbar_arrive(&tr_full[buf]);
        mbar_arrive(&empty[s]);  // this warp is done with the raw tiles
      }
    }
  }
};

template <int D, bool ORDERED, bool MASKED>
__device__ void F32Bwd<D, ORDERED, MASKED>::consume(
    unsigned char* base, uint64_t* full, uint64_t* empty, uint64_t* kv_full, uint64_t* aux,
    const Walk& w, uint32_t u0, int item, const Units& un, const Handoff& hand,
    const unsigned char* __restrict__ mask, float* __restrict__ dq_acc, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, float scale, float sm_scale, Dropout drop) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wi = warp;
  const int g = lane / 4, c = lane % 4;
  const int b = w.b, h = w.h, j0 = w.x * KEYS;
  const int n_qt = w.n_qt, C = H * D;
  float* const f = reinterpret_cast<float*>(base);
  const uint32_t s0 = smem_addr(base);
  const float* stats_s = reinterpret_cast<const float*>(base + STATS);
  const int row0 = 16 * wi + g;  // the thread's first key in the block
  const bool edge = mask != nullptr || j0 + KEYS > Tk;
  const uint32_t salt = drop.salt(b * H + h);
  const int n = MASKED ? un.n : n_qt;  // the item's units: its listed tiles, or every tile

  // the lo parts of K and V, and the K^T image, from the raw K and V
  mbar_wait(kv_full, (MASKED ? item : u0 / n_qt) & 1);  // one K/V buffer
  build_lo<KV_BYTES>(base + K_LO, base + K_DST);
  build_lo<KV_BYTES>(base + V_LO, base + V_DST);
  // K^T: channel rows, keys along in the order of dS's image: k-position
  // 16 w + 2 g + b holds key 16 w + 8 b + g (the two keys of a thread side by side)
  for (int x = threadIdx.x; x < 64 * KEYS / 4; x += 128) {
    const int cm = x >> 3, r = x & 7, ch = 8 * (cm / (KEYS / 4)) + r, k0 = 4 * (cm % (KEYS / 4));
    float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f), h4, l4;
    if (ch < D) {
      const int key0 = 16 * (k0 >> 4) + (k0 & 15) / 2;  // k0..k0 + 3: key0, + 8, + 1, + 9
      v4 = make_float4(raw1(base + K_DST, KEYS, key0, ch), raw1(base + K_DST, KEYS, key0 + 8, ch),
                       raw1(base + K_DST, KEYS, key0 + 1, ch),
                       raw1(base + K_DST, KEYS, key0 + 9, ch));
    }
    split4(v4, h4, l4);
    reinterpret_cast<float4*>(f + KT_HI / 4)[x] = h4;
    reinterpret_cast<float4*>(f + KT_HI / 4 + KT_IMG / 4)[x] = l4;
  }
  fence_proxy_async();
  named_bar_sync(BAR_WG0, 128);

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  constexpr uint32_t LBO = 128, SB_Q = 32 * QT, SB_K = 32 * KEYS;

  for (int k = 0; k < n; ++k) {
    // step u of the block's walks (its earlier items' steps included), on tile t
    const uint32_t u = u0 + k;
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    int t = ORDERED ? w.tile(k) : k;
    uint32_t wd[2] = {0u, 0u};  // MASKED, a partial unit: the lane's bits of its two keys
    bool partial = false;
    if constexpr (MASKED) {  // the unit and its bits, from the stage
      const int unit = reinterpret_cast<const int*>(base + UNITS)[s];
      t = unit >> 1;
      partial = unit & 1;
      if (partial) {
        const unsigned char* bits = base + BITS + s * WORDS;
        wd[0] = bits[row0 * 4 + c];
        wd[1] = bits[(row0 + 8) * 4 + c];
      }
    }
    const int i0 = t * QT;
    const unsigned char* raw_q = base + RING + s * STAGE;
    const unsigned char* raw_do = raw_q + Q_BYTES;
    // the lo parts of the tile's Q and dO (B of S^T, dP^T)
    build_lo<Q_BYTES>(base + QN_LO, raw_q);
    build_lo<Q_BYTES>(base + DON_LO, raw_do);
    fence_proxy_async();
    if (!ORDERED && threadIdx.x == 0) bulk_wait_read<0>();  // dS's image (dQ^T's staging) is free
    named_bar_sync(BAR_WG0, 128);

    // S^T = K Q^T and dP^T = V dO^T, 3xTF32, both operands from shared memory
    float st[QT / 2], dpt[QT / 2];
    fence_all(st);
    fence_all(dpt);
    wgmma_fence();
    const uint32_t q_hi = smem_addr(raw_q), do_hi = smem_addr(raw_do);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {  // a_lo b_hi, a_hi b_lo, a_hi b_hi
      const uint32_t k_a = s0 + (pass == 0 ? K_LO : K_DST), v_a = s0 + (pass == 0 ? V_LO : V_DST);
      const uint32_t q_b = pass == 1 ? s0 + QN_LO : q_hi, do_b = pass == 1 ? s0 + DON_LO : do_hi;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        // channels 8 ks..8 ks + 7: box 32 ks / W, 32 ks % W bytes into its rows
        const uint32_t box = 32 * ks / I::W, inner = 32 * ks % I::W;
        const uint32_t a = box * KEYS * I::W + inner, bq = box * QT * I::W + inner;
        MmaTf32SS32::run(st, swizzled_desc(k_a + a, 16, 8 * I::W, I::LAYOUT),
                         swizzled_desc(q_b + bq, 16, 8 * I::W, I::LAYOUT), pass > 0 || ks > 0);
        MmaTf32SS32::run(dpt, swizzled_desc(v_a + a, 16, 8 * I::W, I::LAYOUT),
                         swizzled_desc(do_b + bq, 16, 8 * I::W, I::LAYOUT), pass > 0 || ks > 0);
      }
    }
    wgmma_commit();

    wgmma_wait<0>();
    fence_all(st);
    fence_all(dpt);

    const float* lse_s = stats_s + s * 2 * QT;
    if (MASKED && partial) {
      probs_and_ds_bits<QT>(st, dpt, lse_s, lse_s + QT, j0 + row0, i0, c, wd, scale, drop, salt);
    } else if (!MASKED && edge) {
      probs_and_ds<QT, true>(st, dpt, lse_s, lse_s + QT, j0 + row0, i0, c, mask, Tq, Tk, scale,
                             drop, salt);
    } else {
      probs_and_ds<QT, false>(st, dpt, lse_s, lse_s + QT, j0 + row0, i0, c, mask, Tq, Tk,
                              scale, drop, salt);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // the raw tile and its stats are read
    // (deterministic) the writer has taken the last step's staging out of dS's image
    if (ORDERED && u >= 1) mbar_wait(hand.dq_empty, (u - 1) & 1);

    // dS (queries x keys, K-major over keys) for dQ^T, split; the thread's
    // keys row0 and row0 + 8 side by side at k-positions 16 w + 2 g, + 1
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int at = DS_HI / 4 + kmajor<KEYS>(8 * j + 2 * c + u, 16 * wi + 2 * g);
        float2 hi, lo;
        split(dpt[4 * j + u], hi.x, lo.x);
        split(dpt[4 * j + 2 + u], hi.y, lo.y);
        *reinterpret_cast<float2*>(f + at) = hi;
        *reinterpret_cast<float2*>(f + at + DS_IMG / 4) = lo;
      }
    }
    fence_proxy_async();

    // A fragments of Z P, then of dS^T (in the same registers, once dV is
    // done with P's), split, in the passed k-position order: k-positions c
    // and c + 4 of query group j are queries 2c and 2c + 1
    uint32_t ah[QT / 8][4], al[QT / 8][4];
    auto fragments = [&](const float(&x)[QT / 2]) {
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float xs[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hi, lo;
          split(xs[e], hi, lo);
          ah[j][e] = __float_as_uint(hi);
          al[j][e] = __float_as_uint(lo);
        }
      }
    };
    fragments(st);
    named_bar_sync(BAR_WG0, 128);  // every warp's dS is in
    mbar_wait(&aux[u & 1], (u >> 1) & 1);  // the helpers' Q^T and dO^T of this tile
    const uint32_t q_tr = s0 + TR + (u & 1) * TR_BYTES, do_tr = q_tr + 2 * Q_IMG;
    fence_all(ah);
    fence_all(al);

    // this tile's dV = (Z P)^T dO and dK = dS^T Q, each in an accumulator of
    // its own (added to the totals in fp32 below), and dQ^T = K^T dS^T: rows
    // the channels (D of the 64; the rest padding). Groups: dV, dQ^T, dK.
    float dv_t[D / 2], dk_t[D / 2], dqt[QT / 2];
    fence_all(dv_t);
    fence_all(dqt);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        MmaTf32<D>::run(dv_t, pass == 0 ? al[j] : ah[j],
                        smem_desc(do_tr + (pass == 1 ? Q_IMG : 0) + 256 * j, LBO, SB_Q),
                        pass > 0 || j > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t ao = pass == 0 ? KT_IMG : 0, bo = pass == 1 ? DS_IMG : 0;
#pragma unroll
      for (int ks = 0; ks < KEYS / 8; ++ks) {
        MmaTf32SS32::run(dqt, smem_desc(s0 + KT_HI + ao + 256 * ks, LBO, SB_K),
                         smem_desc(s0 + DS_HI + bo + 256 * ks, LBO, SB_K), pass > 0 || ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // dV: P's fragments are free
    fence_all(dv_t);
    fence_all(ah);
    fence_all(al);
    fragments(dpt);
    fence_all(ah);
    fence_all(al);
    fence_all(dk_t);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        MmaTf32<D>::run(dk_t, pass == 0 ? al[j] : ah[j],
                        smem_desc(q_tr + (pass == 1 ? Q_IMG : 0) + 256 * j, LBO, SB_Q),
                        pass > 0 || j > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc_dv[e] += dv_t[e];
    wgmma_wait<0>();
    fence_all(dk_t);
    fence_all(dqt);
    fence_all(ah);
    fence_all(al);
    if (lane == 0) mbar_arrive(&aux[2 + (u & 1)]);  // done with the passed images
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc_dk[e] += dk_t[e];
    // dQ^T to the staging in fragment order (the warps of real channels),
    // then one bulk reduction into the tile's sums
    if (wi < D / 16) {
      float2* stage = reinterpret_cast<float2*>(base + DQ);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          stage[((wi * (QT / 8) + j) * 2 + hf) * 32 + lane] =
              make_float2(dqt[4 * j + 2 * hf] * sm_scale, dqt[4 * j + 2 * hf + 1] * sm_scale);
        }
      }
    }
    fence_proxy_async();
    // the staging is in; and every warp's products are done with the images
    named_bar_sync(BAR_WG0, 128);
    if (threadIdx.x == 0) {
      if constexpr (ORDERED) {
        mbar_arrive(hand.dq_full);  // to the writer
      } else {
        const size_t tile = (size_t)(b * H + h) * n_qt + t;
        reduce_dq(dq_acc + tile * QT * D, base + DQ, DQ_BYTES);
      }
    }
  }
  if (!ORDERED && threadIdx.x == 0) bulk_wait_all();  // the last reductions have landed
  if (ORDERED && lane == 0) mbar_arrive(hand.kv_empty);  // this warp is done with K, V

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = j0 + row0 + 8 * hf;
    if (key >= Tk) continue;
    const size_t at = ((size_t)b * Tk + key) * C + h * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(acc_dk[4 * j + 2 * hf] * sm_scale, acc_dk[4 * j + 2 * hf + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(acc_dv[4 * j + 2 * hf], acc_dv[4 * j + 2 * hf + 1]);
    }
  }
}

// ===========================================================================
// The block, both routes: one producer warpgroup (one thread issues the
// copies; on the fp32 route its other three warps are the helpers) and
// R::NWG consumer warpgroups; under the deterministic order, R::WRITERS
// writers add dQ. The default grid is (ceil(Tk / KEYS), H, B), one item a
// block: the key blocks of a head side by side, so that they read its Q and
// dO tiles from L2 together.
//
// The deterministic grid is cooperative (every block resident, which CUDA
// guarantees or refuses the launch): a 1-D grid whose blocks each walk
// several items (key block fastest, then head, batch), every role the same
// items in the same order.
// - Staggered order, where a head's n_kb key blocks fit the resident blocks:
//   rounds of whole heads, floor(capacity / n_kb) heads a round (at most all
//   of them), one key block a block: block c takes items c, c + grid, ...
//   Each role counts the items itself and runs on into the next (its rings'
//   barriers and kv_full / kv_empty hand them on; with two K/V buffers the
//   next item's K and V load while the consumers finish the last's). A
//   head's blocks are all resident in its round, every wait inside a round
//   points to a smaller (step, x) of the same head, and nothing of a round
//   waits on a later round: no cycle. The item counter would serve this
//   order too, but only without reading the next item ahead (a later block
//   of a head precedes an earlier one on some tile: a block holding both
//   would wait on itself), so the block would meet between items and load
//   each item's K and V only then: slower on the H100 (PERF.md).
// - Plain order otherwise (a very long Tk): thread 0 takes the block's next
//   item from a counter (the last word of `turns`), in index order, and the
//   block meets (BAR_ITEM) to read it. Block x waits only on x - 1, an item
//   taken earlier by a resident block, which in turn waits only on earlier
//   items: deadlock-free at any size, in no dispatch order.
// ===========================================================================

// Rows [r0, r0 + rows) of one head of a tensor map into a shared-memory
// image (R's row image: BOXES boxes of `rows` rows).
template <class R>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, int h, int r0,
                                          int rows, int b, uint64_t* bar) {
  using I = RowImage<R::D * R::ELEM>;
#pragma unroll
  for (int j = 0; j < I::BOXES; ++j) {
    tma_load_3d(dst + j * rows * I::W, map, h * R::D + j * (I::W / R::ELEM), r0, b, bar);
  }
}

// The producer thread's copies of one item: its K and V (into the item's
// buffer, once the consumers are done with that buffer's last item), then
// Q, dO and the stats of each tile of its walk into the ring. MASKED: the
// item's listed units only, each stage's unit beside its tiles and, for a
// partial unit, its bits (one bulk copy on the stage's barrier).
template <class R>
__device__ __forceinline__ void produce(unsigned char* base, uint64_t* full, uint64_t* empty,
                                        uint64_t* kv_full, uint64_t* kv_empty, const Walk& w,
                                        uint32_t u0, int item_, const Units& un,
                                        const CUtensorMap* q_map, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, const CUtensorMap* do_map,
                                        const float* __restrict__ stats,
                                        const unsigned char* __restrict__ bits, int Tk, int H) {
  constexpr int STAGES = R::STAGES, QT = R::QT;
  const int item = R::MASKED ? item_ : u0 / w.n_qt, kb = item % R::KV_BUFS;
  const uint32_t s0 = smem_addr(base), kv = s0 + R::K_DST + kb * 2 * R::KV_BYTES;
  if (item >= R::KV_BUFS) mbar_wait(&kv_empty[kb], (item / R::KV_BUFS - 1) & 1);
  mbar_arrive_expect_tx(&kv_full[kb], 2 * R::KV_BYTES);
  load_rows<R>(kv, k_map, w.h, w.x * R::KEYS, R::KEYS, w.b, &kv_full[kb]);
  load_rows<R>(kv + R::KV_BYTES, v_map, w.h, w.x * R::KEYS, R::KEYS, w.b, &kv_full[kb]);
  const float* st = stats + (size_t)(w.b * H + w.h) * w.n_qt * 2 * QT;
  float* st_s = reinterpret_cast<float*>(base + R::STATS);
  const int n = R::MASKED ? un.n : w.n_qt;
  for (int k = 0; k < n; ++k) {
    const uint32_t u = u0 + k;
    int t = R::ORDERED ? w.tile(k) : k, unit = 0;
    if constexpr (R::MASKED) {
      unit = un.ent[un.at(k)];
      t = unit >> 1;
    }
    const int s = u % STAGES;
    if (u >= STAGES) mbar_wait(&empty[s], ((u / STAGES) - 1) & 1);
    if constexpr (R::MASKED) reinterpret_cast<int*>(base + R::UNITS)[s] = unit;  // before the arrival
    mbar_arrive_expect_tx(&full[s], R::STAGE + 2 * QT * 4 + (unit & 1 ? R::WORDS : 0));
    const uint32_t dst = s0 + R::RING + s * R::STAGE;
    load_rows<R>(dst, q_map, w.h, t * QT, QT, w.b, &full[s]);
    load_rows<R>(dst + R::Q_BYTES, do_map, w.h, t * QT, QT, w.b, &full[s]);
    bulk_load(st_s + s * 2 * QT, st + (size_t)t * 2 * QT, 2 * QT * 4, &full[s]);
    if constexpr (R::MASKED) {
      if (unit & 1) {
        bulk_load(base + R::BITS + s * R::WORDS,
                  bits + ((size_t)t * mask_rows(Tk) + w.x * R::KEYS) * 4 * (QT / 32), R::WORDS,
                  &full[s]);
      }
    }
  }
}

template <class R>
__global__ void __launch_bounds__(R::THREADS, R::MIN_BLOCKS)
bwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ stats, const unsigned char* __restrict__ mask,
           float* __restrict__ dq_acc, unsigned* __restrict__ turns,
           typename R::T* __restrict__ dk, typename R::T* __restrict__ dv, int Tq, int Tk, int H,
           int B, int stagger, float scale, float sm_scale, Dropout drop,
           const int* __restrict__ tile_map, const unsigned char* __restrict__ bits) {
  constexpr int STAGES = R::STAGES, QT = R::QT;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024 - (smem_addr(bwd_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;  // per K/V buffer, then kv_empty
  uint64_t* aux = kv_full + 4;  // fp32: the passed images' handoff (full, then empty, x 2)
  const Handoff hand{aux + 4, aux + 4 + MAX_SLOTS, turns, kv_full + 2};
  int* next = reinterpret_cast<int*>(aux + 4 + 2 * MAX_SLOTS);  // plain order: items r, r + 1
  const int n_qt = (Tq + QT - 1) / QT, n_kb = (Tk + R::KEYS - 1) / R::KEYS;
  const int items = B * H * n_kb;
  // the deterministic grid's item counter, after the turns
  unsigned* const ticket = R::ORDERED ? turns + (size_t)B * H * ((Tq + 31) / 32) : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                         // the producer, plus the bytes
      mbar_init(&empty[s], 4 * R::NWG + R::HELPERS);  // every consumer and helper warp
    }
    for (int i = 0; i < R::KV_BUFS; ++i) {
      mbar_init(&kv_full[i], 1);             // the producer, plus the bytes
      mbar_init(&hand.kv_empty[i], 4 * R::NWG);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&aux[i], R::HELPERS > 0 ? R::HELPERS : 1);  // the helpers' images are in
      mbar_init(&aux[2 + i], 4);  // the consumer warps are done with them
    }
    if constexpr (R::ORDERED) {
      for (int i = 0; i < R::DQ_SLOTS; ++i) {
        mbar_init(&hand.dq_full[i], 1);   // the staging is in (a consumer thread)
        mbar_init(&hand.dq_empty[i], 1);  // the writer has read it
      }
      if (!stagger) next[0] = atomicAdd(ticket, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Every role walks the same items: one (the default grid), or the
  // deterministic grid's. Staggered, each role counts them itself and the
  // barriers of the rings hand them on (K and V through kv_full / kv_empty);
  // plain, thread 0 takes the next from the counter and the block meets to
  // read it. A role takes (the item's walk, its first step u0, its K/V fill,
  // its units under a mask): MASKED, the steps count listed units, so u0 is
  // the sum of the block's earlier items' units.
  auto each_item = [&](auto&& role) {
    if constexpr (!R::ORDERED) {
      const Walk w{(int)blockIdx.z, (int)blockIdx.y, (int)blockIdx.x, n_qt, n_kb, 0, false, 0};
      if constexpr (R::MASKED) {
        role(w, 0u, 0, units_of(tile_map, w.x, false));
      } else {
        role(w, 0u, 0, Units{});
      }
    } else {
      uint32_t u0 = 0;
      for (int r = 0;; ++r) {
        const int i = stagger ? (int)blockIdx.x + r * (int)gridDim.x : next[r & 1];
        if (i >= items) break;
        const Walk w = walk_of(i, H, n_qt, n_kb, stagger != 0);
        if constexpr (R::MASKED) {
          const Units un = units_of(tile_map, w.x, stagger != 0);
          role(w, u0, r, un);
          u0 += un.n;
        } else {
          role(w, (uint32_t)(r * n_qt), r, Units{});
        }
        if (!stagger) {
          if (threadIdx.x == 0) next[(r + 1) & 1] = (int)atomicAdd(ticket, 1);
          __syncwarp();
          named_bar_sync(BAR_ITEM, R::THREADS);
        }
      }
    }
  };

  if (warp >= 4 * R::NWG) {  // the producer warpgroup, and the fp32 route's writer warp
    if constexpr (R::PRODUCER_REGS > 0) setmaxnreg_dec<R::PRODUCER_REGS>();
    const int pw = warp - 4 * R::NWG;  // 0: the copies; 1..: helpers or writers
    if (pw == 0) {
      const CUtensorMap *qm = &q_map, *km = &k_map, *vm = &v_map, *dm = &do_map;
      if (lane == 0) {
        prefetch_tensormap(qm);
        prefetch_tensormap(km);
        prefetch_tensormap(vm);
        prefetch_tensormap(dm);
      }
      each_item([&](const Walk& w, uint32_t u0, int item, const Units& un) {
        if (lane == 0) {
          produce<R>(base, full, empty, kv_full, hand.kv_empty, w, u0, item, un, qm, km, vm, dm,
                     stats, bits, Tk, H);
        }
      });
    } else if (pw <= R::HELPERS) {
      if constexpr (R::HELPERS > 0) {
        each_item([&](const Walk&, uint32_t u0, int, const Units& un) {
          R::help(base, full, empty, aux, R::MASKED ? un.n : n_qt, u0);
        });
      }
    } else if (pw <= R::HELPERS + R::WRITERS) {
      if constexpr (R::WRITERS > 0) {
        // the bf16 route's writers are lane 0 of a warp each; the fp32 route's a warp
        const int wr = pw - 1 - R::HELPERS;
        each_item([&](const Walk& w, uint32_t u0, int, const Units& un) {
          if (lane < R::WRITER_LANES) R::write(base, w, u0, un, hand, dq_acc, H, wr);
        });
      }
    } else {
      each_item([&](const Walk&, uint32_t, int, const Units&) {});
    }
  } else {
    if constexpr (R::CONSUMER_REGS > 0) setmaxnreg_inc<R::CONSUMER_REGS>();
    each_item([&](const Walk& w, uint32_t u0, int item, const Units& un) {
      R::consume(base, full, empty, kv_full, aux, w, u0, item, un, hand, mask, dq_acc, dk, dv, Tq,
                 Tk, H, scale, sm_scale, drop);
    });
  }
}

// The deterministic grid of R's block kernel on the current device: a head's
// query tiles and key blocks, the blocks an SM holds (the occupancy API), the
// SMs, the blocks launched and the order: rounds of whole heads where a head's
// key blocks fit the resident blocks (staggered), else as many blocks as are
// resident, or as there are items (key-block order; kernels/attention.py
// bwd_rounds is the CPU twin), and the depth of the dQ ring.
struct OrderedPlan {
  int n_qt, n_kb, per_sm, sms, grid, stagger, ring;
};
template <class R>
cudaError_t ordered_plan(int B, int Tq, int Tk, int H, OrderedPlan* p) {
  auto kernel = bwd_kernel<R>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)R::SMEM_LAUNCH);
  int device = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, kernel, R::THREADS,
                                                      R::SMEM_LAUNCH);
  }
  if (e != cudaSuccess) return e;
  if (p->per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  p->n_qt = (Tq + R::QT - 1) / R::QT;
  p->n_kb = (Tk + R::KEYS - 1) / R::KEYS;
  p->ring = R::DQ_SLOTS;
  const long capacity = (long)p->per_sm * p->sms, heads = (long)B * H;
  p->stagger = p->n_kb <= capacity;
  if (p->stagger) {
    p->grid = (int)((capacity / p->n_kb < heads ? capacity / p->n_kb : heads) * p->n_kb);
  } else {
    p->grid = (int)(capacity < heads * p->n_kb ? capacity : heads * p->n_kb);
  }
  return cudaSuccess;
}

// What a launch reads of a keep-mask: the unmasked instances a null `mask`
// (the wrapper's masked launches take the MASKED ones), the MASKED ones the
// plan's tile map and the bits (mask_rows); at D = 128 the fp32 route's also
// the forward's tile map and bits (its dQ kernel walks the key tiles of each
// row block), null otherwise.
struct MaskArgs {
  const unsigned char* mask;
  const int* tile_map;
  const unsigned char* bits;
  const int* fwd_map;
  const unsigned* fwd_bits;
};

// The prep kernel, the block kernel and dQ's epilogue, on `stream`; dQ's
// sums zeroed first, and (deterministic) the turns and the item counter.
template <class R>
int launch_bwd(const typename R::T* q, const typename R::T* k, const typename R::T* v,
               const typename R::T* o, const typename R::T* dout, const float* lse,
               MaskArgs m, float* stats, float* dq_acc, unsigned* turns,
               typename R::T* dq, typename R::T* dk, typename R::T* dv, int B, int Tq, int Tk,
               int H, float scale, float sm_scale, Dropout drop, cudaStream_t stream) {
  using T = typename R::T;
  constexpr int D = R::D;
  const int C = H * D, n_qt = (Tq + R::QT - 1) / R::QT, n_kb = (Tk + R::KEYS - 1) / R::KEYS;
  const size_t rows = (size_t)B * n_qt * R::QT * H;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, rows * D * sizeof(float), stream);
  if (e == cudaSuccess && R::ORDERED) {
    e = cudaMemsetAsync(turns, 0, ((size_t)B * H * ((Tq + 31) / 32) + 1) * sizeof(unsigned),
                        stream);
  }
  if (e != cudaSuccess) return (int)e;
  bwd_prep_kernel<T, D, R::QT><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, stats, B, Tq, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm, dm;
  int err = tensor_map::head_map<D, R::ELEM>(&qm, q, B, Tq, C, R::QT);
  if (err == 0) err = tensor_map::head_map<D, R::ELEM>(&dm, dout, B, Tq, C, R::QT);
  if (err == 0) err = tensor_map::head_map<D, R::ELEM>(&km, k, B, Tk, C, R::KEYS);
  if (err == 0) err = tensor_map::head_map<D, R::ELEM>(&vm, v, B, Tk, C, R::KEYS);
  if (err != 0) return err;
  auto kernel = bwd_kernel<R>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)R::SMEM_LAUNCH);
  if (e != cudaSuccess) return (int)e;
  int stagger = 0;
  const unsigned char* mask = m.mask;
  const int* tile_map = m.tile_map;
  const unsigned char* bits = m.bits;
  if constexpr (!R::ORDERED) {
    kernel<<<dim3(n_kb, H, B), R::THREADS, R::SMEM_LAUNCH, stream>>>(
        qm, km, vm, dm, stats, mask, dq_acc, turns, dk, dv, Tq, Tk, H, B, stagger, scale,
        sm_scale, drop, tile_map, bits);
  } else {
    // every block resident (a cooperative launch, or none)
    OrderedPlan plan;
    e = ordered_plan<R>(B, Tq, Tk, H, &plan);
    if (e != cudaSuccess) return (int)e;
    stagger = plan.stagger;
    const float* stats_c = stats;
    void* args[] = {&qm,  &km, &vm, &dm,       &stats_c, &mask,     &dq_acc, &turns,
                    &dk,  &dv, &Tq, &Tk,       &H,       &B,        &stagger, &scale,
                    &sm_scale, &drop, &tile_map, &bits};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(plan.grid),
                                    dim3(R::THREADS), args, R::SMEM_LAUNCH, stream);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  R::epilogue(dq_acc, dq, B, Tq, H, stream);
  return (int)cudaGetLastError();
}

template <typename T, bool MASKED>
struct Routes;
template <bool MASKED>
struct Routes<float, MASKED> {
  template <int D>
  static int run(int keys, const float* q, const float* k, const float* v, const float* o,
                 const float* dout, const float* lse, MaskArgs m, float* stats,
                 float* dq_acc, unsigned* turns, float* dq, float* dk, float* dv, int B, int Tq,
                 int Tk, int H, float scale, float sm_scale, Dropout drop, cudaStream_t s) {
    if (keys != 64) return (int)cudaErrorInvalidValue;
    if (turns != nullptr) {
      return launch_bwd<F32Bwd<D, true, MASKED>>(q, k, v, o, dout, lse, m, stats, dq_acc, turns,
                                                 dq, dk, dv, B, Tq, Tk, H, scale, sm_scale, drop,
                                                 s);
    }
    return launch_bwd<F32Bwd<D, false, MASKED>>(q, k, v, o, dout, lse, m, stats, dq_acc, turns,
                                                dq, dk, dv, B, Tq, Tk, H, scale, sm_scale, drop,
                                                s);
  }
};
template <bool MASKED>
struct Routes<bf16, MASKED> {
  template <int D, int NWG>
  static int keys_run(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* dout, const float* lse, MaskArgs m, float* stats,
                      float* dq_acc, unsigned* turns, bf16* dq, bf16* dk, bf16* dv, int B, int Tq,
                      int Tk, int H, float scale, float sm_scale, Dropout drop, cudaStream_t s) {
    if (turns != nullptr) {
      return launch_bwd<Bf16Bwd<D, NWG, true, MASKED>>(q, k, v, o, dout, lse, m, stats, dq_acc,
                                                       turns, dq, dk, dv, B, Tq, Tk, H, scale,
                                                       sm_scale, drop, s);
    }
    return launch_bwd<Bf16Bwd<D, NWG, false, MASKED>>(q, k, v, o, dout, lse, m, stats, dq_acc,
                                                      turns, dq, dk, dv, B, Tq, Tk, H, scale,
                                                      sm_scale, drop, s);
  }
  template <int D>
  static int run(int keys, const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const float* lse, MaskArgs m, float* stats, float* dq_acc,
                 unsigned* turns, bf16* dq, bf16* dk, bf16* dv, int B, int Tq, int Tk, int H,
                 float scale, float sm_scale, Dropout drop, cudaStream_t s) {
    if (keys == 64) {
      return keys_run<D, 1>(q, k, v, o, dout, lse, m, stats, dq_acc, turns, dq, dk, dv, B, Tq,
                            Tk, H, scale, sm_scale, drop, s);
    }
    if (keys == 128) {
      return keys_run<D, 2>(q, k, v, o, dout, lse, m, stats, dq_acc, turns, dq, dk, dv, B, Tq,
                            Tk, H, scale, sm_scale, drop, s);
    }
    return (int)cudaErrorInvalidValue;
  }
};

// A C entry's launch: the MASKED instances given a tile map and bits (both,
// or the call is refused), the unmasked ones given neither and no `mask`.
template <typename T, bool MASKED>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, MaskArgs m, float* stats, float* dq_acc,
                 unsigned* turns, void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
                 int D, int keys, float scale, float sm_scale, float rate, int seed,
                 void* stream) {
  if (Tk <= 0 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (MASKED ? (m.tile_map == nullptr || m.bits == nullptr || m.mask != nullptr)
             : (m.tile_map != nullptr || m.bits != nullptr || m.mask != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (Tq == 0) {  // no query: zero gradients of k and v
    const size_t bytes = (size_t)B * Tk * H * D * sizeof(T);
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)e;
  }
  if (stats == nullptr || dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *ot = (const T*)o;
  const T* dt = (const T*)dout;
  T *dqt = (T*)dq, *dkt = (T*)dk, *dvt = (T*)dv;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  using Route = Routes<T, MASKED>;
  switch (D) {
    case 32:
      return Route::template run<32>(keys, qt, kt, vt, ot, dt, lse, m, stats, dq_acc, turns, dqt,
                                     dkt, dvt, B, Tq, Tk, H, scale, sm_scale, drop, s);
    case 48:
      return Route::template run<48>(keys, qt, kt, vt, ot, dt, lse, m, stats, dq_acc, turns, dqt,
                                     dkt, dvt, B, Tq, Tk, H, scale, sm_scale, drop, s);
    case 64:
      return Route::template run<64>(keys, qt, kt, vt, ot, dt, lse, m, stats, dq_acc, turns, dqt,
                                     dkt, dvt, B, Tq, Tk, H, scale, sm_scale, drop, s);
    case 128: {
      const int bf16_route = sizeof(T) == 2;
      if constexpr (MASKED) {
        return flash_mha_bwd_masked_d128(bf16_route, q, k, v, o, dout, lse, m.tile_map, m.bits,
                                         m.fwd_map, m.fwd_bits, stats, dq_acc, turns, dq, dk, dv,
                                         B, Tq, Tk, H, keys, scale, sm_scale, drop, s);
      } else {
        return flash_mha_bwd_d128(bf16_route, q, k, v, o, dout, lse, nullptr, nullptr, nullptr,
                                  nullptr, stats, dq_acc, turns, dq, dk, dv, B, Tq, Tk, H, keys,
                                  scale, sm_scale, drop, s);
      }
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The deterministic plan of the instance that a launch with these sizes takes.
template <int D, bool MASKED>
int plan_of(int bf16_route, int keys, int B, int Tq, int Tk, int H, OrderedPlan* p) {
  if (!bf16_route) {
    return keys == 64 ? (int)ordered_plan<F32Bwd<D, true, MASKED>>(B, Tq, Tk, H, p)
                      : (int)cudaErrorInvalidValue;
  }
  if (keys == 64) return (int)ordered_plan<Bf16Bwd<D, 1, true, MASKED>>(B, Tq, Tk, H, p);
  if (keys == 128) return (int)ordered_plan<Bf16Bwd<D, 2, true, MASKED>>(B, Tq, Tk, H, p);
  return (int)cudaErrorInvalidValue;
}

// flash_mha_bwd_ordered_plan's body, for the unmasked or the MASKED instances.
template <bool MASKED>
int ordered_plan_entry(int bf16_route, int B, int Tq, int Tk, int H, int D, int keys, int* plan) {
  OrderedPlan p{};
  int e = (int)cudaErrorInvalidValue;
  if (B > 0 && H > 0 && Tq > 0 && Tk > 0) {
    if (D == 32) e = plan_of<32, MASKED>(bf16_route, keys, B, Tq, Tk, H, &p);
    if (D == 48) e = plan_of<48, MASKED>(bf16_route, keys, B, Tq, Tk, H, &p);
    if (D == 64) e = plan_of<64, MASKED>(bf16_route, keys, B, Tq, Tk, H, &p);
    if (D == 128) {  // the d128 source fills the plan
      if constexpr (MASKED) {
        return flash_mha_bwd_masked_d128_plan(bf16_route, keys, B, Tq, Tk, H, plan);
      } else {
        return flash_mha_bwd_d128_plan(bf16_route, keys, B, Tq, Tk, H, plan);
      }
    }
  }
  const int out[] = {p.n_qt, p.n_kb, p.per_sm, p.sms, p.grid, p.stagger, p.ring};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return e;
}

}  // namespace
