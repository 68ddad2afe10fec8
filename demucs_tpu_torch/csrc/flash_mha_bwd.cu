// K3's backward (fp32): the gradients of flash_mha.cu's fp32 route,
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
// (B, Tk, H*D), row-major fp32, a head at column h*D; the keep-mask (Tq, Tk)
// bytes shared by batch and heads; lse (B*H, Tq).
//
// The JAX package has no backward kernel: it trains through XLA's dense
// attention (demucs_tpu/ops/attention.py), whose gradient this is.
//
// Bound: operations. Five products of 2 Tq Tk D flops per head (S, dP, dV,
// dK, dQ) on 4 (Tq + Tk) D floats in and 2 (Tq + Tk) D out, hundreds of
// flops per byte at the released shapes. Each product runs on the tensor
// cores as three TF32 mma.sync (the 3xTF32 split of flash_mha.cu, for fp32
// accuracy): the bound is 3 x 5 x 2 B H Tq Tk D over 495 TFLOP/s.
//
// Design, simple before fast:
// - bwd_rowdot_kernel: D_i = dO_i . o_i per (batch-head, row).
// - bwd_dkdv_kernel: a block of 4 warps holds 64 keys of one (batch, head),
//   K and V in shared memory; each warp owns 16 keys and keeps their dK and
//   dV in registers while the block walks every tile of 64 queries (Q, dO,
//   lse and D staged in shared memory). Per tile a warp computes S^T and dP^T
//   (its keys x 64 queries), the probabilities, the drop and dS^T in the
//   accumulator registers, then dV += (Z P)^T dO and dK += dS^T Q with the
//   accumulator passed as the A fragment in registers: lane (g, c) holds
//   queries 2c and 2c+1 of each 8, where the A fragment wants k-positions c
//   and c+4, so the B fragment reads query 2c at k-position c and 2c+1 at
//   c+4 (the sum does not depend on the order).
// - bwd_dq_kernel: the same with the roles turned: a block holds 64 queries
//   (Q, dO, lse, D), each warp 16 of them, and walks the key tiles (K, V in
//   shared memory), recomputing S and dP, then dQ += dS K. Recomputing S and
//   dP once more costs 2 of 7 products but needs no atomics: the gradients
//   are deterministic.
// - The mma.sync fragments (m16n8k8, TF32) are read from shared memory with
//   rows padded to D + 4 floats: each of the reads below hits 32 banks or
//   the same word.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_dropout.cuh"
#include "hopper.cuh"

namespace {

using hopper::tf32_hi;

constexpr int TILE = 64;  // queries or keys per tile
constexpr int WARPS = 4;  // 16 rows (dQ) or keys (dK, dV) each
constexpr int THREADS = 32 * WARPS;

// d += a b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in the 3xTF32 split: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = tf32_hi(a[e]);
    ah[e] = __float_as_uint(h);
    al[e] = __float_as_uint(a[e] - h);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float h = tf32_hi(b[e]);
    bh[e] = __float_as_uint(h);
    bl[e] = __float_as_uint(b[e] - h);
  }
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Rows [t0, t0 + TILE) of one head of x (B, T, C) into s[TILE][LD], zeros past T.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ x, int b, int h,
                                          int t0, int T, int C) {
  for (int f = threadIdx.x; f < TILE * D / 4; f += THREADS) {
    const int r = f / (D / 4), c = 4 * (f % (D / 4));
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) {
      val = *reinterpret_cast<const float4*>(x + ((size_t)b * T + t0 + r) * C + h * D + c);
    }
    *reinterpret_cast<float4*>(s + r * LD + c) = val;
  }
}

// The A fragment of rows [r0, r0 + 16), columns [k0, k0 + 8) of s[.][LD].
template <int LD>
__device__ __forceinline__ void a_frag(float (&a)[4], const float* s, int r0, int k0, int g,
                                       int c) {
  a[0] = s[(r0 + g) * LD + k0 + c];
  a[1] = s[(r0 + g + 8) * LD + k0 + c];
  a[2] = s[(r0 + g) * LD + k0 + c + 4];
  a[3] = s[(r0 + g + 8) * LD + k0 + c + 4];
}

// The B fragment of B = s^T over rows [n0, n0 + 8) and columns [k0, k0 + 8)
// of s (B[k][n] = s[n0 + n][k0 + k]): a product against the rows of s.
template <int LD>
__device__ __forceinline__ void bt_frag(float (&b)[2], const float* s, int n0, int k0, int g,
                                        int c) {
  b[0] = s[(n0 + g) * LD + k0 + c];
  b[1] = s[(n0 + g) * LD + k0 + c + 4];
}

// The B fragment of B = s over rows [k0, k0 + 8), columns [n0, n0 + 8), with
// the k order of a passed accumulator: k-position c is row 2c, c + 4 is 2c + 1.
template <int LD>
__device__ __forceinline__ void b_frag_paired(float (&b)[2], const float* s, int k0, int n0,
                                              int g, int c) {
  b[0] = s[(k0 + 2 * c) * LD + n0 + g];
  b[1] = s[(k0 + 2 * c + 1) * LD + n0 + g];
}

// The A fragment of an accumulator tile's 8 columns (see b_frag_paired).
__device__ __forceinline__ void a_from_acc(float (&a)[4], const float (&acc)[4]) {
  a[0] = acc[0];
  a[1] = acc[2];
  a[2] = acc[1];
  a[3] = acc[3];
}

// D_i = dO_i . o_i, one thread per (batch, row, head) -> rowdot (B*H, Tq).
template <int D>
__global__ void bwd_rowdot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                  float* __restrict__ rowdot, int B, int Tq, int H) {
  const size_t n = (size_t)B * Tq * H;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int h = idx % H;
  const size_t bi = idx / H;  // b * Tq + i
  const float4* x = reinterpret_cast<const float4*>(o + bi * H * D + h * D);
  const float4* y = reinterpret_cast<const float4*>(dout + bi * H * D + h * D);
  float acc = 0.f;
#pragma unroll
  for (int f = 0; f < D / 4; ++f) {
    const float4 a = x[f], c = y[f];
    acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
  }
  const int b = bi / Tq, i = bi % Tq;
  rowdot[((size_t)b * H + h) * Tq + i] = acc;
}

// Shared-memory tiles of a block: two staged for the whole walk (this
// block's 64 rows or keys), two per step, each TILE x LD floats; then the
// step's lse and D (dK/dV) or the block's (dQ).
template <int D>
constexpr int LDS = D + 4;
template <int D>
constexpr size_t SMEM = (4 * TILE * LDS<D> + 2 * TILE) * sizeof(float);

// dK and dV of 64 keys of one (batch, head). Grid (ceil(Tk / 64), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ rowdot,
                const unsigned char* __restrict__ mask, float* __restrict__ dk,
                float* __restrict__ dv, int Tq, int Tk, int H, float q_scale, float sm_scale,
                Dropout drop) {
  constexpr int LD = LDS<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + TILE * LD;
  float* qs = vs + TILE * LD;
  float* dos = qs + TILE * LD;
  float* lse_s = dos + TILE * LD;
  float* dd_s = lse_s + TILE;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * TILE;
  const int C = H * D, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int jw = warp * 16;  // this warp's keys within the tile
  const uint32_t salt = drop.salt(bh);

  load_tile<D, LD>(ks, k, b, h, j0, Tk, C);
  load_tile<D, LD>(vs, v, b, h, j0, Tk, C);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  }

  for (int i0 = 0; i0 < Tq; i0 += TILE) {
    __syncthreads();  // the previous step is done with qs, dos, lse_s, dd_s
    load_tile<D, LD>(qs, q, b, h, i0, Tq, C);
    load_tile<D, LD>(dos, dout, b, h, i0, Tq, C);
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      const bool in = i0 + r < Tq;
      lse_s[r] = in ? lse[(size_t)bh * Tq + i0 + r] : 0.f;
      dd_s[r] = in ? rowdot[(size_t)bh * Tq + i0 + r] : 0.f;
    }
    __syncthreads();

    // S^T (this warp's 16 keys x 64 queries) and dP^T = V dO^T
    float st[TILE / 8][4], dpt[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      float ak[4], av[4];
      a_frag<LD>(ak, ks, jw, kk, g, c);
      a_frag<LD>(av, vs, jw, kk, g, c);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        float bq[2], bo[2];
        bt_frag<LD>(bq, qs, 8 * n, kk, g, c);
        bt_frag<LD>(bo, dos, 8 * n, kk, g, c);
        mma3(st[n], ak, bq);
        mma3(dpt[n], av, bo);
      }
    }

    // probabilities, drop, dS^T; st becomes Z P, dpt becomes dS
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + jw + g + 8 * (e >> 1);
        const int il = 8 * n + 2 * c + (e & 1);  // query within the tile
        const int qi = i0 + il;
        bool kept = key < Tk && qi < Tq;
        if (kept && mask != nullptr) kept = mask[(size_t)qi * Tk + key] != 0;
        const float p = kept ? exp2f(st[n][e] * q_scale - lse_s[il]) : 0.f;
        float z = 1.f;
        if (drop.rate > 0.f) z = drop.keep(qi, key, salt) ? drop.scale : 0.f;
        st[n][e] = p * z;
        dpt[n][e] = p * (dpt[n][e] * z - dd_s[il]);
      }
    }

    // dV += (Z P)^T dO, dK += dS^T Q over this tile's queries
#pragma unroll
    for (int kt = 0; kt < TILE / 8; ++kt) {
      float ap[4], as[4];
      a_from_acc(ap, st[kt]);
      a_from_acc(as, dpt[kt]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float bo[2], bq[2];
        b_frag_paired<LD>(bo, dos, 8 * kt, 8 * n, g, c);
        b_frag_paired<LD>(bq, qs, 8 * kt, 8 * n, g, c);
        mma3(acc_dv[n], ap, bo);
        mma3(acc_dk[n], as, bq);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + jw + g + 8 * half;
    if (key >= Tk) continue;
    float* dkr = dk + ((size_t)b * Tk + key) * C + h * D + 2 * c;
    float* dvr = dv + ((size_t)b * Tk + key) * C + h * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(acc_dk[n][2 * half] * sm_scale, acc_dk[n][2 * half + 1] * sm_scale);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(acc_dv[n][2 * half], acc_dv[n][2 * half + 1]);
    }
  }
}

// dQ of 64 queries of one (batch, head). Grid (ceil(Tq / 64), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ rowdot,
              const unsigned char* __restrict__ mask, float* __restrict__ dq, int Tq, int Tk,
              int H, float q_scale, float sm_scale, Dropout drop) {
  constexpr int LD = LDS<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + TILE * LD;
  float* ks = dos + TILE * LD;
  float* vs = ks + TILE * LD;
  float* lse_s = vs + TILE * LD;
  float* dd_s = lse_s + TILE;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int C = H * D, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int iw = warp * 16;  // this warp's queries within the tile
  const uint32_t salt = drop.salt(bh);

  load_tile<D, LD>(qs, q, b, h, i0, Tq, C);
  load_tile<D, LD>(dos, dout, b, h, i0, Tq, C);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const bool in = i0 + r < Tq;
    lse_s[r] = in ? lse[(size_t)bh * Tq + i0 + r] : 0.f;
    dd_s[r] = in ? rowdot[(size_t)bh * Tq + i0 + r] : 0.f;
  }

  float acc_dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[n][e] = 0.f;
  }

  for (int j0 = 0; j0 < Tk; j0 += TILE) {
    __syncthreads();  // the previous step is done with ks, vs (and the loads above landed)
    load_tile<D, LD>(ks, k, b, h, j0, Tk, C);
    load_tile<D, LD>(vs, v, b, h, j0, Tk, C);
    __syncthreads();

    // S (this warp's 16 queries x 64 keys) and dP = dO V^T
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      float aq[4], ao[4];
      a_frag<LD>(aq, qs, iw, kk, g, c);
      a_frag<LD>(ao, dos, iw, kk, g, c);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        float bk[2], bv[2];
        bt_frag<LD>(bk, ks, 8 * n, kk, g, c);
        bt_frag<LD>(bv, vs, 8 * n, kk, g, c);
        mma3(s[n], aq, bk);
        mma3(dp[n], ao, bv);
      }
    }

    // dS in place of s
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = iw + g + 8 * (e >> 1);  // query within the tile
        const int qi = i0 + il;
        const int key = j0 + 8 * n + 2 * c + (e & 1);
        bool kept = key < Tk && qi < Tq;
        if (kept && mask != nullptr) kept = mask[(size_t)qi * Tk + key] != 0;
        const float p = kept ? exp2f(s[n][e] * q_scale - lse_s[il]) : 0.f;
        float z = 1.f;
        if (drop.rate > 0.f) z = drop.keep(qi, key, salt) ? drop.scale : 0.f;
        s[n][e] = p * (dp[n][e] * z - dd_s[il]);
      }
    }

    // dQ += dS K over this tile's keys
#pragma unroll
    for (int kt = 0; kt < TILE / 8; ++kt) {
      float as[4];
      a_from_acc(as, s[kt]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float bk[2];
        b_frag_paired<LD>(bk, ks, 8 * kt, 8 * n, g, c);
        mma3(acc_dq[n], as, bk);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = i0 + iw + g + 8 * half;
    if (qi >= Tq) continue;
    float* dst = dq + ((size_t)b * Tq + qi) * C + h * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc_dq[n][2 * half] * sm_scale, acc_dq[n][2 * half + 1] * sm_scale);
    }
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, const unsigned char* mask,
                       float* rowdot, float* dq, float* dk, float* dv, int B, int Tq, int Tk,
                       int H, float q_scale, float sm_scale, Dropout drop,
                       cudaStream_t stream) {
  const size_t rows = (size_t)B * Tq * H;
  bwd_rowdot_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, dout, rowdot, B,
                                                                          Tq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = SMEM<D>;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<D><<<dim3((Tk + TILE - 1) / TILE, H, B), THREADS, smem, stream>>>(
      q, k, v, dout, lse, rowdot, mask, dk, dv, Tq, Tk, H, q_scale, sm_scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<dim3((Tq + TILE - 1) / TILE, H, B), THREADS, smem, stream>>>(
      q, k, v, dout, lse, rowdot, mask, dq, Tq, Tk, H, q_scale, sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout (B, Tq, H*D); k, v (B, Tk, H*D); lse (B*H, Tq) from flash_mha_f32;
// mask (Tq, Tk) bytes or null; rowdot: scratch of B*H*Tq floats -> dq (B, Tq,
// H*D), dk, dv (B, Tk, H*D). q_scale = log2(e) / sqrt(D), the forward's;
// sm_scale = 1 / sqrt(D). rate and seed: the forward's dropout.
int flash_mha_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                      const float* dout, const float* lse, const unsigned char* mask,
                      float* rowdot, float* dq, float* dk, float* dv, int B, int Tq, int Tk,
                      int H, int D, float q_scale, float sm_scale, float rate,
                      int seed, void* stream) {
  if (Tk <= 0 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  switch (D) {
    case 32:
      return (int)launch_bwd<32>(q, k, v, o, dout, lse, mask, rowdot, dq, dk, dv, B, Tq, Tk, H,
                                 q_scale, sm_scale, drop, s);
    case 48:
      return (int)launch_bwd<48>(q, k, v, o, dout, lse, mask, rowdot, dq, dk, dv, B, Tq, Tk, H,
                                 q_scale, sm_scale, drop, s);
    case 64:
      return (int)launch_bwd<64>(q, k, v, o, dout, lse, mask, rowdot, dq, dk, dv, B, Tq, Tk, H,
                                 q_scale, sm_scale, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
