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
// column h*D; the keep-mask (Tq, Tk) bytes shared by batch and heads; lse and
// the row dots (B*H, Tq) fp32.
//
// The JAX package has no backward kernel: it trains through XLA's dense
// attention (demucs_tpu/ops/attention.py), whose gradient this is.
//
// Bound: operations. Five products of 2 Tq Tk D flops per head (S, dP, dV,
// dK, dQ) on 4 (Tq + Tk) D values in and 2 (Tq + Tk) D out, hundreds of
// flops per byte at the released shapes. fp32: each product runs on the
// tensor cores as three TF32 mma.sync (the 3xTF32 split of flash_mha.cu, for
// fp32 accuracy), so the bound is 3 x 5 x 2 B H Tq Tk D over 495 TFLOP/s.
// bf16: one bf16 mma.sync per product, fp32 accumulation, so the bound is
// 5 x 2 B H Tq Tk D over 989 TFLOP/s; P Z and dS go into the products as
// bf16 (rounded from their fp32 accumulators), dQ, dK and dV come out in
// bf16.
//
// Design, simple before fast, one design for both types (templated on the
// element type T: its loads, fragments and product are Mma<T>):
// - bwd_rowdot_kernel: D_i = dO_i . o_i per (batch-head, row), in fp32.
// - bwd_dkdv_kernel: a block of 4 warps holds 64 keys of one (batch, head),
//   K and V in shared memory; each warp owns 16 keys and keeps their dK and
//   dV in fp32 registers while the block walks every tile of 64 queries (Q,
//   dO, lse and D staged in shared memory). Per tile a warp computes S^T and
//   dP^T (its keys x 64 queries), the probabilities, the drop and dS^T in
//   the accumulator registers, then dV += (Z P)^T dO and dK += dS^T Q with
//   the accumulator passed as the A fragment in registers.
// - bwd_dq_kernel: the same with the roles turned: a block holds 64 queries
//   (Q, dO, lse, D), each warp 16 of them, and walks the key tiles (K, V in
//   shared memory), recomputing S and dP, then dQ += dS K. Recomputing S and
//   dP once more costs 2 of 7 products but needs no atomics: the gradients
//   are deterministic.
// - The mma.sync fragments (m16n8k8 TF32, m16n8k16 bf16) are read from
//   shared memory with rows padded by 16 bytes: each 32-bit read of a
//   fragment hits 32 banks or the same word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_dropout.cuh"
#include "hopper.cuh"

namespace {

using hopper::tf32_hi;
using bf16 = __nv_bfloat16;

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

// d += a b, one m16n8k16 bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What the kernels need of an element type T: the depth K of one product,
// the fragments of its operands read from shared memory (rows of ld
// elements) or passed from an accumulator, the product, the dot of two
// 16-byte vectors and the store of two results.
template <typename T>
struct Mma;

// fp32: m16n8k8 in the 3xTF32 split. An accumulator passes to the A fragment
// as it lies: lane (g, c) holds columns 2c and 2c+1 of each 8, where the A
// fragment wants k-positions c and c+4, so the B fragment of a product
// against a passed accumulator reads row 2c at k-position c and 2c+1 at c+4
// (the sum does not depend on the order).
template <>
struct Mma<float> {
  static constexpr int K = 8;
  using A = float[4];
  using B = float[2];

  // rows [r0, r0 + 16), columns [k0, k0 + 8) of s
  static __device__ __forceinline__ void a(A& f, const float* s, int ld, int r0, int k0, int g,
                                           int c) {
    f[0] = s[(r0 + g) * ld + k0 + c];
    f[1] = s[(r0 + g + 8) * ld + k0 + c];
    f[2] = s[(r0 + g) * ld + k0 + c + 4];
    f[3] = s[(r0 + g + 8) * ld + k0 + c + 4];
  }
  // B = s^T over rows [n0, n0 + 8) and columns [k0, k0 + 8) of s
  static __device__ __forceinline__ void bt(B& f, const float* s, int ld, int n0, int k0, int g,
                                            int c) {
    f[0] = s[(n0 + g) * ld + k0 + c];
    f[1] = s[(n0 + g) * ld + k0 + c + 4];
  }
  // B = s over rows [k0, k0 + 8), columns [n0, n0 + 8), in a passed accumulator's k order
  static __device__ __forceinline__ void b_acc(B& f, const float* s, int ld, int k0, int n0,
                                               int g, int c) {
    f[0] = s[(k0 + 2 * c) * ld + n0 + g];
    f[1] = s[(k0 + 2 * c + 1) * ld + n0 + g];
  }
  // the A fragment of step kt: accumulator tile kt
  static __device__ __forceinline__ void a_acc(A& f, const float (*acc)[4], int kt) {
    f[0] = acc[kt][0];
    f[1] = acc[kt][2];
    f[2] = acc[kt][1];
    f[3] = acc[kt][3];
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
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
    mma_tf32(d, al, bh);  // a_lo b_hi + a_hi b_lo + a_hi b_hi
    mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
  }
  static __device__ __forceinline__ float dot(uint4 x, uint4 y) {
    const float4 a = *reinterpret_cast<float4*>(&x), b = *reinterpret_cast<float4*>(&y);
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  static __device__ __forceinline__ void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
};

// bf16: m16n8k16. Lane (g, c) holds the pairs (2c, 2c+1) and (2c+8, 2c+9)
// of each 16 columns, in the order in which two accumulator tiles of 8
// columns hold them, so an accumulator passes to the A fragment pair by
// pair, rounded to bf16, and the B fragment against it reads keys in order.
template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  using A = uint32_t[4];
  using B = uint32_t[2];

  static __device__ __forceinline__ uint32_t pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t column_pair(const bf16* p, int ld) {
    __nv_bfloat162 v;
    v.x = p[0];
    v.y = p[ld];
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void a(A& f, const bf16* s, int ld, int r0, int k0, int g,
                                           int c) {
    f[0] = pair(s + (r0 + g) * ld + k0 + 2 * c);
    f[1] = pair(s + (r0 + g + 8) * ld + k0 + 2 * c);
    f[2] = pair(s + (r0 + g) * ld + k0 + 2 * c + 8);
    f[3] = pair(s + (r0 + g + 8) * ld + k0 + 2 * c + 8);
  }
  static __device__ __forceinline__ void bt(B& f, const bf16* s, int ld, int n0, int k0, int g,
                                            int c) {
    f[0] = pair(s + (n0 + g) * ld + k0 + 2 * c);
    f[1] = pair(s + (n0 + g) * ld + k0 + 2 * c + 8);
  }
  static __device__ __forceinline__ void b_acc(B& f, const bf16* s, int ld, int k0, int n0,
                                               int g, int c) {
    f[0] = column_pair(s + (k0 + 2 * c) * ld + n0 + g, ld);
    f[1] = column_pair(s + (k0 + 2 * c + 8) * ld + n0 + g, ld);
  }
  // the A fragment of step kt: accumulator tiles 2 kt and 2 kt + 1
  static __device__ __forceinline__ void a_acc(A& f, const float (*acc)[4], int kt) {
    f[0] = pack_bf16(acc[2 * kt][0], acc[2 * kt][1]);
    f[1] = pack_bf16(acc[2 * kt][2], acc[2 * kt][3]);
    f[2] = pack_bf16(acc[2 * kt + 1][0], acc[2 * kt + 1][1]);
    f[3] = pack_bf16(acc[2 * kt + 1][2], acc[2 * kt + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a, b);
  }
  static __device__ __forceinline__ float dot(uint4 x, uint4 y) {
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
  static __device__ __forceinline__ void store2(bf16* dst, float x, float y) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
  }
};

// elements of T in 16 bytes
template <typename T>
constexpr int VEC = 16 / sizeof(T);

// Rows [t0, t0 + TILE) of one head of x (B, T, C) into s[TILE][LD], zeros past T.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ x, int b, int h, int t0,
                                          int T_, int C) {
  constexpr int V = VEC<T>;
  for (int f = threadIdx.x; f < TILE * D / V; f += THREADS) {
    const int r = f / (D / V), c = V * (f % (D / V));
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_) {
      val = *reinterpret_cast<const uint4*>(x + ((size_t)b * T_ + t0 + r) * C + h * D + c);
    }
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// D_i = dO_i . o_i, one thread per (batch, row, head) -> rowdot (B*H, Tq).
template <typename T, int D>
__global__ void bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                  float* __restrict__ rowdot, int B, int Tq, int H) {
  const size_t n = (size_t)B * Tq * H;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int h = idx % H;
  const size_t bi = idx / H;  // b * Tq + i
  const uint4* x = reinterpret_cast<const uint4*>(o + bi * H * D + h * D);
  const uint4* y = reinterpret_cast<const uint4*>(dout + bi * H * D + h * D);
  float acc = 0.f;
#pragma unroll
  for (int f = 0; f < D / VEC<T>; ++f) acc += Mma<T>::dot(x[f], y[f]);
  const int b = bi / Tq, i = bi % Tq;
  rowdot[((size_t)b * H + h) * Tq + i] = acc;
}

// Shared-memory tiles of a block: two staged for the whole walk (this
// block's 64 rows or keys), two per step, each TILE x LD elements (rows
// padded by 16 bytes); then the step's lse and D (dK/dV) or the block's (dQ).
template <typename T, int D>
constexpr int LDS = D + VEC<T>;
template <typename T, int D>
constexpr size_t SMEM = 4 * TILE * LDS<T, D> * sizeof(T) + 2 * TILE * sizeof(float);

// dK and dV of 64 keys of one (batch, head). Grid (ceil(Tk / 64), H, B).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ rowdot, const unsigned char* __restrict__ mask,
                T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H, float q_scale,
                float sm_scale, Dropout drop) {
  using M = Mma<T>;
  constexpr int LD = LDS<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + TILE * LD;
  T* qs = vs + TILE * LD;
  T* dos = qs + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(dos + TILE * LD);
  float* dd_s = lse_s + TILE;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * TILE;
  const int C = H * D, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int jw = warp * 16;  // this warp's keys within the tile
  const uint32_t salt = drop.salt(bh);

  load_tile<T, D, LD>(ks, k, b, h, j0, Tk, C);
  load_tile<T, D, LD>(vs, v, b, h, j0, Tk, C);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  }

  for (int i0 = 0; i0 < Tq; i0 += TILE) {
    __syncthreads();  // the previous step is done with qs, dos, lse_s, dd_s
    load_tile<T, D, LD>(qs, q, b, h, i0, Tq, C);
    load_tile<T, D, LD>(dos, dout, b, h, i0, Tq, C);
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
    for (int kk = 0; kk < D; kk += M::K) {
      typename M::A ak, av;
      M::a(ak, ks, LD, jw, kk, g, c);
      M::a(av, vs, LD, jw, kk, g, c);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        typename M::B bq, bo;
        M::bt(bq, qs, LD, 8 * n, kk, g, c);
        M::bt(bo, dos, LD, 8 * n, kk, g, c);
        M::mma(st[n], ak, bq);
        M::mma(dpt[n], av, bo);
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
    for (int kt = 0; kt < TILE / M::K; ++kt) {
      typename M::A ap, as;
      M::a_acc(ap, st, kt);
      M::a_acc(as, dpt, kt);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        typename M::B bo, bq;
        M::b_acc(bo, dos, LD, M::K * kt, 8 * n, g, c);
        M::b_acc(bq, qs, LD, M::K * kt, 8 * n, g, c);
        M::mma(acc_dv[n], ap, bo);
        M::mma(acc_dk[n], as, bq);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + jw + g + 8 * half;
    if (key >= Tk) continue;
    T* dkr = dk + ((size_t)b * Tk + key) * C + h * D + 2 * c;
    T* dvr = dv + ((size_t)b * Tk + key) * C + h * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      M::store2(dkr + 8 * n, acc_dk[n][2 * half] * sm_scale, acc_dk[n][2 * half + 1] * sm_scale);
      M::store2(dvr + 8 * n, acc_dv[n][2 * half], acc_dv[n][2 * half + 1]);
    }
  }
}

// dQ of 64 queries of one (batch, head). Grid (ceil(Tq / 64), H, B).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ rowdot, const unsigned char* __restrict__ mask,
              T* __restrict__ dq, int Tq, int Tk, int H, float q_scale, float sm_scale,
              Dropout drop) {
  using M = Mma<T>;
  constexpr int LD = LDS<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + TILE * LD;
  T* ks = dos + TILE * LD;
  T* vs = ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(vs + TILE * LD);
  float* dd_s = lse_s + TILE;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int C = H * D, bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int iw = warp * 16;  // this warp's queries within the tile
  const uint32_t salt = drop.salt(bh);

  load_tile<T, D, LD>(qs, q, b, h, i0, Tq, C);
  load_tile<T, D, LD>(dos, dout, b, h, i0, Tq, C);
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
    load_tile<T, D, LD>(ks, k, b, h, j0, Tk, C);
    load_tile<T, D, LD>(vs, v, b, h, j0, Tk, C);
    __syncthreads();

    // S (this warp's 16 queries x 64 keys) and dP = dO V^T
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += M::K) {
      typename M::A aq, ao;
      M::a(aq, qs, LD, iw, kk, g, c);
      M::a(ao, dos, LD, iw, kk, g, c);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        typename M::B bk, bv;
        M::bt(bk, ks, LD, 8 * n, kk, g, c);
        M::bt(bv, vs, LD, 8 * n, kk, g, c);
        M::mma(s[n], aq, bk);
        M::mma(dp[n], ao, bv);
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
    for (int kt = 0; kt < TILE / M::K; ++kt) {
      typename M::A as;
      M::a_acc(as, s, kt);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        typename M::B bk;
        M::b_acc(bk, ks, LD, M::K * kt, 8 * n, g, c);
        M::mma(acc_dq[n], as, bk);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = i0 + iw + g + 8 * half;
    if (qi >= Tq) continue;
    T* dst = dq + ((size_t)b * Tq + qi) * C + h * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      M::store2(dst + 8 * n, acc_dq[n][2 * half] * sm_scale, acc_dq[n][2 * half + 1] * sm_scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* o, const T* dout,
                       const float* lse, const unsigned char* mask, float* rowdot, T* dq, T* dk,
                       T* dv, int B, int Tq, int Tk, int H, float q_scale, float sm_scale,
                       Dropout drop, cudaStream_t stream) {
  const size_t rows = (size_t)B * Tq * H;
  bwd_rowdot_kernel<T, D><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, dout, rowdot,
                                                                             B, Tq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = SMEM<T, D>;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, D><<<dim3((Tk + TILE - 1) / TILE, H, B), THREADS, smem, stream>>>(
      q, k, v, dout, lse, rowdot, mask, dk, dv, Tq, Tk, H, q_scale, sm_scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3((Tq + TILE - 1) / TILE, H, B), THREADS, smem, stream>>>(
      q, k, v, dout, lse, rowdot, mask, dq, Tq, Tk, H, q_scale, sm_scale, drop);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, const unsigned char* mask, float* rowdot, void* dq, void* dk,
                 void* dv, int B, int Tq, int Tk, int H, int D, float q_scale, float sm_scale,
                 float rate, int seed, void* stream) {
  if (Tk <= 0 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *ot = (const T*)o;
  const T* dt = (const T*)dout;
  T *dqt = (T*)dq, *dkt = (T*)dk, *dvt = (T*)dv;
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop = Dropout::make(rate, (uint32_t)seed);
  switch (D) {
    case 32:
      return (int)launch_bwd<T, 32>(qt, kt, vt, ot, dt, lse, mask, rowdot, dqt, dkt, dvt, B, Tq,
                                    Tk, H, q_scale, sm_scale, drop, s);
    case 48:
      return (int)launch_bwd<T, 48>(qt, kt, vt, ot, dt, lse, mask, rowdot, dqt, dkt, dvt, B, Tq,
                                    Tk, H, q_scale, sm_scale, drop, s);
    case 64:
      return (int)launch_bwd<T, 64>(qt, kt, vt, ot, dt, lse, mask, rowdot, dqt, dkt, dvt, B, Tq,
                                    Tk, H, q_scale, sm_scale, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dout (B, Tq, H*D); k, v (B, Tk, H*D), fp32; lse (B*H, Tq) from
// flash_mha_f32; mask (Tq, Tk) bytes or null; rowdot: scratch of B*H*Tq
// floats -> dq (B, Tq, H*D), dk, dv (B, Tk, H*D). q_scale = log2(e) / sqrt(D),
// the forward's; sm_scale = 1 / sqrt(D). rate and seed: the forward's dropout.
int flash_mha_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                      const float* dout, const float* lse, const unsigned char* mask,
                      float* rowdot, float* dq, float* dk, float* dv, int B, int Tq, int Tk,
                      int H, int D, float q_scale, float sm_scale, float rate, int seed,
                      void* stream) {
  return dispatch_bwd<float>(q, k, v, o, dout, lse, mask, rowdot, dq, dk, dv, B, Tq, Tk, H, D,
                             q_scale, sm_scale, rate, seed, stream);
}

// The same for the bf16 route: q, k, v, o, dout, dq, dk, dv bf16 with 16-byte
// aligned bases, lse (B*H, Tq) from flash_mha_bf16, rowdot fp32 scratch.
int flash_mha_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, const unsigned char* mask,
                       float* rowdot, void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
                       int D, float q_scale, float sm_scale, float rate, int seed, void* stream) {
  return dispatch_bwd<bf16>(q, k, v, o, dout, lse, mask, rowdot, dq, dk, dv, B, Tq, Tk, H, D,
                            q_scale, sm_scale, rate, seed, stream);
}

}  // extern "C"
