// K3: multi-head attention over projected q/k/v with an online softmax, fp32.
//
// Replaces demucs_tpu/ops/pallas/attention.py: flash_mha (kernel _attn_kernel).
//
//   o[b, i, h*D:(h+1)*D] = softmax_j(q_i . k_j / sqrt(D), masked) @ v[b, :, h*D:(h+1)*D]
//
// q (B, Tq, H*D), k and v (B, Tk, H*D), o (B, Tq, H*D), all row-major fp32.
// Heads are read straight out of the (B, T, C) layout at column h*D: no
// transposes (the Pallas wrapper transposed to (B*H, T, D) and padded T).
// The Pallas block held all of K and V of a head in VMEM (1.4 MB at
// Tk = 2688, D = 64); here K/V stream through shared memory in tiles of 32
// keys, and the score matrix never leaves the block.
//
// An optional keep-mask (Tq, Tk) of bytes is shared by batch and heads:
// masked scores are -inf. The rescale is -inf-safe as in the Pallas kernel:
// a row with no kept key so far keeps l == 0, and a row with no kept key at
// all ends as 0 / 0 = NaN, as the plain softmax over all -inf does.
//
// Layout of the work: one block = 64 query rows of one (batch, head); four
// threads per query row. Each thread holds its query row in registers (scaled
// by 1/sqrt(D)), scores 8 of the 32 keys of a tile, and owns D/4 output
// columns (4*lane + 16*u + 0..3, read as float4 so the four threads of a row
// touch 16 consecutive floats). Bound: at the released shapes (Tq, Tk of
// 1344..2688, D = 64) the work is about 4*Tq*Tk*D flops against a few MB of
// q/k/v, so the card's fp32 FMA rate bounds it; this simple version is
// limited by shared-memory reads instead. Tensor cores (wgmma) are later work.
// Templated on D in {32, 48, 64}.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // keys per tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = BKV / TPR;  // keys scored per thread per tile

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const unsigned char* __restrict__ mask,
                 float* __restrict__ o, int Tq, int Tk, int H, float sm_scale) {
  constexpr int KS = D + 4;        // padded K row: float4-aligned, conflict-free
  constexpr int U = D / 16;        // float4 groups of output columns per thread
  __shared__ __align__(16) float Ks[BKV][KS];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ float Ps[BQ][BKV + 1];

  const int C = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int qi = tid / TPR;
  const int lane = tid % TPR;
  const int qrow = blockIdx.x * BQ + qi;
  const bool q_ok = qrow < Tq;

  float qr[D];
  {
    const float* qp = q + ((long long)b * Tq + (q_ok ? qrow : 0)) * C + h * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 t = q_ok ? *reinterpret_cast<const float4*>(qp + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[d] = t.x * sm_scale;
      qr[d + 1] = t.y * sm_scale;
      qr[d + 2] = t.z * sm_scale;
      qr[d + 3] = t.w * sm_scale;
    }
  }
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_prev = -INFINITY;
  float l = 0.f;

  const float* kb = k + (long long)b * Tk * C + h * D;
  const float* vb = v + (long long)b * Tk * C + h * D;
  const unsigned char* mrow = (mask != nullptr && q_ok) ? mask + (long long)qrow * Tk : nullptr;

  for (int k0 = 0; k0 < Tk; k0 += BKV) {
    for (int idx = tid; idx < BKV * D / 4; idx += THREADS) {
      const int j = idx / (D / 4);
      const int d = (idx % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + j < Tk) {
        kv = *reinterpret_cast<const float4*>(kb + (long long)(k0 + j) * C + d);
        vv = *reinterpret_cast<const float4*>(vb + (long long)(k0 + j) * C + d);
      }
      *reinterpret_cast<float4*>(&Ks[j][d]) = kv;
      *reinterpret_cast<float4*>(&Vs[j][d]) = vv;
    }
    __syncthreads();

    float s[KPT];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int j = lane + TPR * e;
      const int key = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      const bool keep = key < Tk && (mrow == nullptr || mrow[key] != 0);
      s[e] = keep ? dot : -INFINITY;
      mx = fmaxf(mx, s[e]);
    }
    // The four threads of a row are adjacent lanes of one warp.
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_prev, mx);
    const float safe_m = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m_prev - safe_m);  // exp(-inf) == 0
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const float p = expf(s[e] - safe_m);
      Ps[qi][lane + TPR * e] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m_prev = m_new;
    __syncwarp();

#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u].x *= alpha;
      acc[u].y *= alpha;
      acc[u].z *= alpha;
      acc[u].w *= alpha;
    }
#pragma unroll 8
    for (int j = 0; j < BKV; ++j) {
      const float p = Ps[qi][j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][4 * lane + 16 * u]);
        acc[u].x = fmaf(p, vv.x, acc[u].x);
        acc[u].y = fmaf(p, vv.y, acc[u].y);
        acc[u].z = fmaf(p, vv.z, acc[u].z);
        acc[u].w = fmaf(p, vv.w, acc[u].w);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

  if (q_ok) {
    float* op = o + ((long long)b * Tq + qrow) * C + h * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 r = make_float4(acc[u].x / l, acc[u].y / l, acc[u].z / l, acc[u].w / l);
      *reinterpret_cast<float4*>(op + 4 * lane + 16 * u) = r;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const unsigned char* mask, float* o, int B, int Tq, int Tk,
                   int H, float sm_scale, cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_mha_kernel<D><<<grid, THREADS, 0, stream>>>(q, k, v, mask, o, Tq, Tk, H, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Tq, H*D), k/v (B, Tk, H*D), mask (Tq, Tk) bytes or null -> o (B, Tq, H*D).
int flash_mha_f32(const float* q, const float* k, const float* v,
                  const unsigned char* mask, float* o, int B, int Tq, int Tk,
                  int H, int D, float sm_scale, void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, mask, o, B, Tq, Tk, H, sm_scale, s);
    case 48: return (int)launch<48>(q, k, v, mask, o, B, Tq, Tk, H, sm_scale, s);
    case 64: return (int)launch<64>(q, k, v, mask, o, B, Tq, Tk, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
