// K1 and K2: the windowed STFT and the windowed inverse STFT with overlap-add,
// as fp32 FFTs in shared memory on CUDA cores (sm_90a).
//
// Replaces demucs_tpu/ops/pallas/stft.py: stft_chunk_dft (kernel _stft_kernel)
// and istft_chunk_dft (kernel _istft_kernel). The Pallas kernels took every
// frame's DFT as a dense product with a windowed basis, to feed the TPU's
// matrix unit: O(n_fft) operations per bin and a 67 MB basis read at n_fft
// 4096. Here each frame is one real FFT of n = n_fft points:
//
// K1  X_t[m] = sum_k w[k] x[row, t*hop + k] exp(-2 pi i mk / n), m = 0..n/2.
//     One block per frame. The n windowed samples are packed into n/2
//     complex points c[k] = y[2k] + i y[2k+1], transformed by a complex FFT
//     of n/2 points, C, and split into the real DFT's bins:
//         X[m] = E[m] + W^m O[m],  W = exp(-2 pi i / n),
//         E[m] = (C[m] + conj C[n/2 - m]) / 2,  O[m] = (C[m] - conj C[n/2 - m]) / 2i.
// K2  out[row, p] = sum_t w[p - t*hop] irfft(X_t)[p - t*hop], the inverse
//     real DFT with numpy's convention: 1/n, and the imaginary parts of bins
//     0 and n/2 ignored. One block owns one row and `group` consecutive output
//     chunks of hop samples. It inverts, in order of t, every frame that
//     reaches those chunks: it folds the bins back into c = E + iO (E and O
//     from X as above, inverted), takes the inverse FFT as a forward FFT of
//     conj c (x[2k] + i x[2k+1] = conj FFT(conj c)[k] / (n/2)), windows the n
//     samples and adds them to an accumulator in shared memory. No atomics,
//     and every output sample sums its frames in the same order (t rising).
//     It recomputes (group + n/hop - 1) / group FFTs per frame instead of
//     keeping windowed frames in device memory.
//
// The FFT (fft_shared) is Stockham's autosort form, so the result comes out
// in natural order with no bit reversal: one radix-2 stage when log2(n/2) is
// odd, then radix-4 stages with the butterflies in registers. Each stage
// reads its inputs into registers, syncs, and writes its outputs in place:
// one buffer of shared memory (16 KB at n_fft 4096), not two, so that more
// blocks fit on an SM, since one block's chain of stages is latency-bound.
// Twiddles come from a table built in float64 and rounded to fp32 by the
// wrapper: W^m = exp(-2 pi i m / n) for m = 0..n/2 (split and fold), then
// each radix-4 stage's own run, laid out so that a warp's loads coalesce.
// None comes from __sinf/__cosf, and this file is built without
// --use_fast_math.
//
// Bound: bytes. At n_fft 4096 a frame moves 16 KB of signal in and 16 KB of
// spectrum out (K1), or the reverse (K2), for about 1.3e5 operations: 4 FLOP
// per byte, far below the card's 20 fp32 FLOP per byte of HBM. The kernels
// read each input element from device memory once per frame that holds it
// (hop = n/4: the signal 4 times, mostly from L2) and write each output once;
// what remains is shared-memory traffic, syncs and the latency of one block's
// chain of FFT stages, which enough blocks in flight hide.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_LOG2_N = 8;   // n_fft 256
constexpr int MAX_LOG2_N = 14;  // n_fft 16384
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, opt in per kernel
constexpr int SMEM_MAX = 232448;         // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Forward complex FFT (exp(-2 pi i jk / h)) of the h = 2^log2h points in a,
// in place. Every thread of the block calls it; tw is the wrapper's table
// (see stft_dft_f32), whose stage part gives each radix-4 stage its twiddles
// W^(r k), r = 1..3, as three runs over k, so that neighbouring threads read
// neighbouring entries. BPT radix-4 butterflies per thread and stage cover
// h / 4 <= BPT * THREADS. Each stage loads its inputs into registers, waits
// for the whole block, then stores its outputs over them: one buffer of
// shared memory instead of Stockham's two. Starts and ends with a
// __syncthreads, so a is ready before and after.
template <int BPT>
__device__ void fft_shared(float2* a, int log2h, const float2* __restrict__ tw) {
  const int h = 1 << log2h;
  int ns = 1;  // length of the sub-transforms done so far
  __syncthreads();
  if (log2h & 1) {  // radix 2 at ns = 1: no twiddles, output index 2j + s
    const int half = h >> 1;
    float2 v[2 * BPT][2];
#pragma unroll
    for (int i = 0; i < 2 * BPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < half) {
        v[i][0] = a[j];
        v[i][1] = a[j + half];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * BPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < half) {
        a[2 * j] = cadd(v[i][0], v[i][1]);
        a[2 * j + 1] = csub(v[i][0], v[i][1]);
      }
    }
    __syncthreads();
    ns = 2;
  }
  const int q = h >> 2;
  const float2* stage_tw = tw + h + 1;  // past the split's W^m, m = 0..h
  for (; ns < h; stage_tw += 3 * ns, ns <<= 2) {
    // stage_tw[(r - 1) * ns + k] = exp(-2 pi i r k / (4 ns))
    float2 v[BPT][4];
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < q) {
        const int k = j & (ns - 1);  // position inside the sub-transform
#pragma unroll
        for (int r = 0; r < 4; ++r) v[i][r] = a[j + r * q];
        if (k != 0) {
          v[i][1] = cmul(v[i][1], __ldg(&stage_tw[k]));
          v[i][2] = cmul(v[i][2], __ldg(&stage_tw[ns + k]));
          v[i][3] = cmul(v[i][3], __ldg(&stage_tw[2 * ns + k]));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < q) {
        const int k = j & (ns - 1);
        const float2 s0 = cadd(v[i][0], v[i][2]), s1 = csub(v[i][0], v[i][2]);
        const float2 s2 = cadd(v[i][1], v[i][3]), d13 = csub(v[i][1], v[i][3]);
        const float2 s3 = make_float2(d13.y, -d13.x);  // -i (v1 - v3)
        const int d = ((j - k) << 2) + k;
        a[d] = cadd(s0, s2);
        a[d + ns] = cadd(s1, s3);
        a[d + 2 * ns] = csub(s0, s2);
        a[d + 3 * ns] = csub(s1, s3);
      }
    }
    __syncthreads();
  }
}

template <int BPT>
__global__ void __launch_bounds__(THREADS)
stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ window,
                const float2* __restrict__ tw, const float* __restrict__ scale,
                float* __restrict__ zr, float* __restrict__ zi, int row_len, int n_frames,
                int hop, int log2h) {
  extern __shared__ float2 a[];  // n_fft / 2 points
  const int h = 1 << log2h;
  const long long frame = blockIdx.x;  // row * n_frames + t
  const float* src = x + (frame / n_frames) * row_len + (frame % n_frames) * hop;
  const float2* win2 = reinterpret_cast<const float2*>(window);

  // Window, and pack sample pairs into complex points. A frame starts at any
  // sample, so pairs load as float2 only where the frame is 8-byte aligned.
  if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const float2* src2 = reinterpret_cast<const float2*>(src);
    for (int k = threadIdx.x; k < h; k += THREADS) {
      const float2 v = __ldg(&src2[k]), w = __ldg(&win2[k]);
      a[k] = make_float2(v.x * w.x, v.y * w.y);
    }
  } else {
    for (int k = threadIdx.x; k < h; k += THREADS) {
      const float2 w = __ldg(&win2[k]);
      a[k] = make_float2(__ldg(&src[2 * k]) * w.x, __ldg(&src[2 * k + 1]) * w.y);
    }
  }
  fft_shared<BPT>(a, log2h, tw);

  // Split into bins 0..h; consecutive threads write consecutive bins.
  const int freqs = h + 1;
  float* out_r = zr + frame * freqs;
  float* out_i = zi + frame * freqs;
  for (int m = threadIdx.x; m < freqs; m += THREADS) {
    const float2 p = a[m & (h - 1)], q = a[(h - m) & (h - 1)];
    const float2 e = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
    const float2 o = make_float2(0.5f * (p.y + q.y), 0.5f * (q.x - p.x));  // (p - conj q) / 2i
    const float2 wo = cmul(o, __ldg(&tw[m]));
    if (scale == nullptr) {
      out_r[m] = e.x + wo.x;
      out_i[m] = e.y + wo.y;
    } else {  // K2's backward: a scale per bin, real then imaginary parts
      out_r[m] = (e.x + wo.x) * __ldg(&scale[m]);
      out_i[m] = (e.y + wo.y) * __ldg(&scale[freqs + m]);
    }
  }
}

template <int BPT>
__global__ void __launch_bounds__(THREADS)
istft_fft_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ window, const float2* __restrict__ tw,
                 float* __restrict__ out, int n_frames, int hop, int log2h, int group,
                 int blocks_per_row) {
  extern __shared__ float2 a[];  // n_fft / 2 points, then the accumulator
  const int h = 1 << log2h;
  const int n_fft = 2 * h;
  const int n_chunks = n_frames - 1 + n_fft / hop;
  float* acc = reinterpret_cast<float*>(a + h);
  const int row = blockIdx.x / blocks_per_row;
  const int c0 = (blockIdx.x % blocks_per_row) * group;  // first chunk of this block
  const int n_own = min(group, n_chunks - c0) * hop;      // samples this block writes

  // Each thread owns the accumulator entries i = threadIdx.x (mod THREADS)
  // for the whole kernel, so they need no syncs of their own.
  for (int i = threadIdx.x; i < n_own; i += THREADS) acc[i] = 0.f;
  const int freqs = h + 1;
  const float inv_h = 1.0f / h;  // exact: h is a power of two
  const int t_lo = max(0, c0 - n_fft / hop + 1);
  const int t_hi = min(n_frames - 1, c0 + group - 1);
  for (int t = t_lo; t <= t_hi; ++t) {
    const long long base = ((long long)row * n_frames + t) * freqs;
    const float* fr = zr + base;
    const float* fi = zi + base;
    __syncthreads();  // the previous frame's result is read before a is overwritten
    for (int m = threadIdx.x; m < h; m += THREADS) {
      // p = X[m], q = X[h - m]; at m = 0 these are bins 0 and h, whose
      // imaginary parts the inverse real DFT ignores.
      const float2 p = make_float2(__ldg(&fr[m]), m == 0 ? 0.f : __ldg(&fi[m]));
      const float2 q = make_float2(__ldg(&fr[h - m]), m == 0 ? 0.f : __ldg(&fi[h - m]));
      const float2 e = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
      const float2 dd = make_float2(0.5f * (p.x - q.x), 0.5f * (p.y + q.y));
      const float2 w = __ldg(&tw[m]);
      const float2 o = cmul(dd, make_float2(w.x, -w.y));  // (p - conj q) / (2 W^m)
      a[m] = make_float2(e.x - o.y, -(e.y + o.x));         // conj(e + i o)
    }
    fft_shared<BPT>(a, log2h, tw);
    // Frame sample k lands on output sample t*hop + k, local index k - shift.
    const int shift = (c0 - t) * hop;
    for (int i = threadIdx.x; i < n_own; i += THREADS) {
      const int k = shift + i;
      if (k >= 0 && k < n_fft) {
        const float2 v = a[k >> 1];
        const float s = (k & 1) ? -v.y : v.x;
        acc[i] = fmaf(s * inv_h, __ldg(&window[k]), acc[i]);
      }
    }
  }
  float* dst = out + ((long long)row * n_chunks + c0) * hop;
  for (int i = threadIdx.x; i < n_own; i += THREADS) dst[i] = acc[i];
}

// log2(n_fft / 2) for a power of two n_fft in [256, 16384], else -1.
int half_log2(int n_fft) {
  if (n_fft <= 0 || (n_fft & (n_fft - 1)) != 0) return -1;
  int lg = 0;
  while ((1 << lg) < n_fft) ++lg;
  return (lg < MIN_LOG2_N || lg > MAX_LOG2_N) ? -1 : lg - 1;
}

cudaError_t reserve_smem(const void* kernel, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int BPT>
cudaError_t launch_stft(const float* x, const float* window, const float2* tw,
                        const float* scale, float* zr, float* zi, unsigned frames, int row_len,
                        int n_frames, int hop, int log2h, cudaStream_t stream) {
  const size_t smem = sizeof(float2) << log2h;
  cudaError_t err = reserve_smem((const void*)stft_fft_kernel<BPT>, smem);
  if (err != cudaSuccess) return err;
  stft_fft_kernel<BPT><<<frames, THREADS, smem, stream>>>(x, window, tw, scale, zr, zi,
                                                         row_len, n_frames, hop, log2h);
  return cudaGetLastError();
}

template <int BPT>
cudaError_t launch_istft(const float* zr, const float* zi, const float* window,
                         const float2* tw, float* out, unsigned blocks, size_t smem,
                         int n_frames, int hop, int log2h, int group, int blocks_per_row,
                         cudaStream_t stream) {
  cudaError_t err = reserve_smem((const void*)istft_fft_kernel<BPT>, smem);
  if (err != cudaSuccess) return err;
  istft_fft_kernel<BPT><<<blocks, THREADS, smem, stream>>>(
      zr, zi, window, tw, out, n_frames, hop, log2h, group, blocks_per_row);
  return cudaGetLastError();
}

// Radix-4 butterflies per thread and FFT stage: 1, 2, 4 or 8.
int butterflies_per_thread(int log2h) {
  const int q = 1 << (log2h - 2);
  return q <= THREADS ? 1 : q / THREADS;
}

}  // namespace

extern "C" {

// x (rows, row_len) -> zr, zi (rows, n_frames, n_fft / 2 + 1); window (n_fft,);
// n_fft a power of two in [256, 16384]. twiddle (_, 2), complex as re, im:
// exp(-2 pi i m / n_fft) for m = 0..n_fft/2, then for each radix-4 stage of the
// FFT of h = n_fft / 2 points, ns = 1 or 2 (h = 4^s or 2 * 4^s), 4 ns, ...,
// h / 4 in turn, exp(-2 pi i r k / (4 ns)) for r = 1, 2, 3 and k = 0..ns-1.
// scale: null, or 2 (n_fft / 2 + 1) floats that multiply each bin's real and
// then imaginary part (K2's backward: c_k / n_fft, kernels/stft.py).
int stft_dft_f32(const float* x, const float* window, const float* twiddle, const float* scale,
                 float* zr, float* zi, int rows, int row_len, int n_frames, int n_fft, int hop,
                 void* stream) {
  const int log2h = half_log2(n_fft);
  if (log2h < 0 || hop <= 0) return (int)cudaErrorInvalidValue;
  const long long frames = (long long)rows * n_frames;
  if (frames == 0) return (int)cudaGetLastError();
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  const cudaStream_t s = (cudaStream_t)stream;
  const int bpt = butterflies_per_thread(log2h);
  const auto launch = bpt == 1   ? launch_stft<1>
                      : bpt == 2 ? launch_stft<2>
                      : bpt == 4 ? launch_stft<4>
                                 : launch_stft<8>;
  return (int)launch(x, window, tw, scale, zr, zi, (unsigned)frames, row_len, n_frames, hop,
                     log2h, s);
}

// zr, zi (rows, n_frames, n_fft / 2 + 1) -> out (rows, (n_frames - 1) * hop + n_fft);
// window, twiddle as above; n_fft % hop == 0; each block owns `group` chunks of
// hop output samples of one row.
int istft_dft_f32(const float* zr, const float* zi, const float* window,
                  const float* twiddle, float* out, int rows, int n_frames, int n_fft,
                  int hop, int group, void* stream) {
  const int log2h = half_log2(n_fft);
  if (log2h < 0 || hop <= 0 || n_fft % hop != 0 || group <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the FFT buffer of n_fft / 2 points and the accumulator of group * hop samples
  const long long smem =
      (long long)(n_fft / 2) * sizeof(float2) + (long long)group * hop * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n_frames == 0) return (int)cudaGetLastError();
  const int n_chunks = n_frames - 1 + n_fft / hop;
  const int per_row = (n_chunks + group - 1) / group;
  const unsigned blocks = (unsigned)((long long)rows * per_row);
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  const cudaStream_t s = (cudaStream_t)stream;
  const int bpt = butterflies_per_thread(log2h);
  const auto launch = bpt == 1   ? launch_istft<1>
                      : bpt == 2 ? launch_istft<2>
                      : bpt == 4 ? launch_istft<4>
                                 : launch_istft<8>;
  return (int)launch(zr, zi, window, tw, out, blocks, (size_t)smem, n_frames, hop, log2h, group,
                     per_row, s);
}

}  // extern "C"
