// K1 and K2: the windowed STFT and the windowed inverse STFT with overlap-add,
// as dense real-DFT products in fp32 on CUDA cores (sm_90a).
//
// Replaces demucs_tpu/ops/pallas/stft.py: stft_chunk_dft (kernel _stft_kernel)
// and istft_chunk_dft (kernel _istft_kernel).
//
// K1  z[m, n] = sum_k x[row(m) * row_len + frame(m) * hop + k] * G[k, n]
//     with G = window * rDFT basis (n_fft, freqs), real and imaginary parts.
//     The Pallas kernel fed 4 shifted copies of the hop-chunked signal because
//     its blocks must be rectangular; here each output row m = (row, frame)
//     reads its frame straight from the padded signal at offset frame * hop,
//     so the A operand is a strided view (row stride hop) and no copy is made.
// K2  out[row, c * hop + s] = sum_{j < n_fft / hop} sum_f
//         Zr[row, c - j, f] * Mr[f, j * hop + s] + Zi[row, c - j, f] * Mi[f, j * hop + s]
//     with M = window * inverse rDFT basis (freqs, n_fft). The Pallas kernel
//     summed over frequency blocks by revisiting its output block along a
//     sequential grid axis; CUDA blocks run in no order, so one block owns
//     one output tile and loops over all shifts j and frequencies itself:
//     no atomics, and the sum order is fixed (deterministic). Frames c - j
//     out of range are skipped by the A loader instead of zero-padded copies.
//
// Bound: at the released shape (n_fft 4096, 2049 freqs) both are
// compute-bound products (about 11.4 GFLOP per signal row, against about
// 11 MB of basis read once per tile column) on the card's fp32 FMA rate.
// The design is the plain one: 64 x 64 output tiles, 16-deep K slices staged
// in shared memory, 4 x 4 outputs per thread, fp32 accumulators. Tensor
// cores (TF32 wgmma) and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // reduction slice staged in shared memory
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // columns per thread
constexpr int THREADS = 256; // (BM / TM) * (BN / TN)
constexpr int APAD = 4;      // keeps the transposed A tile 16-byte aligned, fewer bank conflicts
constexpr int A_LOADS = BM * BK / THREADS;  // 4
constexpr int B_LOADS = BK * BN / THREADS;  // 4

__global__ void __launch_bounds__(THREADS)
stft_dft_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                const float* __restrict__ gi, float* __restrict__ zr,
                float* __restrict__ zi, int rows, int row_len, int n_frames,
                int n_fft, int hop, int freqs) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Brs[BK][BN];
  __shared__ __align__(16) float Bis[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const long long M = (long long)rows * n_frames;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Each thread loads A_LOADS elements of the A tile per slice: row r, column k.
  const float* a_row[A_LOADS];
  int a_r[A_LOADS], a_k[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int idx = tid + i * THREADS;
    a_r[i] = idx / BK;
    a_k[i] = idx % BK;
    const long long m = m0 + a_r[i];
    if (m < M) {
      const long long row = m / n_frames;
      const long long t = m % n_frames;
      a_row[i] = x + row * row_len + t * hop;
    } else {
      a_row[i] = nullptr;
    }
  }

  float accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accr[i][j] = 0.f;
      acci[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int k = k0 + a_k[i];
      As[a_k[i]][a_r[i]] = (a_row[i] != nullptr && k < n_fft) ? a_row[i][k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / BN;
      const int n = idx % BN;
      const bool ok = (k0 + k < n_fft) && (n0 + n < freqs);
      const long long off = (long long)(k0 + k) * freqs + n0 + n;
      Brs[k][n] = ok ? gr[off] : 0.f;
      Bis[k][n] = ok ? gi[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 br = *reinterpret_cast<const float4*>(&Brs[k][tx * TN]);
      const float4 bi = *reinterpret_cast<const float4*>(&Bis[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float brv[TN] = {br.x, br.y, br.z, br.w};
      const float biv[TN] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accr[i][j] = fmaf(av[i], brv[j], accr[i][j]);
          acci[i][j] = fmaf(av[i], biv[j], acci[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < freqs) {
        zr[m * freqs + n] = accr[i][j];
        zi[m * freqs + n] = acci[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
istft_dft_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ mr, const float* __restrict__ mi,
                 float* __restrict__ out, int rows, int n_frames, int freqs,
                 int n_fft, int hop) {
  __shared__ __align__(16) float Ars[BK][BM + APAD];
  __shared__ __align__(16) float Ais[BK][BM + APAD];
  __shared__ __align__(16) float Brs[BK][BN];
  __shared__ __align__(16) float Bis[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int ratio = n_fft / hop;
  const int n_chunks = n_frames - 1 + ratio;
  const long long M = (long long)rows * n_chunks;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  long long a_row[A_LOADS];  // (row, chunk) of each A element this thread loads
  int a_chunk[A_LOADS], a_r[A_LOADS], a_k[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int idx = tid + i * THREADS;
    a_r[i] = idx / BK;
    a_k[i] = idx % BK;
    const long long m = m0 + a_r[i];
    a_row[i] = m < M ? m / n_chunks : -1;
    a_chunk[i] = m < M ? (int)(m % n_chunks) : 0;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < ratio; ++j) {
    // Frame c - j feeds output chunk c with its j-th hop slice.
    const float* ar[A_LOADS];
    const float* ai[A_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int t = a_chunk[i] - j;
      const bool ok = a_row[i] >= 0 && t >= 0 && t < n_frames;
      const long long off = ok ? (a_row[i] * n_frames + t) * freqs : 0;
      ar[i] = ok ? zr + off : nullptr;
      ai[i] = ok ? zi + off : nullptr;
    }
    for (int f0 = 0; f0 < freqs; f0 += BK) {
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int f = f0 + a_k[i];
        const bool ok = ar[i] != nullptr && f < freqs;
        Ars[a_k[i]][a_r[i]] = ok ? ar[i][f] : 0.f;
        Ais[a_k[i]][a_r[i]] = ok ? ai[i][f] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / BN;
        const int n = idx % BN;
        const bool ok = (f0 + k < freqs) && (n0 + n < hop);
        const long long off = (long long)(f0 + k) * n_fft + (long long)j * hop + n0 + n;
        Brs[k][n] = ok ? mr[off] : 0.f;
        Bis[k][n] = ok ? mi[off] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a_r4 = *reinterpret_cast<const float4*>(&Ars[k][ty * TM]);
        const float4 a_i4 = *reinterpret_cast<const float4*>(&Ais[k][ty * TM]);
        const float4 b_r4 = *reinterpret_cast<const float4*>(&Brs[k][tx * TN]);
        const float4 b_i4 = *reinterpret_cast<const float4*>(&Bis[k][tx * TN]);
        const float arv[TM] = {a_r4.x, a_r4.y, a_r4.z, a_r4.w};
        const float aiv[TM] = {a_i4.x, a_i4.y, a_i4.z, a_i4.w};
        const float brv[TN] = {b_r4.x, b_r4.y, b_r4.z, b_r4.w};
        const float biv[TN] = {b_i4.x, b_i4.y, b_i4.z, b_i4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(aiv[i], biv[jj], fmaf(arv[i], brv[jj], acc[i][jj]));
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + tx * TN + jj;
      if (n < hop) out[m * hop + n] = acc[i][jj];
    }
  }
}

}  // namespace

extern "C" {

// x (rows, row_len) -> zr, zi (rows, n_frames, freqs); gr, gi (n_fft, freqs).
int stft_dft_f32(const float* x, const float* gr, const float* gi, float* zr,
                 float* zi, int rows, int row_len, int n_frames, int n_fft,
                 int hop, int freqs, void* stream) {
  const long long M = (long long)rows * n_frames;
  if (M == 0 || freqs == 0) return (int)cudaGetLastError();
  const dim3 grid((freqs + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
  stft_dft_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, gr, gi, zr, zi, rows, row_len, n_frames, n_fft, hop, freqs);
  return (int)cudaGetLastError();
}

// zr, zi (rows, n_frames, freqs) -> out (rows, (n_frames - 1) * hop + n_fft);
// mr, mi (freqs, n_fft); requires n_fft % hop == 0.
int istft_dft_f32(const float* zr, const float* zi, const float* mr,
                  const float* mi, float* out, int rows, int n_frames,
                  int freqs, int n_fft, int hop, void* stream) {
  const long long M = (long long)rows * (n_frames - 1 + n_fft / hop);
  if (M == 0 || hop == 0) return (int)cudaGetLastError();
  const dim3 grid((hop + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
  istft_dft_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      zr, zi, mr, mi, out, rows, n_frames, freqs, n_fft, hop);
  return (int)cudaGetLastError();
}

}  // extern "C"
