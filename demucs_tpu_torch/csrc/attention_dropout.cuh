// K3's train-time dropout on the attention probabilities: the counter hash of
// demucs_tpu/ops/pallas/attention.py (_attn_kernel, _uniform_hash), bit for
// bit, so the forward, the backward and the plain version
// (demucs_tpu_torch/ops/attention.py::dropout_keep) drop the same scores
// whatever their tiles. A score of global query row r and key j in batch-head
// bh = b * H + h is kept where
//   u = murmur3_fmix32(r * 0x9E3779B1 ^ j * 0x85EBCA77 ^ (seed + bh * 0x27D4EB2F)) >> 8
// scaled by 2^-24 is at least the rate (all in uint32 arithmetic). As u
// < 2^24 and rate 2^24 are exact in fp32, that is u >= t = ceil(rate 2^24),
// an integer compare (no conversion to float per score).
//
// The keep test in two parts. The counter's three-way XOR and the
// finalizer's first step, x ^= x >> 16, are linear over GF(2), so they split
// into a row term and a column term,
//   R'(r) = (R ^ s) ^ ((R ^ s) >> 16),  R = r * 0x9E3779B1, s the salt,
//   K'(j) = K ^ (K >> 16),              K = j * 0x85EBCA77,
// whose XOR is the counter after that step: a kernel forms R' once per row
// and K' once per key (the bf16 route once per tile, in shared memory) and
// shares them across the scores. What stays per score (kept): the XOR of the
// two terms, the multiply by 0x85EBCA6B, x ^= x >> 13, the multiply by
// 0xC2B2AE35, x ^= x >> 16, and one compare, x >= t << 8 (= (x >> 8) >= t;
// exact as t < 2^24 for every rate below 1, which every entry point refuses
// otherwise). The right shifts stay shifts: as high words of products by
// powers of two (mul.hi, meant for the FMA pipe) the H100 ran the bf16
// forward slower (PERF.md). tests/test_torch_dropout_hash.py models this
// form against the Pallas hash.

#pragma once

#include <math.h>

#include <cstdint>

struct Dropout {
  float rate;          // 0: no dropout
  float scale;         // 1 / (1 - rate), applied to the kept probabilities
  uint32_t seed;
  uint32_t limit;      // t << 8, t = ceil(rate 2^24): u = x >> 8 below t is dropped
  int row0;            // the launch's first global query row (a piece of a longer call's rows)

  static Dropout make(float rate, uint32_t seed, int row0 = 0) {
    return Dropout{rate, rate > 0.f ? 1.f / (1.f - rate) : 1.f, seed,
                   (uint32_t)ceilf(rate * 16777216.f) << 8, row0};
  }

  __device__ __forceinline__ uint32_t salt(int bh) const {
    return seed + (uint32_t)bh * 0x27D4EB2Fu;
  }

  // R'(row) of a batch-head's salt.
  static __device__ __forceinline__ uint32_t row_term(int row, uint32_t salt) {
    const uint32_t x = (uint32_t)row * 0x9E3779B1u ^ salt;
    return x ^ (x >> 16);
  }

  // K'(j) from K = j * 0x85EBCA77 (mod 2^32).
  static __device__ __forceinline__ uint32_t col_term(uint32_t k) { return k ^ (k >> 16); }

  // The rest of the finalizer on x = R' ^ K', then the compare.
  __device__ __forceinline__ bool kept(uint32_t x) const {
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= limit;
  }

  __device__ __forceinline__ bool keep(int row, int col, uint32_t salt) const {
    return kept(row_term(row, salt) ^ col_term((uint32_t)col * 0x85EBCA77u));
  }
};
