// K3's train-time dropout on the attention probabilities: the counter hash of
// demucs_tpu/ops/pallas/attention.py (_attn_kernel, _uniform_hash), bit for
// bit, so the forward, the backward and the plain version
// (demucs_tpu_torch/ops/attention.py::dropout_keep) drop the same scores
// whatever their tiles. A score of global query row r and key j in batch-head
// bh = b * H + h is kept where
//   u = murmur3_fmix32(r * 0x9E3779B1 ^ j * 0x85EBCA77 ^ (seed + bh * 0x27D4EB2F)) >> 8
// scaled by 2^-24 is at least the rate (all in uint32 arithmetic). As u
// < 2^24 and rate 2^24 are exact in fp32, that is u >= ceil(rate 2^24), one
// integer compare (no conversion to float per score).

#pragma once

#include <math.h>

#include <cstdint>

struct Dropout {
  float rate;          // 0: no dropout
  float scale;         // 1 / (1 - rate), applied to the kept probabilities
  uint32_t seed;
  uint32_t threshold;  // ceil(rate 2^24): u below it is dropped

  static Dropout make(float rate, uint32_t seed) {
    return Dropout{rate, rate > 0.f ? 1.f / (1.f - rate) : 1.f, seed,
                   (uint32_t)ceilf(rate * 16777216.f)};
  }

  __device__ __forceinline__ uint32_t salt(int bh) const {
    return seed + (uint32_t)bh * 0x27D4EB2Fu;
  }

  __device__ __forceinline__ bool keep(int row, int col, uint32_t salt) const {
    uint32_t x = ((uint32_t)row * 0x9E3779B1u) ^ ((uint32_t)col * 0x85EBCA77u) ^ salt;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return (x >> 8) >= threshold;
  }
};
