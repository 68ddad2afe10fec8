// FLAC's byte- and bit-sequential loops for demucs_tpu_torch/flacio.py, with a
// plain C interface for ctypes (demucs_tpu_torch/native.py builds this file
// with g++ at first use).
//
// The codec assembles and parses frames with numpy; these are the loops numpy
// cannot vectorize: the frame CRCs, the Rice bit scan (remainder bits alias
// the unary terminators) and the LPC integer predictor (an IIR filter).
// native.py keeps a pure-Python twin of each, which the tests hold these
// against.

#include <cstdint>

extern "C" {

// CRC-8, polynomial 0x07, initial value 0, MSB first (the frame header's).
uint32_t flac_crc8(const uint8_t* data, int64_t n) {
  static uint8_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) {
      uint8_t c = (uint8_t)i;
      for (int k = 0; k < 8; ++k) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
      table[i] = c;
    }
    init = true;
  }
  uint8_t crc = 0;
  for (int64_t i = 0; i < n; ++i) crc = table[crc ^ data[i]];
  return crc;
}

// CRC-16, polynomial 0x8005, initial value 0, MSB first (the whole frame's).
uint32_t flac_crc16(const uint8_t* data, int64_t n) {
  static uint16_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) {
      uint16_t c = (uint16_t)(i << 8);
      for (int k = 0; k < 8; ++k)
        c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
      table[i] = c;
    }
    init = true;
  }
  uint16_t crc = 0;
  for (int64_t i = 0; i < n; ++i) crc = (uint16_t)((crc << 8) ^ table[(crc >> 8) ^ data[i]]);
  return crc;
}

// Decode `count` Rice codes of parameter k, starting at the MSB-first bit
// offset `bitpos` of data[0, nbytes), into zigzag-decoded residuals. Returns
// the bit offset after the last code, or -1 when the codes run past the data.
int64_t flac_rice_decode(const uint8_t* data, int64_t nbytes, int64_t bitpos, int64_t count,
                         int k, int64_t* out) {
  const int64_t nbits = nbytes * 8;
  for (int64_t i = 0; i < count; ++i) {
    int64_t q = 0;
    while (bitpos < nbits && !((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1)) {
      ++bitpos;
      ++q;
    }
    if (bitpos >= nbits) return -1;
    ++bitpos;  // the terminating 1 bit
    uint64_t u = (uint64_t)q << k;
    for (int j = k - 1; j >= 0; --j) {
      if (bitpos >= nbits) return -1;
      u |= (uint64_t)((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1) << j;
      ++bitpos;
    }
    out[i] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
  }
  return bitpos;
}

// FLAC's integer LPC in place: x[0, order) holds the warm-up samples and
// x[order, n) the residuals; each x[i] becomes the residual plus
// (sum_j coefs[j] * x[i-1-j]) >> shift.
void flac_lpc_restore(const int32_t* coefs, int order, int shift, int64_t* x, int64_t n) {
  for (int64_t i = order; i < n; ++i) {
    int64_t pred = 0;
    for (int j = 0; j < order; ++j) pred += (int64_t)coefs[j] * x[i - 1 - j];
    x[i] += pred >> shift;
  }
}

}  // extern "C"
