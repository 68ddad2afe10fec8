"""First-party FLAC codec (port of ``demucs_tpu/flacio.py``; no ffmpeg or libFLAC).

The reference encodes FLAC through torchaudio/ffmpeg
(``demucs/audio.py:236-265``); this encoder writes ``--flac`` output with no
external binary, and the matching decoder reads ``.flac`` input.

Encoder: spec-conformant FLAC with fixed blocking, and per subframe the
smallest of CONSTANT / VERBATIM / FIXED(order 0-4)+Rice, with the cheapest
of independent, left/side, side/right and mid/side stereo per frame (no LPC:
slightly larger files than libflac's, the same audio bit for bit). The
per-sample work is numpy; the frame CRCs run in the port's C++ library
(``csrc/codec.cpp`` through ``native.py``).

Decoder: everything the encoder emits plus the rest of the frame syntax that
real files use: LPC subframes, 4/5-bit Rice partitions of any order, escape
partitions, wasted bits and every stereo decorrelation. Its two sequential
loops (the Rice bit scan and the LPC integer predictor) run in the same
library. A C++ library that fails to build raises; the pure-Python twins in
``native.py`` serve the tests only.
"""

from __future__ import annotations

import hashlib
import math
import struct
import typing as tp
from pathlib import Path

import numpy as np

from demucs_tpu_torch import native

__all__ = ["encode_flac", "decode_flac", "write_flac", "read_flac"]

_BLOCK = 4096
_MAX_RICE_K = 14  # 0b1111 is the 4-bit escape code; never emit it


# ---------------------------------------------------------------- CRCs

def _crc8(data: bytes) -> int:
    return native.crc8(data)


def _crc16(data: bytes) -> int:
    return native.crc16(data)


# ---------------------------------------------------------------- bit buffer

class _BitWriter:
    """Accumulates bits as uint8 0/1 arrays; pack() byte-aligns with zeros."""

    def __init__(self):
        self.parts: tp.List[np.ndarray] = []

    def write(self, value: int, n: int) -> None:
        value &= (1 << n) - 1
        self.parts.append(
            ((value >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8))

    def write_signed_array(self, values: np.ndarray, n: int) -> None:
        """Each of ``values`` as an ``n``-bit two's-complement field."""
        v = values.astype(np.int64) & ((1 << n) - 1)
        shifts = np.arange(n - 1, -1, -1, dtype=np.int64)
        self.parts.append(((v[:, None] >> shifts) & 1).astype(np.uint8).ravel())

    def write_rice(self, u: np.ndarray, k: int) -> None:
        """Rice codes: quotient as unary (q zeros then a 1), then k low bits."""
        u = u.astype(np.int64)
        q = u >> k
        lens = q + 1 + k
        total = int(lens.sum())
        out = np.zeros(total, np.uint8)
        starts = np.cumsum(lens) - lens
        out[starts + q] = 1
        for j in range(k):
            out[starts + q + 1 + j] = (u >> (k - 1 - j)) & 1
        self.parts.append(out)

    def nbits(self) -> int:
        return sum(len(p) for p in self.parts)

    def pack(self) -> bytes:
        if not self.parts:
            return b""
        bits = np.concatenate(self.parts)
        return np.packbits(bits).tobytes()


# ---------------------------------------------------------------- encoder

def _utf8_number(value: int) -> bytes:
    """FLAC's UTF-8-style frame-number coding (RFC 3629 pattern, up to 36
    bits)."""
    if value < 0x80:
        return bytes([value])
    out = []
    n = 1
    while value >= (1 << (6 - n) << (6 * n)) and n < 6:
        n += 1
    lead_mask = (0xFF00 >> (n + 1)) & 0xFF
    out.append(lead_mask | (value >> (6 * n)))
    for i in range(n - 1, -1, -1):
        out.append(0x80 | ((value >> (6 * i)) & 0x3F))
    return bytes(out)


def _best_rice_k(u: np.ndarray) -> tp.Tuple[int, int]:
    """(k, total bits) minimizing sum(u >> k) + n*(k+1)."""
    n = len(u)
    if n == 0:
        return 0, 0
    u = u.astype(np.int64)
    best_k, best_bits = 0, int(u.sum()) + n
    for k in range(1, _MAX_RICE_K + 1):
        bits = int((u >> k).sum()) + n * (k + 1)
        if bits < best_bits:
            best_k, best_bits = k, bits
    return best_k, best_bits


def _zigzag(res: np.ndarray) -> np.ndarray:
    res = res.astype(np.int64)
    return (res << 1) ^ (res >> 63)


def _encode_subframe(x: np.ndarray, bps: int) -> _BitWriter:
    """Pick CONSTANT / FIXED+Rice / VERBATIM (whichever is smallest) and
    return the written subframe (its bit count drives the per-frame stereo
    decorrelation choice)."""
    bw = _BitWriter()
    n = len(x)
    if np.all(x == x[0]):
        bw.write(0, 8)  # pad bit + CONSTANT type 000000 + wasted-bits flag 0
        bw.write(int(x[0]), bps)
        return bw

    verbatim_bits = 8 + n * bps
    best = ("verbatim", None, None, verbatim_bits)
    res = x.astype(np.int64)
    for order in range(0, 5):
        if order > 0:
            res = np.diff(res)
        if len(res) == 0:
            break
        u = _zigzag(res)
        k, rice_bits = _best_rice_k(u)
        total = 8 + order * bps + 2 + 4 + 4 + rice_bits
        if total < best[3]:
            best = ("fixed", order, (res.copy(), u, k), total)

    if best[0] == "verbatim":
        bw.write(0b0_000001_0, 8)
        bw.write_signed_array(x, bps)
        return bw

    order = best[1]
    _, u, k = best[2]
    bw.write((0b001000 | order) << 1, 8)  # pad, FIXED type, wasted=0
    if order:
        bw.write_signed_array(x[:order], bps)  # warmup
    bw.write(0b00, 2)   # residual method: 4-bit Rice
    bw.write(0, 4)      # partition order 0
    bw.write(k, 4)
    bw.write_rice(u, k)
    return bw


def encode_flac(samples: np.ndarray, samplerate: int, bits_per_sample: int = 16,
                block_size: int = _BLOCK) -> bytes:
    """Encode integer samples ``(C, T)`` (int32, values within
    ``bits_per_sample`` range) into a complete FLAC stream."""
    samples = np.asarray(samples)
    if samples.ndim != 2 or not 1 <= samples.shape[0] <= 8:
        raise ValueError(f"encode_flac expects (1-8 channels, samples), got {samples.shape}")
    C, T = samples.shape
    if bits_per_sample not in (8, 16, 24):
        raise ValueError(f"bits_per_sample must be 8, 16 or 24, got {bits_per_sample}")
    lim = 1 << (bits_per_sample - 1)
    if samples.size and (samples.min() < -lim or samples.max() >= lim):
        raise ValueError("sample overflow")
    samples = samples.astype(np.int32)

    # MD5 of the raw interleaved little-endian signed samples (STREAMINFO)
    inter = samples.T.astype("<i4").tobytes()
    width = bits_per_sample // 8
    raw = np.frombuffer(inter, np.uint8).reshape(-1, 4)[:, :width].tobytes()
    md5 = hashlib.md5(raw).digest()

    sample_size_bits = {8: 0b001, 16: 0b100, 24: 0b110}[bits_per_sample]
    frames = []
    min_fs, max_fs = 1 << 30, 0
    for fi, lo in enumerate(range(0, T, block_size)):
        x = samples[:, lo:lo + block_size]
        bs = x.shape[1]
        header = bytearray(b"\xff\xf8")  # sync + reserved + fixed blocking
        if bs == block_size and block_size == 4096:
            bs_bits, bs_tail = 0b1100, b""
        elif bs == block_size and block_size == 256:
            bs_bits, bs_tail = 0b1000, b""
        else:
            bs_bits, bs_tail = 0b0111, struct.pack(">H", bs - 1)
        header.append((bs_bits << 4) | 0b0000)  # samplerate: from STREAMINFO

        # Stereo decorrelation: encode L/R/mid/side candidates and keep the
        # cheapest assignment per frame (what libflac does). The transforms
        # are the spec's lossless pairs: mid = (L+R)>>1 carries the shared
        # content, side = L-R the difference (side subframes use bps+1 bits).
        if C == 2 and bs:
            L = x[0].astype(np.int64)
            R = x[1].astype(np.int64)
            sub_l = _encode_subframe(x[0], bits_per_sample)
            sub_r = _encode_subframe(x[1], bits_per_sample)
            sub_s = _encode_subframe(L - R, bits_per_sample + 1)
            sub_m = _encode_subframe((L + R) >> 1, bits_per_sample)
            cands = {
                0b0001: [sub_l, sub_r],          # independent
                0b1000: [sub_l, sub_s],          # left/side
                0b1001: [sub_s, sub_r],          # side/right
                0b1010: [sub_m, sub_s],          # mid/side
            }
            chan_assign, subs = min(
                cands.items(), key=lambda kv: sum(s.nbits() for s in kv[1]))
        else:
            chan_assign = C - 1
            subs = [_encode_subframe(x[c], bits_per_sample) for c in range(C)]

        header.append((chan_assign << 4) | (sample_size_bits << 1))
        header += _utf8_number(fi)
        header += bs_tail
        header.append(_crc8(bytes(header)))

        bw = _BitWriter()
        for s in subs:
            bw.parts.extend(s.parts)
        frame = bytes(header) + bw.pack()
        frame += struct.pack(">H", _crc16(frame))
        frames.append(frame)
        min_fs, max_fs = min(min_fs, len(frame)), max(max_fs, len(frame))

    if not frames:
        min_fs = max_fs = 0

    info = bytearray()
    info += struct.pack(">HH", block_size, block_size)
    info += min_fs.to_bytes(3, "big") + max_fs.to_bytes(3, "big")
    packed = (samplerate << 44) | ((C - 1) << 41) | ((bits_per_sample - 1) << 36) | T
    info += packed.to_bytes(8, "big")
    info += md5
    head = b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + bytes(info)
    return head + b"".join(frames)


def write_flac(path, wav: np.ndarray, samplerate: int,
               bits_per_sample: int = 16) -> None:
    """Float ``(C, T)`` in [-1, 1] -> quantized FLAC file (same int mapping as
    the WAV writer: scale by 2**(bps-1)-1, round, clamp)."""
    lim = (1 << (bits_per_sample - 1)) - 1
    q = np.clip(np.round(np.asarray(wav, np.float64) * lim), -lim - 1, lim)
    Path(path).write_bytes(
        encode_flac(q.astype(np.int32), samplerate, bits_per_sample))


# ---------------------------------------------------------------- decoder

class _BitReader:
    """MSB-first bits of ``raw`` from bit ``pos``. The Rice codes, the bulk of
    a stream, are read from ``raw`` by the C++ scanner; the other reads
    (headers, warm-up samples) unpack only their own window, never the whole
    stream (8 times its size)."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.raw = data
        self.pos = pos_bytes * 8

    def _window(self, nbits: int) -> np.ndarray:
        lo = self.pos >> 3
        hi = min(len(self.raw), (self.pos + nbits + 7) >> 3)
        w = np.unpackbits(np.frombuffer(self.raw, np.uint8, count=hi - lo,
                                        offset=lo))
        start = self.pos - lo * 8
        return w[start:start + nbits]

    def read(self, n: int) -> int:
        out = 0
        for b in self._window(n):
            out = (out << 1) | int(b)
        self.pos += n
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_signed_array(self, count: int, n: int) -> np.ndarray:
        chunk = self._window(count * n).reshape(count, n)
        self.pos += count * n
        weights = (1 << np.arange(n - 1, -1, -1, dtype=np.int64))
        v = (chunk.astype(np.int64) * weights).sum(axis=1)
        return np.where(v >= (1 << (n - 1)), v - (1 << n), v)

    def read_unary(self) -> int:
        q = 0
        while True:
            w = self._window(256)
            if not len(w):
                raise ValueError("bit stream exhausted in unary code")
            nz = np.flatnonzero(w)
            if len(nz):
                self.pos += int(nz[0]) + 1
                return q + int(nz[0])
            q += len(w)
            self.pos += len(w)

    def align(self) -> None:
        self.pos = (self.pos + 7) // 8 * 8


def _read_rice_partitioned(br: _BitReader, n: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError(f"unknown residual method {method}")
    kbits = 4 if method == 0 else 5
    escape = (1 << kbits) - 1
    part_order = br.read(4)
    parts = 1 << part_order
    out = np.empty(n - order, np.int64)
    w = 0
    for p in range(parts):
        count = (n >> part_order) - (order if p == 0 else 0)
        k = br.read(kbits)
        if k == escape:  # raw residuals
            rb = br.read(5)
            vals = br.read_signed_array(count, rb) if rb else np.zeros(count, np.int64)
            out[w:w + count] = vals
        else:
            out[w:w + count] = _rice_decode(br, count, k)
        w += count
    return out


def _rice_decode(br: _BitReader, count: int, k: int) -> np.ndarray:
    """Rice-decode ``count`` residuals with the C++ bit scanner."""
    out, br.pos = native.rice_decode(br.raw, br.pos, count, k)
    return out


def _decode_subframe(br: _BitReader, n: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("subframe sync error")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0b000000:  # CONSTANT
        x = np.full(n, br.read_signed(bps), np.int64)
    elif stype == 0b000001:  # VERBATIM
        x = br.read_signed_array(n, bps)
    elif (stype >> 3) == 0b001:  # FIXED
        order = stype & 0b111
        warm = br.read_signed_array(order, bps) if order else np.zeros(0, np.int64)
        res = _read_rice_partitioned(br, n, order)
        # res = order-th difference of x; invert one diff level at a time:
        # the k-1-th difference's first element comes from the warmup samples
        # via the alternating binomial sum D^{k-1}x[0] = sum (-1)^j C(k-1,j)
        # x[k-1-j], then the rest is first + cumsum of the k-th difference.
        x = res
        for k in range(order, 0, -1):
            first = sum((-1) ** j * math.comb(k - 1, j) * int(warm[k - 1 - j])
                        for j in range(k))
            x = np.concatenate([np.array([first], np.int64),
                                first + np.cumsum(x)])
    elif stype >= 0b100000:  # LPC
        order = (stype & 0b011111) + 1
        warm = br.read_signed_array(order, bps)
        prec = br.read(4) + 1
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift is reserved")
        coefs = br.read_signed_array(order, prec)
        res = _read_rice_partitioned(br, n, order)
        x = np.empty(n, np.int64)
        x[:order] = warm
        x[order:] = res
        native.lpc_restore(coefs, shift, x)
    else:
        raise ValueError(f"reserved subframe type {stype:#08b}")
    return x << wasted


_BLOCKSIZE_TABLE = {
    0b0001: 192, **{i: 576 << (i - 2) for i in range(2, 6)},
    **{i: 256 << (i - 8) for i in range(8, 16)},
}
_SR_TABLE = {
    0b0001: 88200, 0b0010: 176400, 0b0011: 192000, 0b0100: 8000, 0b0101: 16000,
    0b0110: 22050, 0b0111: 24000, 0b1000: 32000, 0b1001: 44100, 0b1010: 48000,
    0b1011: 96000,
}


def decode_flac(data: bytes, verify_md5: bool = True
                ) -> tp.Tuple[np.ndarray, int, int]:
    """-> (samples int32 ``(C, T)``, samplerate, bits_per_sample)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sr = channels = bps = total = None
    md5 = None
    while True:  # metadata blocks
        head = data[pos]
        btype, last = head & 0x7F, bool(head & 0x80)
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            packed = int.from_bytes(body[10:18], "big")
            sr = packed >> 44
            channels = ((packed >> 41) & 0x7) + 1
            bps = ((packed >> 36) & 0x1F) + 1
            total = packed & ((1 << 36) - 1)
            md5 = body[18:34]
        pos += 4 + blen
        if last:
            break
    if sr is None:
        raise ValueError("missing STREAMINFO")

    decoded: tp.List[np.ndarray] = []  # per-frame (channels, bs) blocks
    w = 0
    # total == 0 is legal STREAMINFO for "unknown length" (streamed encodes):
    # decode until the byte stream runs out instead.
    while (total == 0 or w < total) and pos + 4 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            raise ValueError(f"lost frame sync at byte {pos}")
        hdr_start = pos
        bs_bits = data[pos + 2] >> 4
        sr_bits = data[pos + 2] & 0xF
        chan_assign = data[pos + 3] >> 4
        ss_bits = (data[pos + 3] >> 1) & 0x7
        pos += 4
        # UTF-8 coded number
        lead = data[pos]
        nfollow = 0
        while lead & (0x80 >> nfollow) and nfollow < 7:
            nfollow += 1
        pos += 1 + max(0, nfollow - 1)
        if bs_bits == 0b0110:
            bs = data[pos] + 1
            pos += 1
        elif bs_bits == 0b0111:
            bs = struct.unpack(">H", data[pos:pos + 2])[0] + 1
            pos += 2
        else:
            bs = _BLOCKSIZE_TABLE[bs_bits]
        if sr_bits == 0b1100:
            pos += 1
        elif sr_bits in (0b1101, 0b1110):
            pos += 2
        fsr = _SR_TABLE.get(sr_bits, sr)
        del fsr  # frames always carry the STREAMINFO rate in our streams
        crc8_got = data[pos]
        if _crc8(data[hdr_start:pos]) != crc8_got:
            raise ValueError("frame header CRC-8 mismatch")
        pos += 1

        frame_bps = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20, 0b110: 24,
                     0b111: 32}.get(ss_bits, bps)
        br = _BitReader(data, pos)
        if chan_assign <= 0b0111:  # independent
            chans = [_decode_subframe(br, bs, frame_bps)
                     for _ in range(chan_assign + 1)]
        elif chan_assign == 0b1000:  # left/side
            left = _decode_subframe(br, bs, frame_bps)
            side = _decode_subframe(br, bs, frame_bps + 1)
            chans = [left, left - side]
        elif chan_assign == 0b1001:  # right/side
            side = _decode_subframe(br, bs, frame_bps + 1)
            right = _decode_subframe(br, bs, frame_bps)
            chans = [right + side, right]
        elif chan_assign == 0b1010:  # mid/side
            mid = _decode_subframe(br, bs, frame_bps)
            side = _decode_subframe(br, bs, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            chans = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {chan_assign}")
        br.align()
        frame_end = br.pos // 8
        crc_got = struct.unpack(">H", data[frame_end:frame_end + 2])[0]
        if _crc16(data[hdr_start:frame_end]) != crc_got:
            raise ValueError("frame CRC-16 mismatch")
        pos = frame_end + 2

        decoded.append(np.stack(chans))
        w += bs

    out = (np.concatenate(decoded, axis=-1) if decoded
           else np.zeros((channels, 0), np.int64))
    if total:
        if out.shape[-1] < total:
            raise ValueError(
                f"stream truncated: {out.shape[-1]} of {total} samples")
        out = out[:, :total]

    if verify_md5 and md5 and md5 != b"\0" * 16:
        width = bps // 8
        inter = out.T.astype("<i4").tobytes()
        raw = np.frombuffer(inter, np.uint8).reshape(-1, 4)[:, :width].tobytes()
        if hashlib.md5(raw).digest() != md5:
            raise ValueError("decoded audio MD5 mismatch")
    return out.astype(np.int32), sr, bps


def read_flac(path) -> tp.Tuple[np.ndarray, int]:
    """-> (float32 ``(C, T)`` scaled to [-1, 1], samplerate).

    Same decode convention as ``audio.read_wav`` (and torchaudio): divide by
    2**(bps-1), so identical PCM content reads identically from .wav/.flac."""
    samples, sr, bps = decode_flac(Path(path).read_bytes())
    return samples.astype(np.float32) / float(1 << (bps - 1)), sr
