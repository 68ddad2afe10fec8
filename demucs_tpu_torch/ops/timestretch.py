"""Time-stretch and pitch-shift on the host, in numpy (port of
``demucs_tpu/ops/timestretch.py``; behavioral reference: the ``soundstretch``
binary that ``demucs/repitch.py:59-86`` calls).

The repitch augment's fallback when ``soundstretch`` is not installed, with
the same parameterization:

- ``time_stretch``: WSOLA (waveform-similarity overlap-add), SoundTouch's
  family of algorithm: output frames are copied from waveform-aligned source
  positions and cross-faded, so transients and the stereo image survive.
- ``resample``: resampling by an arbitrary ratio (pitch shifting needs
  ``2**(semitones/12)``): ``scipy.signal.resample_poly`` at the ratio's
  rational approximation when scipy is there, else a Kaiser-windowed-sinc
  polyphase interpolator.
- ``repitch_native``: ``soundstretch -pitch=semitones -tempo=percent``:
  output duration ``T / (1 + tempo/100)``, pitch moved by ``semitones``.

Host DSP that the loader threads run, as in the JAX package; the arithmetic
is the JAX package's, operation for operation (``tests/test_torch_timestretch.py``).
"""

from __future__ import annotations

import functools as _functools

import numpy as np

__all__ = ["time_stretch", "resample", "repitch_native"]


def time_stretch(wav: np.ndarray, rate: float, frame: int = 2048,
                 overlap: int = 512, search: int = 512) -> np.ndarray:
    """Stretch ``(C, T)`` audio to duration ``round(T / rate)`` (rate>1 =
    faster/shorter) with WSOLA.

    Each output frame is taken from its nominal source position ``i*hop*rate``
    plus a small offset (±``search``) chosen to maximize cross-correlation
    with the already-written output tail, then cross-faded over ``overlap``
    samples. The offset search runs on the mono mix and is applied to all
    channels, preserving the stereo image.
    """
    assert wav.ndim == 2, wav.shape
    C, T = wav.shape
    out_len = int(round(T / rate))
    if abs(rate - 1.0) < 1e-9:
        return wav[:, :out_len].copy()
    if T <= frame + 2 * search:
        # Too short for WSOLA framing: plain resampling by 1/rate changes
        # duration correctly (with a pitch shift — unavoidable without
        # frames), instead of returning the input truncated/zero-padded.
        ratio = np.float64(out_len) / max(T, 1)
        idx = np.minimum((np.arange(out_len) / ratio).astype(np.int64), T - 1)
        return wav[:, idx].astype(wav.dtype)

    hop = frame - overlap
    x = wav.astype(np.float64)
    mono = x.mean(axis=0)
    out = np.zeros((C, out_len + frame), dtype=np.float64)
    fade_in = np.linspace(0.0, 1.0, overlap, endpoint=False)
    fade_out = 1.0 - fade_in

    # First frame: copy verbatim from the start.
    out[:, :frame] = x[:, :frame]
    pos_out = hop
    while pos_out < out_len:
        nominal = int(round(pos_out * rate))
        lo = max(0, min(nominal - search, T - frame))
        hi = max(lo, min(nominal + search, T - frame))
        # match the output tail (what the new frame's overlap region must
        # continue) against candidate source windows
        tail = out[:, pos_out : pos_out + overlap].mean(axis=0)
        n_cand = hi - lo + 1
        if n_cand > 1 and float(np.abs(tail).max()) > 0:
            # normalized cross-correlation over the contiguous search region
            # (np.correlate's C loop and cumsum norms: no (n_cand, overlap)
            # gather, which numpy's fancy indexing makes slow)
            region = mono[lo : hi + overlap]
            dots = np.correlate(region, tail, mode="valid")[:n_cand]
            sq = np.concatenate([[0.0], np.cumsum(region * region)])
            norms = np.sqrt(sq[overlap : overlap + n_cand] - sq[:n_cand]) + 1e-12
            best = int(np.argmax(dots / norms))
            src = lo + best
        else:
            src = min(nominal, T - frame)
        piece = x[:, src : src + frame]
        out[:, pos_out : pos_out + overlap] = (
            out[:, pos_out : pos_out + overlap] * fade_out + piece[:, :overlap] * fade_in
        )
        out[:, pos_out + overlap : pos_out + frame] = piece[:, overlap:]
        pos_out += hop
    return out[:, :out_len].astype(wav.dtype)


@_functools.lru_cache(maxsize=16)
def _polyphase_table(ratio_key: int, taps: int, phases: int) -> np.ndarray:
    """(phases, taps) Kaiser-sinc interpolation kernels at quantized phases.

    ``ratio_key`` is the anti-alias cutoff ratio quantized to 1e-6 (cache
    key); kernels are normalized to unit DC gain per phase."""
    cutoff = min(1.0, ratio_key * 1e-6)
    half = taps // 2
    k = np.arange(-half + 1, half + 1)  # (taps,)
    frac = np.arange(phases)[:, None] / phases
    t = k[None, :] - frac  # (phases, taps)
    beta = 8.0
    xw = np.clip(t / half, -1.0, 1.0)
    win = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - xw * xw))) / np.i0(beta)
    kernel = cutoff * np.sinc(cutoff * t) * win
    kernel /= np.maximum(kernel.sum(axis=1, keepdims=True), 1e-12)
    return kernel


def resample(wav: np.ndarray, ratio: float, taps: int = 32,
             block: int = 262144, phases: int = 1024) -> np.ndarray:
    """Resample ``(C, T)`` by an arbitrary ``ratio`` (out rate / in rate)
    with a polyphase Kaiser-windowed-sinc interpolator; output length
    ``round(T*ratio)``.

    Source positions are quantized to a 1/``phases``-sample grid so the
    kernels come from a precomputed (phases, taps) table (max timing error
    0.5/phases samples ≈ -70 dB phase ripple at Nyquist — far below
    augmentation tolerances); evaluated blockwise so full-length songs never
    materialize O(out_len x taps) intermediates.

    When scipy is available, the rational approximation of ``ratio`` goes
    through ``scipy.signal.resample_poly`` (a polyphase filter in C, far
    faster on full tracks than the numpy path, which is bound by its
    gathers)."""
    assert wav.ndim == 2, wav.shape
    C, T = wav.shape
    out_len = int(round(T * ratio))
    try:
        from fractions import Fraction

        from scipy.signal import resample_poly

        fr = Fraction(ratio).limit_denominator(1000)  # ratio error <~1e-6
        y = resample_poly(np.asarray(wav, np.float32), fr.numerator,
                          fr.denominator, axis=1)
        if y.shape[-1] < out_len:
            y = np.pad(y, [(0, 0), (0, out_len - y.shape[-1])], mode="edge")
        return y[:, :out_len].astype(wav.dtype)
    except ImportError:
        pass
    half = taps // 2
    k = np.arange(-half + 1, half + 1)  # (taps,)
    table = _polyphase_table(int(round(min(1.0, ratio) * 1e6)), taps, phases)
    src = np.pad(wav, [(0, 0), (half, half + 2)], mode="edge")
    out = np.empty((C, out_len), dtype=wav.dtype)
    for o0 in range(0, out_len, block):
        o1 = min(out_len, o0 + block)
        # position on the 1/phases grid
        scaled = np.round(np.arange(o0, o1) * (phases / ratio)).astype(np.int64)
        base = scaled // phases
        ph = (scaled % phases).astype(np.int32)
        idx = base[:, None] + k[None, :] + half  # into padded source
        out[:, o0:o1] = np.einsum("ot,cot->co", table[ph], src[:, idx])
    return out


def repitch_native(wav: np.ndarray, pitch: float, tempo: float,
                   samplerate: int = 44100) -> np.ndarray:
    """soundstretch-parameterized repitch (repitch.py:59-86 semantics):
    ``pitch`` in semitones, ``tempo`` in percent; output length is
    ``T / (1 + tempo/100)``; ``samplerate`` is unchanged."""
    del samplerate  # parameterization is rate-free
    C, T = wav.shape
    k = 2.0 ** (pitch / 12.0)
    tempo_factor = 1.0 + tempo / 100.0
    if abs(pitch) < 1e-9 and abs(tempo) < 1e-9:
        return wav.copy()
    # stretch so that after the pitch resample the duration is T/tempo_factor
    stretch_rate = tempo_factor / k
    y = time_stretch(wav, stretch_rate) if abs(stretch_rate - 1) > 1e-9 else wav
    if abs(k - 1) > 1e-9:
        y = resample(y, 1.0 / k)
    want = int(round(T / tempo_factor))
    if y.shape[-1] < want:
        y = np.pad(y, [(0, 0), (0, want - y.shape[-1])])
    return y[:, :want]
