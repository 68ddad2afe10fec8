"""Beat tracking and chroma features on the host (numpy), for the automix
tool (``demucs_tpu_torch/automix.py``), which uses them where librosa is not
installed (the reference's ``tools/automix.py`` calls ``librosa.beat.
beat_track`` and ``librosa.feature.chroma_cqt``):

- ``beat_track``: the onset-strength envelope (positive log-magnitude
  spectral flux), the tempo from its autocorrelation under a log-normal
  prior, then the beat times by Ellis's dynamic-programming tracker (the
  algorithm family librosa implements).
- ``chroma_stft``: STFT bins folded into pitch-class energy. Automix only
  compares time-averaged chroma histograms to find the semitone rotation
  between two songs, for which STFT chroma stands in for CQT chroma.

The same arithmetic as the JAX package's host copy, step for step, so the
two give the same numbers (``tests/test_torch_automix.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["onset_strength", "beat_track", "chroma_stft"]


def _stft_mag(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(T,) -> (frames, n_fft//2+1) magnitude, centered, Hann."""
    pad = n_fft // 2
    y = np.pad(y.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    window = np.hanning(n_fft + 1)[:-1]
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.abs(np.fft.rfft(y[idx] * window, axis=-1))


def onset_strength(y: np.ndarray, sr: int, n_fft: int = 2048,
                   hop: int = 512) -> np.ndarray:
    """Positive log-magnitude spectral flux per frame, mean over bins."""
    if y.ndim == 2:
        y = y.mean(axis=0)
    mag = _stft_mag(y, n_fft, hop)
    logmag = np.log1p(1000.0 * mag)
    flux = np.maximum(0.0, np.diff(logmag, axis=0)).mean(axis=1)
    env = np.concatenate([[0.0], flux])
    # local mean subtraction sharpens onsets
    k = 16
    pad = np.pad(env, (k, k), mode="edge")
    local = np.convolve(pad, np.ones(2 * k + 1) / (2 * k + 1), "valid")
    return np.maximum(0.0, env - local)


def _estimate_tempo(env: np.ndarray, sr: int, hop: int,
                    start_bpm: float = 120.0) -> float:
    """Tempo (BPM) from the onset autocorrelation with a log-normal prior."""
    frames_per_sec = sr / hop
    n = len(env)
    ac = np.correlate(env - env.mean(), env - env.mean(), "full")[n - 1 :]
    ac = ac / (ac[0] + 1e-12)
    lags = np.arange(1, min(n, int(frames_per_sec * 2.0)))  # >= 30 BPM
    bpms = 60.0 * frames_per_sec / lags
    valid = (bpms >= 30) & (bpms <= 300)
    lags, bpms = lags[valid], bpms[valid]
    if len(lags) == 0:
        # Input too short for any lag in the 30-300 BPM window.
        return start_bpm
    prior = np.exp(-0.5 * ((np.log2(bpms / start_bpm)) / 1.0) ** 2)
    return float(bpms[np.argmax(ac[lags] * prior)])


def beat_track(y: np.ndarray, sr: int, hop: int = 512, units: str = "time",
               start_bpm: float = 120.0, tightness: float = 100.0):
    """(tempo_bpm, beat positions) — Ellis DP beat tracker.

    Mirrors ``librosa.beat.beat_track(y=..., sr=..., units='time')``'s return
    contract used by tools/automix.py.
    """
    env = onset_strength(y, sr, hop=hop)
    if not env.any():
        return 0.0, np.array([])
    tempo = _estimate_tempo(env, sr, hop, start_bpm=start_bpm)
    period = 60.0 * sr / (hop * tempo)

    n = len(env)
    env_n = env / (env.std() + 1e-12)
    cumscore = np.array(env_n)
    backlink = np.full(n, -1, dtype=int)
    lo, hi = int(round(period / 2)), int(round(period * 2))
    for i in range(lo, n):
        j0, j1 = max(0, i - hi), i - lo + 1
        if j1 <= j0:
            continue
        js = np.arange(j0, j1)
        txcost = -tightness * (np.log((i - js) / period)) ** 2
        scores = cumscore[js] + txcost
        best = int(np.argmax(scores))
        if scores[best] > 0:
            cumscore[i] = env_n[i] + scores[best]
            backlink[i] = js[best]

    # backtrace from the best-scoring frame in the final period
    tail = np.arange(max(0, n - int(round(period))), n)
    beats = [int(tail[np.argmax(cumscore[tail])])]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1])
    if len(beats) >= 4:
        # refine the autocorrelation tempo with the tracked beat grid
        tempo = float(60.0 * sr / (hop * np.median(np.diff(beats))))
    if units == "time":
        return tempo, beats * hop / sr
    return tempo, beats


def chroma_stft(y: np.ndarray, sr: int, n_fft: int = 4096, hop: int = 1024,
                n_chroma: int = 12, tuning_a: float = 440.0) -> np.ndarray:
    """(12, frames) pitch-class energy (chroma) from STFT magnitudes."""
    if y.ndim == 2:
        y = y.mean(axis=0)
    mag = _stft_mag(y, n_fft, hop)  # (frames, bins)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    freqs[0] = 1e-6
    # fractional semitone index relative to A440, folded to pitch class
    semis = 12.0 * np.log2(freqs / tuning_a) + 69.0  # MIDI note number
    lowest, highest = 24.0, 108.0  # C1..C8
    weight = ((semis >= lowest) & (semis <= highest)).astype(np.float64)
    cls = np.mod(np.round(semis), n_chroma).astype(int)
    fold = np.zeros((n_chroma, len(freqs)))
    # gaussian window on the distance to the nearest semitone suppresses
    # inter-note leakage
    dist = semis - np.round(semis)
    fold[cls, np.arange(len(freqs))] = weight * np.exp(-0.5 * (dist / 0.35) ** 2)
    chroma = fold @ (mag * mag).T  # energy folding -> (12, frames)
    norm = chroma.max(axis=0, keepdims=True)
    return chroma / np.maximum(norm, 1e-12)
