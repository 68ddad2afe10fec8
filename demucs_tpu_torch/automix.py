"""Automix: synthetic training songs from the stems of different songs.

The reference's ``tools/automix.py`` heuristics: beat-track every song's
drums; histogram the bass line's chroma; a donor must sit within 15 % of the
tempo at some power-of-two metrical level and within 3 semitones; the
borrowed stem is repitched and retempoed; first beats are aligned on a 5 ms
gaussian onset grid. On the port's host stack: librosa's tracker and chroma
when installed, else ``ops/beats.py``; ``train/repitch.py`` (soundstretch
when installed, else the WSOLA time-stretch); ``train/wav.py``'s Wavset for
the stems; the aligner's shift search as one cross-correlation per stem.
Everything runs on the host (numpy), no card needed.

Usage:
    python -m demucs_tpu_torch.automix --musdb /path/to/musdbhq --out /path/to/automix
"""

import argparse
import dataclasses
import hashlib
import multiprocessing
import pickle
import random
import shutil
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from demucs_tpu_torch.audio import save_audio
from demucs_tpu_torch.train.repitch import repitch
from demucs_tpu_torch.train.wav import MUSDB_VALID_TRACKS, Wavset, build_metadata
from demucs_tpu_torch.zoo.pretrained import SOURCES

CHANNELS = 2
SR = 44100
PITCH_WINDOW = 3        # semitones a borrowed stem may be shifted
TEMPO_WINDOW = 0.15     # relative tempo mismatch allowed after rescaling
METRICAL_LEVELS = (0.25, 0.5, 1.0, 2.0, 4.0)  # half/double-time equivalences
GRID_MS = 5e-3          # onset-grid resolution for beat alignment
SILENCE_REL = 1e-2      # "stem is present" threshold vs mixture level


@dataclasses.dataclass
class TrackAnalysis:
    """Cached per-song analysis the matcher works on."""
    tempo: float                 # BPM from the drum stem
    beats: np.ndarray            # beat times (s)
    chroma_hist: np.ndarray      # (12, 1) bass pitch-class histogram
    stems: np.ndarray            # (S, C, T) leading silence trimmed
    index: int

    def with_(self, **kw) -> "TrackAnalysis":
        return dataclasses.replace(self, **kw)


def sliding_rms(x: np.ndarray, window: int = 10000) -> np.ndarray:
    """Centered windowed RMS per sample (cumsum-of-squares formulation)."""
    half = window // 2
    window = 2 * half + 1
    sq = np.cumsum(np.pad(x, (half, half)) ** 2, axis=-1)
    return np.sqrt((sq[..., window - 1:] - sq[..., :1 - window]) / window)


def _beat_and_chroma_backends():
    """(beat_track, chroma) callables — librosa when installed, else the
    first-party trackers."""
    try:
        from librosa.beat import beat_track
        from librosa.feature import chroma_cqt

        return (lambda y: beat_track(y=y, units="time", sr=SR),
                lambda y: chroma_cqt(y=y, sr=SR))
    except ImportError:
        from demucs_tpu_torch.ops.beats import beat_track, chroma_stft

        return (lambda y: beat_track(y, SR, units="time"),
                lambda y: chroma_stft(y, SR))


def analyse_track(dset, index, cache_dir: Path):
    """-> (TrackAnalysis, None) or (None, trimmed stems) when the song has
    no usable drum or bass line (it can still donate its other stems)."""
    stems = dset[index]
    mono_mix = stems.sum(0).mean(0)
    level = mono_mix.std()
    first_audible = int(np.argmax(np.abs(mono_mix) >= SILENCE_REL * level))
    stems = stems[..., first_audible:]

    cache = cache_dir / dset.sig
    cache.mkdir(exist_ok=True, parents=True)
    entry = cache / f"{index}.pkl"
    if entry.exists():
        tempo, beats, hist = pickle.load(open(entry, "rb"))
    else:
        beat_track, chroma = _beat_and_chroma_backends()
        drums = stems[0].mean(0)
        if drums.std() <= SILENCE_REL * level:
            return None, stems
        tempo, beats = beat_track(drums)

        bass = stems[1].mean(0)
        loudness = sliding_rms(bass)
        bass = bass[loudness >= 0.05 * loudness.max()]
        if bass.std() <= SILENCE_REL * level:
            return None, stems
        ch = chroma(bass)
        # histogram of per-frame winning pitch classes, (12, 1) as
        # best_pitch_shift compares them (the tool's (12,) hist fails there)
        hist = (ch == ch.max(axis=0, keepdims=True)).astype(np.float32).mean(1, keepdims=True)
        pickle.dump([tempo, beats, hist], open(entry, "wb"))
    return TrackAnalysis(float(np.atleast_1d(tempo)[0]), beats, hist,
                         stems, index), None


def best_pitch_shift(hist_ref: np.ndarray, hist_other: np.ndarray) -> int:
    """Circular chroma alignment in [-5, 6] semitones (vectorized over the
    12 rotations)."""
    rolls = np.stack([np.roll(hist_other, r, axis=0) for r in range(12)])
    shift = int(np.abs(hist_ref[None] - rolls).mean(axis=(1, 2)).argmin())
    return shift - 12 if shift > 6 else shift


def _onset_grid(n_samples: int, onsets: np.ndarray) -> np.ndarray:
    """Gaussian bumps on a GRID_MS lattice at each onset (edges excluded)."""
    half = 5
    x = np.arange(-half, half + 1, dtype=np.float64)
    bump = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
    grid = np.zeros(int(n_samples / GRID_MS / SR))
    duration = n_samples / SR
    for t in np.atleast_1d(onsets):
        if not 1 <= t < duration - 1:
            continue
        pos = int(t / GRID_MS)
        span = grid[pos - half: pos + half + 1]
        span += bump[: len(span)]
    return grid


def align_stems(stems):
    """Shift every stem so its onset grid best matches stem 0's, then
    left-pad to a common origin and crop to the shortest.

    Scoring law mirrors the reference exactly, including its negative-lag
    quirk: lag >= 0 scores the true correlation sum ref[i]*other[i+lag]
    (computed here with one ``np.correlate``); lag < 0 scores the LAST
    ``|lag|`` grid cells of the reference grid against the FIRST ``|lag|``
    of the other (``grid[lag:]`` tail-slicing in the original — kept so the
    generated datasets match). Ties resolve toward the largest lag (the
    lexicographic (score, lag) max)."""
    grids = [_onset_grid(wav.shape[-1], onsets) for wav, onsets in stems]
    max_lag = int(4 / GRID_MS)

    shifts = [0]
    ref_grid = grids[0]
    for g in grids[1:]:
        n = max(len(ref_grid), len(g))
        a = np.pad(ref_grid, (0, n - len(ref_grid)))
        b = np.pad(g, (0, n - len(g)))
        full = np.correlate(b, a, mode="full")  # index n-1 <-> lag 0
        # `full` has 2n-1 entries (lags -(n-1)..n-1): clamp the scored lag
        # range to n so short (<4 s) grids cannot index past the end.
        pos_lags = np.arange(0, min(max_lag, n))
        # Lag cells -> sample shifts with the reference's exact conversion
        # int(lag * 0.005 * 44100) (automix.py:156) — truncating the
        # *product*, not the per-cell width (220.5 -> 220 would drift ~1
        # sample per 2 cells).
        cand = list(zip(full[pos_lags + n - 1],
                        (pos_lags * GRID_MS * SR).astype(int)))
        for lag in range(-max_lag, 0):
            tail = ref_grid[lag:]
            k = min(len(g), len(tail))
            cand.append((float(tail[:k] @ g[:k]),
                         int(lag * GRID_MS * SR)))
        best = max(cand)[1]
        shifts.append(-best)

    origin = min(shifts)
    padded = [np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(s - origin, 0)])
              for (wav, _), s in zip(stems, shifts)]
    shortest = min(w.shape[-1] for w in padded)
    return np.stack([w[..., :shortest] for w in padded])


def _tempo_fit(ref_tempo: float, tempo: float):
    """Best metrical-level rescaling of ``tempo`` toward ``ref_tempo`` ->
    (rescaled tempo, relative delta) or None outside the window."""
    for level in METRICAL_LEVELS:
        scaled = tempo * level
        delta = ref_tempo / scaled - 1
        if abs(delta) < TEMPO_WINDOW:
            return scaled, delta
    return None


def find_candidate(ref: TrackAnalysis, catalog, pitch_match=True):
    """Random compatible donor: tempo within the window at some metrical
    level, chroma within PITCH_WINDOW semitones (when pitch matching)."""
    pool = list(catalog)
    random.shuffle(pool)
    for cand in pool:
        fit = _tempo_fit(ref.tempo, cand.tempo)
        if fit is None:
            continue
        tempo, delta_tempo = fit
        semitones = 0
        if pitch_match:
            semitones = best_pitch_shift(ref.chroma_hist, cand.chroma_hist)
            if abs(semitones) > PITCH_WINDOW:
                continue
        return cand.with_(tempo=tempo), delta_tempo, semitones
    raise RuntimeError("no candidate found")


def borrow_stem(donor: TrackAnalysis, source: int, delta_tempo: float,
                semitones: int):
    """The donor's stem, retempo'd/repitched into the reference's frame;
    onsets rescaled to the stretched timeline."""
    wav = donor.stems[source]
    if delta_tempo or semitones:
        wav = repitch(wav, semitones, delta_tempo * 100, samplerate=SR,
                      voice=source == 3)
        donor = donor.with_(beats=np.asarray(donor.beats) / (1 + delta_tempo))
    return wav, donor


def build_track(ref_index: int, catalog):
    """One synthetic song: keep a random stem of the reference song, borrow
    every other stem from matched donors, beat-align the set."""
    order = list(range(len(SOURCES)))
    random.shuffle(order)
    parts = [None] * len(order)
    ref = catalog[ref_index]
    parts[order[0]] = (ref.stems[order[0]], ref.beats)
    # kept verbatim from the reference (automix.py:236): a list-vs-int
    # comparison that is always True, so the "skip pitch match on the first
    # borrow" branch below is dead there too — matching datasets matter
    # more than repairing the donor heuristic
    pitch_match = order != 0
    for source in order[1:]:
        donor, delta_tempo, semitones = find_candidate(
            ref, catalog, pitch_match=pitch_match)
        if not pitch_match:
            ref = ref.with_(chroma_hist=donor.chroma_hist)
        pitch_match = True
        wav, donor = borrow_stem(donor, source, delta_tempo, semitones)
        parts[source] = (wav, donor.beats)
    return align_stems(parts)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m demucs_tpu_torch.automix",
        description="Write synthetic training songs from the stems of MusdbHQ's train set.")
    parser.add_argument("--musdb", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--cache", type=Path,
                        default=Path.home() / ".cache/automix")
    parser.add_argument("--copies", type=int, default=6,
                        help="synthetic songs per catalog entry")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    random.seed(4321)
    if args.out.exists():
        shutil.rmtree(args.out)
    out = args.out / "train"
    out.mkdir(parents=True)

    root = args.musdb / "train"
    metadata = build_metadata(root, SOURCES, normalize=False)
    metadata = {n: m for n, m in metadata.items()
                if n not in MUSDB_VALID_TRACKS}
    dset = Wavset(root, metadata, SOURCES, samplerate=SR, channels=CHANNELS,
                  normalize=False)
    dset.sig = hashlib.sha1(str(root).encode()).hexdigest()[:8]

    catalog = []
    # spawned, not forked: the parent may run threads (torch's, a caller's)
    with ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(analyse_track, dset, i, args.cache)
                for i in range(len(dset))]
        for job in jobs:
            analysis, _unusable = job.result()
            if analysis is not None:
                catalog.append(analysis)

    for copy in range(args.copies):
        for index in range(len(catalog)):
            track = build_track(index, catalog)
            mix = track.sum(0)
            scale = max(1, 1.01 * np.abs(mix).max())
            folder = out / f"{copy}_{index}"
            folder.mkdir()
            save_audio(mix / scale, folder / "mixture.wav", SR)
            for stem, source in zip(track / scale, SOURCES):
                save_audio(stem, folder / f"{source}.wav", SR, clip="clamp")


if __name__ == "__main__":
    main()
