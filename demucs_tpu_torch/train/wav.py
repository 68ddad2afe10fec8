"""Wav-folder datasets, MusdbHQ style, on the host (port of
``demucs_tpu/train/wav.py``; behavioral reference ``demucs/wav.py``).

A dataset is a folder of tracks, one folder each of ``{source}.wav`` stems
(and ``mixture.wav``, written as the stems' sum where it is missing); a
metadata cache holds each track's length, rate and mixture mean and std.
Examples are (segment, shift)-strided windows: a WAV window per stem is
read and channel-converted by the C++ reader (``native.read_wav_window``,
``csrc/wavio.cpp``, without the interpreter's lock), only the frames the
file has; then converted in rate, normalized by the track's statistics and
zero-padded past its end (after the normalization, so the padding is true
zeros, as the reference's). Whole files (``segment=None``, ``full_cv``) and
other extensions go through the Python reader (``audio.read_wav``), the C++
reader's plain twin. Loading runs in a thread pool (``distrib.DataLoader``),
and the solver reports the time the step waited for it.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import typing as tp
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from demucs_tpu_torch import audio as ta

__all__ = ["build_metadata", "Wavset", "get_wav_datasets", "get_musdb_wav_datasets",
           "MUSDB_VALID_TRACKS"]

MIXTURE = "mixture"
EXT = ".wav"


def _synth_mixture(track: Path, sources, ext: str) -> None:
    """``mixture.wav`` as the float sum of the stems (wav.py:37-46)."""
    total, sr = None, None
    for source in sources:
        stem, sr = ta.read_wav(track / f"{source}{ext}")
        total = stem if total is None else total + stem
    ta.write_wav(track / f"{MIXTURE}{ext}", total, sr, as_float=True)


def _track_metadata(track: Path, sources, normalize: bool = True, ext: str = EXT) -> dict:
    """A track's entry: frames and rate, the same for every stem (checked),
    and the mono mixture's mean and unbiased std (wav.py:50-75)."""
    out = {"length": None, "samplerate": None, "mean": 0.0, "std": 1.0}
    for source in list(sources) + [MIXTURE]:
        file = track / f"{source}{ext}"
        if source == MIXTURE and not file.exists():
            _synth_mixture(track, sources, ext)
        fmt, _, size = ta._parse_wav_header(file)
        frames, sr = size // fmt[4], fmt[2]  # data bytes / block align, sample rate
        if out["length"] is None:
            out["length"], out["samplerate"] = frames, sr
        elif frames != out["length"]:
            raise ValueError(f"stem length mismatch in {file}: {frames} frames where "
                             f"the track's other stems have {out['length']}")
        elif sr != out["samplerate"]:
            raise ValueError(f"stem sample-rate mismatch in {file}: {sr} where the track's "
                             f"other stems have {out['samplerate']}")
        if source == MIXTURE and normalize:
            mono = ta.read_wav(file)[0].mean(0)
            out["mean"] = float(mono.mean())
            out["std"] = float(mono.std(ddof=1))
    return out


def _leaf_track_dirs(path: Path) -> tp.Iterator[Path]:
    """The track folders: non-hidden leaf folders below ``path`` (wav.py:82-90)."""
    for root, folders, _files in os.walk(path, followlinks=True):
        root = Path(root)
        if root == path or folders or root.name.startswith("."):
            continue
        yield root


def build_metadata(path, sources, normalize: bool = True, ext: str = EXT) -> dict:
    """Scan a dataset folder into the metadata cache (wav.py:78-104), the
    tracks on a thread pool."""
    path = Path(path)
    with ThreadPoolExecutor(8) as pool:
        jobs = [(str(d.relative_to(path)), pool.submit(_track_metadata, d, sources, normalize,
                                                       ext))
                for d in sorted(_leaf_track_dirs(path))]
        return {name: job.result() for name, job in jobs}


class Wavset:
    """Folder-of-stems dataset of strided segment windows (wav.py:107-184):
    item ``i`` is ``(S, C, T)`` float32."""

    def __init__(self, root, metadata, sources, segment=None, shift=None, normalize=True,
                 samplerate=44100, channels=2, ext=EXT):
        self.root = Path(root)
        self.metadata = OrderedDict(metadata)
        self.segment = segment
        self.shift = shift or segment
        self.normalize = normalize
        self.sources = list(sources)
        self.channels = channels
        self.samplerate = samplerate
        self.ext = ext
        # a track shorter than a segment still gives one (padded) example
        self.num_examples = [
            1 if segment is None or m["length"] / m["samplerate"] < segment
            else int(math.ceil((m["length"] / m["samplerate"] - segment) / self.shift) + 1)
            for m in self.metadata.values()]
        self._bounds = np.cumsum([0] + self.num_examples)
        self._names = list(self.metadata)

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def get_file(self, name, source) -> Path:
        return self.root / name / f"{source}{self.ext}"

    def __getitem__(self, index: int) -> np.ndarray:
        if not 0 <= index < len(self):
            raise IndexError(index)
        track = int(np.searchsorted(self._bounds, index, side="right")) - 1
        name = self._names[track]
        meta = self.metadata[name]
        offset, num_frames = 0, None
        if self.segment is not None:
            offset = int(meta["samplerate"] * self.shift * (index - int(self._bounds[track])))
            num_frames = int(math.ceil(meta["samplerate"] * self.segment))
        if num_frames is not None and self.ext == EXT:
            from demucs_tpu_torch import native

            frames = max(0, min(num_frames, int(meta["length"]) - offset))
            wavs = np.empty((len(self.sources), self.channels, frames), np.float32)
            for k, source in enumerate(self.sources):
                native.read_wav_window(self.get_file(name, source), offset, frames,
                                       self.channels, out=wavs[k])
        else:
            wavs = []
            for source in self.sources:
                wav, _ = ta.read_wav(self.get_file(name, source), frame_offset=offset,
                                     num_frames=num_frames)
                wavs.append(ta.convert_audio_channels(wav, self.channels))
        example = ta.resample(np.stack(wavs), meta["samplerate"], self.samplerate)
        if self.normalize:
            example = (example - meta["mean"]) / meta["std"]
        if self.segment:
            length = int(self.segment * self.samplerate)
            example = example[..., :length]
            pad = length - example.shape[-1]
            if pad:
                example = np.pad(example, [(0, 0)] * (example.ndim - 1) + [(0, pad)])
        return example.astype(np.float32)


# The MUSDB18 validation tracks (the musdb package's mus.yaml).
MUSDB_VALID_TRACKS = (
    "Actions - One Minute Smile",
    "Clara Berry And Wooldog - Waltz For My Victims",
    "Johnny Lokke - Promises & Lies",
    "Patrick Talbot - A Reason To Leave",
    "Triviul - Angelsaint",
    "Alexander Ross - Goodbye Bolero",
    "Fergessen - Nos Palpitants",
    "Leaf - Summerghost",
    "Skelpolu - Human Mistakes",
    "Young Griffo - Pennies",
    "ANiMAL - Rockshow",
    "James May - On The Line",
    "Meaxic - Take A Step",
    "Traffic Experiment - Sirens",
)


def _cached(metadata_file: Path, build: tp.Callable):
    """The metadata in ``metadata_file``, built there first when it is missing:
    by rank 0 alone, the other ranks waiting at a barrier (wav.py:213-217)."""
    from demucs_tpu_torch.train import distrib

    if not metadata_file.is_file() and distrib.rank() == 0:
        metadata_file.parent.mkdir(exist_ok=True, parents=True)
        tmp = metadata_file.with_suffix(".tmp")
        tmp.write_text(json.dumps(build()))
        tmp.rename(metadata_file)
    distrib.barrier()
    return json.loads(metadata_file.read_text())


def _valid_set(root: Path, metadata: dict, args) -> Wavset:
    kw_cv = {} if args.full_cv else {"segment": args.segment, "shift": args.shift}
    return Wavset(root, metadata, [MIXTURE] + list(args.sources), samplerate=args.samplerate,
                  channels=args.channels, normalize=args.normalize, **kw_cv)


def _train_set(root: Path, metadata: dict, args) -> Wavset:
    return Wavset(root, metadata, args.sources, segment=args.segment, shift=args.shift,
                  samplerate=args.samplerate, channels=args.channels, normalize=args.normalize)


def get_musdb_wav_datasets(args) -> tp.Tuple[Wavset, Wavset]:
    """MusdbHQ's train and valid split (wav.py:224-254) of ``args`` (the
    ``dset`` section)."""
    sig = hashlib.sha1(str(args.musdb).encode()).hexdigest()[:8]
    root = Path(args.musdb) / "train"
    metadata = _cached(Path(args.metadata) / ("musdb_" + sig + ".json"),
                       lambda: build_metadata(root, args.sources))
    valid_tracks = args.valid_tracks or MUSDB_VALID_TRACKS
    train = metadata if args.train_valid else {
        n: m for n, m in metadata.items() if n not in valid_tracks}
    valid = {n: m for n, m in metadata.items() if n in valid_tracks}
    return _train_set(root, train, args), _valid_set(root, valid, args)


def get_wav_datasets(args, name: str = "wav") -> tp.Tuple[Wavset, Wavset]:
    """A wav folder's ``train/`` and ``valid/`` sets (wav.py:187-213)."""
    path = getattr(args, name)
    sig = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    train_path, valid_path = Path(path) / "train", Path(path) / "valid"
    train, valid = _cached(
        Path(args.metadata) / ("wav_" + sig + ".json"),
        lambda: [build_metadata(train_path, args.sources),
                 build_metadata(valid_path, args.sources)])
    return _train_set(train_path, train, args), _valid_set(valid_path, valid, args)
