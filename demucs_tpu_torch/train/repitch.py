"""The repitch / tempo augment, on the host (port of
``demucs_tpu/train/repitch.py``; behavioral reference ``demucs/repitch.py``).

With probability ``proba`` an item's stems are pitch-shifted by a whole
number of semitones in ``[-max_pitch, max_pitch]`` and sped up or slowed
down by ``N(0, tempo_std)`` percent clamped to ``±max_tempo``; every item is
then cropped to ``(1 - 0.01 max_tempo)`` of its length, so batches keep one
shape. Vocals (``vocals``) go through ``soundstretch -speech``.

Backends: the ``soundstretch`` binary (SoundTouch, as the reference) when it
is installed, else the port's WSOLA (``ops/timestretch.py``) with the same
``-pitch`` / ``-tempo`` parameters (it has no ``-speech`` tuning).

The draws: the JAX package and the reference draw from the global
``random`` module, so under a loader's thread pool an item's draw depends on
the order the threads reach it. Here each item's (fire, pitch, tempo) come
from a ``torch.Generator`` seeded by (seed, epoch, index):
:meth:`RepitchedWrapper.plan` gives the same plan whatever the thread order,
and the tests hand it to the JAX package's :func:`repitch`.
"""

from __future__ import annotations

import shutil
import subprocess as sp
import tempfile
import typing as tp

import numpy as np
import torch

from demucs_tpu_torch import audio as ta

__all__ = ["soundstretch_available", "backend_name", "repitch", "RepitchedWrapper"]


def soundstretch_available() -> bool:
    return shutil.which("soundstretch") is not None


def backend_name(backend: str = "auto") -> str:
    """The backend ``backend`` resolves to: ``soundstretch`` or ``native``."""
    if backend not in ("auto", "soundstretch", "native"):
        raise ValueError(f"unknown repitch backend {backend!r}")
    if backend == "auto":
        return "soundstretch" if soundstretch_available() else "native"
    return backend


def repitch(wav: np.ndarray, pitch: float, tempo: float, voice: bool = False,
            quick: bool = False, samplerate: int = 44100, backend: str = "auto") -> np.ndarray:
    """Repitch ``(C, T)`` float32 audio by ``pitch`` semitones and ``tempo``
    percent (repitch.py:59-86): output length ``T / (1 + tempo/100)``."""
    backend = backend_name(backend)
    if backend == "native":
        from demucs_tpu_torch.ops.timestretch import repitch_native

        return repitch_native(wav, pitch, tempo, samplerate=samplerate)
    if not soundstretch_available():
        raise RuntimeError("soundstretch binary is not installed")
    with tempfile.NamedTemporaryFile(suffix=".wav") as infile, \
            tempfile.NamedTemporaryFile(suffix=".wav") as outfile:
        ta.write_wav(infile.name, wav, samplerate, bits_per_sample=16)
        command = ["soundstretch", infile.name, outfile.name, f"-pitch={pitch}",
                   f"-tempo={tempo:.6f}"]
        if quick:
            command += ["-quick"]
        if voice:
            command += ["-speech"]
        try:
            sp.run(command, capture_output=True, check=True)
        except sp.CalledProcessError as error:
            raise RuntimeError(f"Could not change bpm because {error.stderr.decode('utf-8')}")
        out, sr = ta.read_wav(outfile.name)
    if sr != samplerate:
        raise RuntimeError(f"soundstretch wrote {sr} Hz for a {samplerate} Hz input")
    return out


class RepitchedWrapper:
    """A dataset whose items are repitched at random (repitch.py:18-56).
    ``set_epoch`` (called by ``distrib.DataLoader.set_epoch``) moves to the
    next epoch's draws."""

    def __init__(self, dataset, proba: float = 0.2, max_pitch: int = 2, max_tempo: float = 12,
                 tempo_std: float = 5, vocals: tp.Sequence[int] = (3,), same: bool = True,
                 samplerate: int = 44100, seed: int = 0):
        self.dataset = dataset
        self.proba = proba
        self.max_pitch = max_pitch
        self.max_tempo = max_tempo
        self.tempo_std = tempo_std
        self.same = same
        self.vocals = list(vocals)
        self.samplerate = samplerate
        self.seed = seed
        self.backend = backend_name()  # resolved once: the run names what it used
        self.epoch = 0

    def __len__(self):
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def plan(self, index: int, streams: int) -> tp.Optional[tp.List[tp.Tuple[int, float]]]:
        """Item ``index``'s draw this epoch: None (not repitched) or one
        ``(semitones, tempo percent)`` per stream (all equal with ``same``)."""
        seed = np.random.SeedSequence([self.seed, self.epoch, index]).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(seed))
        if float(torch.rand((), generator=gen, dtype=torch.float64)) >= self.proba:
            return None
        out = []
        for idx in range(streams):
            if idx == 0 or not self.same:  # same=False redraws per source (repitch.py:42-45)
                pitch = int(torch.randint(-self.max_pitch, self.max_pitch + 1, (),
                                          generator=gen))
                tempo = float(torch.randn((), generator=gen, dtype=torch.float64)) * self.tempo_std
                tempo = min(max(-self.max_tempo, tempo), self.max_tempo)
            out.append((pitch, tempo))
        return out

    def __getitem__(self, index):
        streams = self.dataset[index]
        out_length = int((1 - 0.01 * self.max_tempo) * streams.shape[-1])
        plan = self.plan(index, len(streams))
        if plan is None:
            return streams[..., :out_length]
        return np.stack([
            repitch(stream, pitch, tempo, voice=idx in self.vocals, samplerate=self.samplerate,
                    backend=self.backend)[:, :out_length]
            for idx, (stream, (pitch, tempo)) in enumerate(zip(streams, plan))])
