"""High-level separation API (port of ``demucs_tpu/api.py``; behavioral
reference ``demucs/api.py``).

``Separator`` holds a model on one device and the separation parameters;
audio is numpy on the host, the model runs on the device through the host
engine. The callback protocol and the ``NotProvided`` update sentinel match
the reference.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

from demucs_tpu_torch import resolve_device
from demucs_tpu_torch.audio import read_audio
from demucs_tpu_torch.inference.apply import apply_model
from demucs_tpu_torch.zoo.native import get_model

__all__ = ["Separator", "LoadAudioError", "LoadModelError", "NotProvided"]


class LoadAudioError(Exception):
    pass


class LoadModelError(Exception):
    pass


class _NotProvided:
    pass


NotProvided = _NotProvided()


class Separator:
    def __init__(
        self,
        model: str = "htdemucs",
        repo: tp.Optional[Path] = None,
        device: str = "cuda",
        shifts: int = 1,
        overlap: float = 0.25,
        split: bool = True,
        segment: tp.Optional[float] = None,
        jobs: int = 0,
        progress: bool = False,
        callback: tp.Optional[tp.Callable[[dict], None]] = None,
        callback_arg: tp.Optional[dict] = None,
        batch_size: int = 16,
    ):
        """Load ``<repo>/<model>.dmx`` onto ``device`` and hold the separation
        parameters (``demucs/api.py:53-122``).

        ``device`` is ``"cuda"`` (default; raises without a card) or
        ``"cpu"``. ``jobs`` is accepted for compatibility: segments run in
        batches of ``batch_size`` instead.
        """
        self._name = model
        self._repo = repo
        self._device = resolve_device(device)  # raises before any loading
        try:
            self._model = get_model(model, repo, device=self._device)
        except (OSError, ValueError, RuntimeError) as err:
            raise LoadModelError(f"Failed to load model {model!r}: {err}") from err
        self._audio_channels = self._model.audio_channels
        self._samplerate = self._model.samplerate
        self.update_parameter(shifts=shifts, overlap=overlap, split=split, segment=segment,
                              jobs=jobs, progress=progress, callback=callback,
                              callback_arg=callback_arg, batch_size=batch_size)

    def update_parameter(self, shifts=NotProvided, overlap=NotProvided, split=NotProvided,
                         segment=NotProvided, jobs=NotProvided, progress=NotProvided,
                         callback=NotProvided, callback_arg=NotProvided,
                         batch_size=NotProvided):
        """Update separation parameters (``demucs/api.py:124-201``)."""
        for name, value in dict(shifts=shifts, overlap=overlap, split=split,
                                segment=segment, jobs=jobs, progress=progress,
                                callback=callback, callback_arg=callback_arg,
                                batch_size=batch_size).items():
            if not isinstance(value, _NotProvided):
                setattr(self, f"_{name}", value)

    def _load_audio(self, track: Path) -> np.ndarray:
        try:
            wav, _sr = read_audio(track, samplerate=self._samplerate,
                                  channels=self._audio_channels)
        except (RuntimeError, OSError, ValueError) as err:
            raise LoadAudioError(f"Could not load file {track}: {err}") from err
        return wav

    def separate_tensor(self, wav: np.ndarray, sr: tp.Optional[int] = None
                        ) -> tp.Tuple[np.ndarray, tp.Dict[str, np.ndarray]]:
        """Separate a loaded ``(C, T)`` float32 array (``demucs/api.py:241-291``).

        Returns ``(original, {stem: (C, T) array})``. The mixture is
        normalized by the mean and std of its mono downmix before separation
        and the stems are scaled back.
        """
        wav = np.asarray(wav, dtype=np.float32)
        if sr is not None and sr != self._samplerate:
            raise ValueError(f"audio at {sr} Hz, model at {self._samplerate} Hz: "
                             "resampling is not ported yet")
        ref = wav.mean(axis=0)
        mean, std = ref.mean(), ref.std()
        wav = (wav - mean) / (std + 1e-8)
        callback_arg = dict(self._callback_arg or {})
        callback_arg["audio_length"] = wav.shape[1]
        out = apply_model(self._model, wav[None], segment=self._segment, shifts=self._shifts,
                          split=self._split, overlap=self._overlap, callback=self._callback,
                          callback_arg=callback_arg, progress=self._progress,
                          batch_size=self._batch_size)
        out = out * (std + 1e-8) + mean
        wav = wav * (std + 1e-8) + mean
        return wav, dict(zip(self._model.sources, out[0]))

    def separate_audio_file(self, file: Path):
        """Read and separate a file -> ``(origin, {stem: wav})`` (api.py:293-307)."""
        return self.separate_tensor(self._load_audio(file), self._samplerate)

    @property
    def samplerate(self):
        return self._samplerate

    @property
    def audio_channels(self):
        return self._audio_channels

    @property
    def model(self):
        return self._model
