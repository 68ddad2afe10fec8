"""High-level separation API (port of ``demucs_tpu/api.py``; behavioral
reference ``demucs/api.py``).

``Separator`` holds a model on one device and the separation parameters;
audio is numpy on the host. On the card a track goes through the
device-resident engine by default (``engine="auto"``, as in the JAX
package), on the CPU through the host engine. The callback protocol and the
``NotProvided`` update sentinel match the reference.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

from demucs_tpu_torch import resolve_device
from demucs_tpu_torch.audio import convert_audio, read_audio
from demucs_tpu_torch.inference.apply import apply_model, apply_model_tracks
from demucs_tpu_torch.models.registry import AnyModel, BagOfModels, Model, reconfigured
from demucs_tpu_torch.zoo.pretrained import get_model, list_models

__all__ = ["Separator", "LoadAudioError", "LoadModelError", "NotProvided", "list_models"]


class LoadAudioError(Exception):
    pass


class LoadModelError(Exception):
    pass


class _NotProvided:
    pass


NotProvided = _NotProvided()


def _apply_precision(model: AnyModel, compute_dtype: tp.Optional[str],
                     matmul_precision: tp.Optional[str] = None) -> AnyModel:
    """A loaded model (or bag) under a precision policy (the presets,
    ``presets.py``): each member re-configured by :func:`reconfigured`.

    ``matmul_precision`` applies to every family; ``compute_dtype`` (the bf16
    storage of the fast preset) exists only on HTDemucs: a loud warning says
    so where it cannot take effect, so the preset banner's contract is never
    silently wrong for a family."""
    import warnings

    def one(m: Model) -> Model:
        delta = {}
        if compute_dtype:
            if hasattr(m.cfg, "compute_dtype"):
                if m.cfg.compute_dtype != compute_dtype:
                    delta["compute_dtype"] = compute_dtype
            else:
                warnings.warn(
                    f"compute_dtype={compute_dtype!r} has no effect on {m.kind!r} models "
                    "(only HTDemucs has the bf16-storage knob); this member keeps its "
                    "default numerics", stacklevel=3)
        if matmul_precision:
            if hasattr(m.cfg, "matmul_precision"):
                if m.cfg.matmul_precision != matmul_precision:
                    delta["matmul_precision"] = matmul_precision
            else:
                warnings.warn(
                    f"matmul_precision={matmul_precision!r} has no effect on {m.kind!r} "
                    "models; this member keeps its default numerics", stacklevel=3)
        return reconfigured(m, **delta) if delta else m

    if isinstance(model, BagOfModels):
        # the members' segments are already the bag's: no segment override here
        return BagOfModels([one(m) for m in model.models], model.weights)
    return one(model)


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
        engine: str = "auto",
        transfer_dtype: tp.Optional[str] = None,
        length_bucket_seconds: tp.Optional[float] = None,
        tail_mode: str = "exact",
        compute_dtype: tp.Optional[str] = None,
        matmul_precision: tp.Optional[str] = None,
        shift_offsets: tp.Optional[tp.Sequence[int]] = None,
    ):
        """Load the model or bag ``model`` onto ``device`` and hold the
        separation parameters (``demucs/api.py:53-122``). ``model`` is a bag
        name or a signature in the folder ``repo`` (``.th``, ``.dmx``, bag
        ``.yaml``), or in the released registry without one, or
        ``demucs_unittest`` (``zoo/pretrained.py``).

        ``device`` is ``"cuda"`` (default; raises without a card) or
        ``"cpu"``. ``jobs`` is accepted for compatibility: segments run in
        batches of ``batch_size`` instead. ``engine``, ``transfer_dtype``,
        ``length_bucket_seconds``, ``tail_mode`` and ``shift_offsets`` (a
        pinned set of shift offsets, consumed in order) are ``apply_model``'s;
        the default wire (None) is bit-exact. ``compute_dtype`` and
        ``matmul_precision`` re-configure the loaded model's precision policy
        (the presets, ``presets.py``; ``models/htdemucs.py::precision_scope``).
        """
        self._name = model
        self._repo = repo
        self._device = resolve_device(device)  # raises before any loading
        try:
            self._model = get_model(model, repo, device=self._device)
        except (OSError, ValueError, RuntimeError) as err:
            raise LoadModelError(f"Failed to load model {model!r}: {err}") from err
        if compute_dtype or matmul_precision:
            self._model = _apply_precision(self._model, compute_dtype, matmul_precision)
        self._audio_channels = self._model.audio_channels
        self._samplerate = self._model.samplerate
        self.update_parameter(shifts=shifts, overlap=overlap, split=split, segment=segment,
                              jobs=jobs, progress=progress, callback=callback,
                              callback_arg=callback_arg, batch_size=batch_size, engine=engine,
                              transfer_dtype=transfer_dtype,
                              length_bucket_seconds=length_bucket_seconds,
                              tail_mode=tail_mode, shift_offsets=shift_offsets)

    def update_parameter(self, shifts=NotProvided, overlap=NotProvided, split=NotProvided,
                         segment=NotProvided, jobs=NotProvided, progress=NotProvided,
                         callback=NotProvided, callback_arg=NotProvided,
                         batch_size=NotProvided, engine=NotProvided,
                         transfer_dtype=NotProvided, length_bucket_seconds=NotProvided,
                         tail_mode=NotProvided, shift_offsets=NotProvided):
        """Update separation parameters (``demucs/api.py:124-201``)."""
        if shift_offsets is not None and not isinstance(shift_offsets, _NotProvided):
            shift_offsets = tuple(int(o) for o in shift_offsets)
        for name, value in dict(shifts=shifts, overlap=overlap, split=split,
                                segment=segment, jobs=jobs, progress=progress,
                                callback=callback, callback_arg=callback_arg,
                                batch_size=batch_size, engine=engine,
                                transfer_dtype=transfer_dtype,
                                length_bucket_seconds=length_bucket_seconds,
                                tail_mode=tail_mode, shift_offsets=shift_offsets).items():
            if not isinstance(value, _NotProvided):
                setattr(self, f"_{name}", value)

    def _engine_kwargs(self) -> dict:
        return dict(segment=self._segment, shifts=self._shifts, split=self._split,
                    overlap=self._overlap, progress=self._progress,
                    batch_size=self._batch_size, engine=self._engine,
                    transfer_dtype=self._transfer_dtype,
                    length_bucket_seconds=self._length_bucket_seconds,
                    tail_mode=self._tail_mode, shift_offsets=self._shift_offsets)

    def _normalized(self, wav: np.ndarray) -> tp.Tuple[np.ndarray, float, float]:
        """The mixture normalized by the mean and std of its mono downmix."""
        ref = wav.mean(axis=0)
        mean, std = ref.mean(), ref.std()
        return (wav - mean) / (std + 1e-8), mean, std

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

        Returns ``(original, {stem: (C, T) array})``. Audio at another rate
        ``sr`` is converted to the model's rate and channels first (so are
        the original and the stems). The mixture is normalized by the mean
        and std of its mono downmix before separation and the stems are
        scaled back.
        """
        wav = np.asarray(wav, dtype=np.float32)
        if sr is not None and sr != self._samplerate:
            wav = convert_audio(wav, sr, self._samplerate, self._audio_channels)
        wav, mean, std = self._normalized(wav)
        callback_arg = dict(self._callback_arg or {})
        callback_arg["audio_length"] = wav.shape[1]
        out = apply_model(self._model, wav[None], callback=self._callback,
                          callback_arg=callback_arg, **self._engine_kwargs())
        out = out * (std + 1e-8) + mean
        wav = wav * (std + 1e-8) + mean
        return wav, dict(zip(self._model.sources, out[0]))

    def separate_audio_file(self, file: Path):
        """Read and separate a file -> ``(origin, {stem: wav})`` (api.py:293-307)."""
        return self.separate_tensor(self._load_audio(file), self._samplerate)

    def separate_audio_files(self, files: tp.Iterable[Path]):
        """Separate files one after the other, yielding ``(file, origin, {stem:
        wav})`` per file, in order, with the results of ``separate_audio_file``.

        On the device engine each track's copy of its stems to the host (and
        the next file's decoding) overlaps the next track's compute
        (``apply_model_tracks``). Per-chunk callbacks are not called here: with
        a callback set this raises. A file that fails to load stops the
        pipeline; the tracks already queued are yielded first, then the error
        is raised.
        """
        if self._callback is not None:
            raise ValueError("separate_audio_files calls no per-chunk callback: use "
                             "separate_audio_file, or update_parameter(callback=None)")
        meta: tp.List[tp.Optional[tuple]] = []
        load_error: tp.List[LoadAudioError] = []

        def mixes():
            for file in files:
                try:
                    wav = self._load_audio(file)
                except LoadAudioError as err:
                    load_error.append(err)
                    return
                norm, mean, std = self._normalized(wav)
                meta.append((file, norm, mean, std))
                yield norm[None]

        for i, out in enumerate(apply_model_tracks(self._model, mixes(),
                                                   **self._engine_kwargs())):
            file, norm, mean, std = meta[i]
            meta[i] = None  # release the decoded waveform
            out = out * (std + 1e-8) + mean
            yield file, norm * (std + 1e-8) + mean, dict(zip(self._model.sources, out[0]))
        if load_error:
            raise load_error[0]

    def prewarm(self, durations, verbose: bool = False) -> tp.List[dict]:
        """Run every shape this Separator's configuration needs for tracks of
        the given duration(s) once, before traffic: on the card every CUDA
        graph of the full windows is captured and, with ``shift_offsets``
        pinned, every exact-tail shape runs (``inference/prewarm.py``).
        Returns the per-duration report of ``prewarm.prewarm``
        (``tails_warmed=False`` flags random shifts on exact-tail kinds)."""
        from demucs_tpu_torch.inference.prewarm import prewarm

        return prewarm(self._model, durations, shifts=self._shifts,
                       shift_offsets=self._shift_offsets, overlap=self._overlap,
                       segment=self._segment, batch_size=self._batch_size, engine=self._engine,
                       transfer_dtype=self._transfer_dtype,
                       length_bucket_seconds=self._length_bucket_seconds,
                       tail_mode=self._tail_mode, verbose=verbose)

    @property
    def samplerate(self):
        return self._samplerate

    @property
    def audio_channels(self):
        return self._audio_channels

    @property
    def model(self):
        return self._model
