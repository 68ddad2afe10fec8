"""Model handles (port of ``demucs_tpu/models/registry.py``).

``Model`` pairs a config dataclass with its ``nn.Module`` and exposes the
metadata surface of the reference's models (``sources``, ``samplerate``,
``audio_channels``, ``segment``, ``valid_length``); ``BagOfModels`` is the
weighted ensemble (``demucs/apply.py:29-79``). Only HTDemucs is ported in
this slice.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch


@dataclasses.dataclass
class Model:
    kind: str  # "htdemucs"
    cfg: tp.Any
    module: torch.nn.Module

    @property
    def sources(self) -> tp.Tuple[str, ...]:
        return tuple(self.cfg.sources)

    @property
    def samplerate(self) -> int:
        return self.cfg.samplerate

    @property
    def audio_channels(self) -> int:
        return self.cfg.audio_channels

    @property
    def segment(self) -> float:
        return float(self.cfg.segment)

    @segment.setter
    def segment(self, value: float) -> None:
        # the module pads to its config's training length: both change together
        self.cfg = dataclasses.replace(self.cfg, segment=value)
        self.module.cfg = self.cfg

    @property
    def uses_train_segment(self) -> bool:
        return self.kind == "htdemucs" and getattr(self.cfg, "use_train_segment", False)

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def valid_length(self, length: int) -> int:
        """Leaf padding target (apply.py:302-309 dispatch)."""
        if self.kind != "htdemucs":
            raise NotImplementedError(f"{self.kind!r} comes with a later slice of the port")
        if self.cfg.use_train_segment:
            training_length = int(self.cfg.segment * self.cfg.samplerate)
            if training_length < length:
                raise ValueError(f"Given length {length} is longer than training length "
                                 f"{training_length}")
            return training_length
        return length

    def leaf_target(self, length: int, segment: tp.Optional[float]) -> int:
        """Leaf padding target given an optional explicit segment (apply.py:303-309):
        an explicit ``segment`` caps the HTDemucs target at ``int(segment *
        samplerate)``, and the forward right-pads itself to the training length."""
        if self.kind == "htdemucs" and segment is not None:
            return int(segment * self.samplerate)
        return self.valid_length(length)


class BagOfModels:
    """Weighted ensemble (apply.py:29-79)."""

    def __init__(self, models: tp.Sequence[Model],
                 weights: tp.Optional[tp.Sequence[tp.Sequence[float]]] = None):
        if not models:
            raise ValueError("a bag needs at least one model")
        first = models[0]
        for other in models:
            if (other.sources != first.sources or other.samplerate != first.samplerate
                    or other.audio_channels != first.audio_channels):
                raise ValueError("bag members must share sources, samplerate and channels")
        self.audio_channels = first.audio_channels
        self.samplerate = first.samplerate
        self.sources = first.sources
        self.models = list(models)
        if weights is None:
            weights = [[1.0] * len(first.sources) for _ in models]
        elif len(weights) != len(models) or any(len(w) != len(first.sources)
                                                for w in weights):
            raise ValueError("bag weights must be one list per model, one weight per source")
        self.weights = [list(w) for w in weights]


AnyModel = tp.Union[Model, BagOfModels]
