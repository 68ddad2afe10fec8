"""Model handles (port of ``demucs_tpu/models/registry.py``).

``Model`` pairs a config dataclass with its ``nn.Module`` and exposes the
metadata surface of the reference's models (``sources``, ``samplerate``,
``audio_channels``, ``segment``, ``valid_length``); ``BagOfModels`` is the
weighted ensemble (``demucs/apply.py:29-79``). :data:`FAMILIES` maps each
kind (htdemucs, hdemucs, demucs) to its config and module classes, and
:func:`reconfigured` gives a model under another config (a precision
policy, ``dataclasses.replace`` of its ``cfg`` as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from demucs_tpu_torch.models import demucs as m_d
from demucs_tpu_torch.models import hdemucs as m_h
from demucs_tpu_torch.models import htdemucs as m_ht


# model kind -> (config dataclass, ``nn.Module`` class)
FAMILIES: tp.Dict[str, tp.Tuple[type, type]] = {
    "htdemucs": (m_ht.HTDemucsConfig, m_ht.HTDemucs),
    "hdemucs": (m_h.HDemucsConfig, m_h.HDemucs),
    "demucs": (m_d.DemucsConfig, m_d.Demucs)}


def build_module(kind: str, cfg) -> torch.nn.Module:
    """The module of ``kind`` for ``cfg``, with the constructor's weights."""
    try:
        _, module_cls = FAMILIES[kind]
    except KeyError:
        raise ValueError(f"unknown model kind {kind!r}") from None
    return module_cls(cfg)


@dataclasses.dataclass
class Model:
    kind: str  # "htdemucs" | "hdemucs" | "demucs"
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
        # HTDemucs pads to its config's training length: both change together
        self.cfg = dataclasses.replace(self.cfg, segment=value)
        self.module.cfg = self.cfg

    @property
    def uses_train_segment(self) -> bool:
        return self.kind == "htdemucs" and getattr(self.cfg, "use_train_segment", False)

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def to(self, device) -> "Model":
        self.module.to(device)
        return self

    def valid_length(self, length: int) -> int:
        """Leaf padding target (apply.py:302-309 dispatch): Demucs v2 pads to
        its ``valid_length``, HDemucs runs the natural length."""
        if self.kind == "demucs":
            return m_d.valid_length(self.cfg, length)
        if self.kind != "htdemucs":
            return length
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


def reconfigured(model: Model, **changes) -> Model:
    """``model`` with ``dataclasses.replace(model.cfg, **changes)``: a new
    module built for the new config (so a bf16 stage holds its parameters in
    bf16, converted once here) with ``model``'s weights, on its device and in
    its mode. ``model`` itself is left as it was."""
    cfg = dataclasses.replace(model.cfg, **changes)
    module = build_module(model.kind, cfg)
    module.load_state_dict(model.module.state_dict())
    module.to(model.device).train(model.module.training)
    return Model(model.kind, cfg, module)


class BagOfModels:
    """Weighted ensemble (apply.py:29-79)."""

    def __init__(self, models: tp.Sequence[Model],
                 weights: tp.Optional[tp.Sequence[tp.Sequence[float]]] = None,
                 segment: tp.Optional[float] = None):
        """``segment`` (a bag definition's) raises the segment of every member
        that is not HTDemucs to it, never lowers it (apply.py:50-56: the
        reference checks the class, so an HTDemucs keeps its own)."""
        if not models:
            raise ValueError("a bag needs at least one model")
        first = models[0]
        for other in models:
            if (other.sources != first.sources or other.samplerate != first.samplerate
                    or other.audio_channels != first.audio_channels):
                raise ValueError("bag members must share sources, samplerate and channels")
            if segment is not None and other.kind != "htdemucs" and segment > other.segment:
                other.segment = segment
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

    @property
    def max_allowed_segment(self) -> float:
        """The longest segment every member takes: the least HTDemucs segment."""
        segments = [m.segment for m in self.models if m.kind == "htdemucs"]
        return float(min(segments, default=float("inf")))

    def to(self, device) -> "BagOfModels":
        for model in self.models:
            model.to(device)
        return self


AnyModel = tp.Union[Model, BagOfModels]
