"""Streaming separation (port of ``demucs_tpu/inference/streaming.py``): feed
audio in chunks of any size, get the stems back as they become final.

The same segment grid, triangular transition weights and centered padding as
``apply_model(split=True, shifts=0)``, evaluated incrementally: a sample is
emitted once every segment that overlaps it has run, so the concatenated
stream equals the offline output, with a worst-case latency of one segment
plus one stride of audio (plus Demucs v2's lookahead).

    stream = StreamSeparator(model)            # the model's segment by default
    for block in source():                     # any chunk sizes, (C, n)
        stems = stream.feed(block)             # (S, C, n_ready) as available
    stems_tail = stream.flush()

On the card every full segment has one shape and replays one CUDA graph
from ``engine.GRAPHS``, the counterpart of the executable JAX's ``jit``
caches for that shape; the short tail segments of ``flush`` run eagerly at
their own length. Memory is O(segment), whatever the stream's length.
"""

from __future__ import annotations

import typing as tp

import numpy as np

from demucs_tpu_torch.inference.apply import Chunk, _run_batched, _triangle_weight
from demucs_tpu_torch.inference.engine import _forward
from demucs_tpu_torch.models.registry import Model

__all__ = ["StreamSeparator"]


class StreamSeparator:
    """Incremental overlap-add separation for a single :class:`Model`.

    Bags and the random-shift trick need the whole track; use ``apply_model``
    for those. Input and output normalization is the caller's, as for
    ``apply_model``. ``graph_segments`` and ``eager_segments`` count the
    segments run each way.
    """

    def __init__(self, model: Model, segment: tp.Optional[float] = None,
                 overlap: float = 0.25, transition_power: float = 1.0):
        if not isinstance(model, Model):
            raise TypeError("streaming supports single models, not bags")
        self.model = model
        self._segment = segment
        segment_f = model.segment if segment is None else segment
        if not segment_f > 0.0:
            raise ValueError(f"segment must be positive, got {segment_f}")
        self.segment_length = int(model.samplerate * segment_f)
        self.stride = int((1 - overlap) * self.segment_length)
        if self.stride <= 0:
            raise ValueError(f"overlap {overlap} leaves no stride")
        self._weight = _triangle_weight(self.segment_length, transition_power)
        self._n_sources = len(model.sources)
        # Kinds whose leaf target exceeds the segment (Demucs v2's valid_length)
        # center-pad with REAL future samples: a full segment can run only once
        # that lookahead is buffered.
        target_full = model.leaf_target(self.segment_length, segment)
        delta_full = target_full - self.segment_length
        self._ahead = delta_full - delta_full // 2
        self._lookback = max(self.segment_length, target_full)

        # absolute positions: [_base, _fed) is buffered mix; [_emitted, ...)
        # accumulates output that is not final yet
        self._mix = np.zeros((1, model.audio_channels, 0), np.float32)
        self._base = 0
        self._fed = 0
        self._next_offset = 0
        self._emitted = 0
        self._acc = np.zeros((self._n_sources, model.audio_channels, 0), np.float32)
        self._wsum = np.zeros((0,), np.float32)
        self._closed = False
        self.graph_segments = 0
        self.eager_segments = 0

    @property
    def latency_samples(self) -> int:
        """Worst-case samples buffered before a sample becomes final."""
        return self.segment_length + self.stride + self._ahead

    # ------------------------------------------------------------- internals

    def _grow_acc(self, upto: int) -> None:
        cur = self._emitted + self._acc.shape[-1]
        if upto > cur:
            pad = upto - cur
            self._acc = np.pad(self._acc, [(0, 0), (0, 0), (0, pad)])
            self._wsum = np.pad(self._wsum, [(0, pad)])

    def _process_segment(self, offset: int, length: int) -> None:
        """Run one segment (absolute ``offset``, ``length`` real samples): a
        full one through the graph cache, a shorter one eagerly."""
        local = Chunk(self._mix, offset - self._base, length)
        target = self.model.leaf_target(local.length, self._segment)
        if local.length == self.segment_length:
            [out] = _run_batched(self.model, [local], target, 1, forward=_forward)
            self.graph_segments += 1
        else:
            [out] = _run_batched(self.model, [local], target, 1)
            self.eager_segments += 1
        out = out[0]  # (S, C, length)
        self._grow_acc(offset + local.length)
        sl = slice(offset - self._emitted, offset - self._emitted + local.length)
        self._acc[..., sl] += self._weight[:local.length] * out
        self._wsum[sl] += self._weight[:local.length]

    def _emit_upto(self, upto: int) -> np.ndarray:
        upto = min(upto, self._emitted + self._acc.shape[-1])
        n = upto - self._emitted
        if n <= 0:
            return np.zeros((self._n_sources, self.model.audio_channels, 0), np.float32)
        w = self._wsum[:n]
        if not w.min() > 0:
            raise AssertionError("emitting samples with incomplete coverage")
        out = self._acc[..., :n] / w
        self._acc = self._acc[..., n:]
        self._wsum = self._wsum[n:]
        self._emitted = upto
        # drop mix samples no longer needed: the next segment's centered
        # padding can reach back up to its leaf target before next_offset
        keep_from = max(self._base, self._next_offset - self._lookback)
        if keep_from > self._base:
            self._mix = self._mix[..., keep_from - self._base:]
            self._base = keep_from
        return out

    # --------------------------------------------------------------- surface

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Append ``(C, n)`` samples; return every newly final sample of the
        stems, ``(S, C, m)`` (m may be 0)."""
        if self._closed:
            raise RuntimeError("stream already flushed")
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[0] != self.model.audio_channels:
            raise ValueError(f"feed expects ({self.model.audio_channels}, n) samples, "
                             f"got {chunk.shape}")
        self._mix = np.concatenate([self._mix, chunk[None]], axis=-1)
        self._fed += chunk.shape[-1]
        while self._next_offset + self.segment_length + self._ahead <= self._fed:
            self._process_segment(self._next_offset, self.segment_length)
            self._next_offset += self.stride
        # a sample t is final once every overlapping offset (<= t) is done
        return self._emit_upto(min(self._next_offset, self._fed))

    def flush(self) -> np.ndarray:
        """End of stream: run the remaining (short) tail segments and return
        the rest of the stems."""
        if self._closed:
            raise RuntimeError("stream already flushed")
        self._closed = True
        while self._next_offset < self._fed:
            self._process_segment(self._next_offset,
                                  min(self.segment_length, self._fed - self._next_offset))
            self._next_offset += self.stride
        return self._emit_upto(self._fed)
