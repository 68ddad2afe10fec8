"""Serving warm path: pinned shift-offset sets and prewarming
(port of ``demucs_tpu/inference/prewarm.py``).

The shift trick draws ``offset = randint(0, max_shift)`` per pass
(``demucs/apply.py:237-256``). For the kinds whose leaf target depends on
the chunk length (Demucs v2, HDemucs, HTDemucs without its training
segment) each ragged tail chunk then has a length of its own: on the card
an eager forward at a shape cuDNN has not seen, whose first call pays its
set-up (HDemucs's one-tail 30 s request took 0.214-0.377 s for the same
forward, PERF.md).

- :class:`PinnedShifts` / the ``shift_offsets`` parameter of ``apply_model``,
  ``apply_model_tracks`` and ``Separator``: a fixed offset set consumed in
  order instead of random draws. A pinned offset is just one draw: the
  engines run the reference's exact tails for it.
- :func:`prewarm`: a silent track of each expected length through the
  configured engine, consuming EVERY pinned offset, so that every CUDA graph
  of the full windows is captured and every exact-tail shape has run once
  before traffic.

With K pinned offsets the tail shapes are at most K * ceil(segment_length /
stride) per model and track length: bounded, where random shifts leave them
unbounded.
"""

from __future__ import annotations

import time
import typing as tp

import numpy as np

__all__ = ["PinnedShifts", "prewarm"]


class PinnedShifts:
    """``random.Random``-compatible shift-offset source cycling a pinned set.

    Pass as ``rng`` to ``apply_model`` / ``device_apply_model`` (or set
    ``shift_offsets`` on those entry points / on ``Separator``): every
    ``randint(0, max_shift)`` call returns the next pinned offset in order.
    ``reset()`` restarts the sequence: the track loops call it per track so
    every track consumes the same offsets.
    """

    def __init__(self, offsets: tp.Sequence[int]):
        offs = tuple(int(o) for o in offsets)
        if not offs:
            raise ValueError("shift_offsets must be a non-empty sequence")
        if any(o < 0 for o in offs):
            raise ValueError(f"shift offsets must be >= 0, got {offs}")
        self.offsets = offs
        self._i = 0

    def reset(self) -> None:
        self._i = 0

    def randint(self, a: int, b: int) -> int:
        off = self.offsets[self._i % len(self.offsets)]
        self._i += 1
        if not a <= off <= b:
            raise ValueError(
                f"pinned shift offset {off} outside the engine's draw range "
                f"[{a}, {b}] (max_shift = 0.5 s * samplerate)")
        return off


def prewarm(
    model,
    durations: tp.Union[float, tp.Sequence[float]],
    *,
    shifts: int = 1,
    shift_offsets: tp.Optional[tp.Sequence[int]] = None,
    overlap: float = 0.25,
    segment: tp.Optional[float] = None,
    batch_size: int = 16,
    engine: str = "auto",
    transfer_dtype: tp.Optional[str] = None,
    length_bucket_seconds: tp.Optional[float] = None,
    tail_mode: str = "exact",
    verbose: bool = False,
) -> tp.List[dict]:
    """Run every shape the given serving configuration needs once.

    A silent track per requested duration goes through ``apply_model`` with
    the serving parameters, and the stems are discarded. With a pinned
    offset set the warm run consumes EVERY offset (the shift count is raised
    to cover the set), so the tail shapes of each offset run too. Returns one
    dict per duration: ``seconds``, ``samples``, ``warm_time_s``,
    ``shift_offsets`` and ``tails_warmed``.

    Without ``shift_offsets`` and with ``shifts > 0`` the offsets stay
    random, so the tails of exact-tail kinds CANNOT be prewarmed: the report
    says ``tails_warmed=False`` then (pin offsets, use
    ``tail_mode="uniform"``, or serve ``shifts=0`` to bound them).
    """
    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.models.registry import BagOfModels

    if isinstance(durations, (int, float)):
        durations = [float(durations)]
    members = model.models if isinstance(model, BagOfModels) else [model]
    first = members[0]
    exact_tail_kinds = tail_mode == "exact" and any(
        m.kind != "htdemucs" or not (m.uses_train_segment or segment is not None)
        for m in members)

    warm_shifts = shifts
    if shifts and shift_offsets and exact_tail_kinds:
        # one warm pass must consume the whole pinned set (serving consumes
        # `shifts` offsets per member per track, cycling from the start)
        need = max(shifts * len(members), len(shift_offsets))
        warm_shifts = -(-need // len(members))

    report = []
    for dur in sorted({float(d) for d in durations}):
        length = int(dur * first.samplerate)
        mix = np.zeros((1, first.audio_channels, length), np.float32)
        t0 = time.perf_counter()
        apply_model(
            model, mix, shifts=warm_shifts, split=True, overlap=overlap,
            segment=segment, batch_size=batch_size, engine=engine,
            transfer_dtype=transfer_dtype,
            length_bucket_seconds=length_bucket_seconds, tail_mode=tail_mode,
            shift_offsets=tuple(shift_offsets) if shift_offsets else None,
        )
        dt = time.perf_counter() - t0
        entry = {
            "seconds": dur,
            "samples": length,
            "warm_time_s": round(dt, 3),
            "shift_offsets": tuple(shift_offsets) if shift_offsets else None,
            # random shifts leave exact-tail shapes cold (unbounded offsets);
            # everything else is warmed either way
            "tails_warmed": bool(shift_offsets) or not shifts or not exact_tail_kinds,
        }
        report.append(entry)
        if verbose:
            print(f"prewarm: {dur:.0f}s track warmed in {dt:.1f}s "
                  f"(offsets={entry['shift_offsets']}, "
                  f"tails_warmed={entry['tails_warmed']})", flush=True)
    return report
