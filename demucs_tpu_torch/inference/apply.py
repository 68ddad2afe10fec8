"""Host engine: segment-batched overlap-add inference
(port of the ``engine="host"`` path of ``demucs_tpu/inference/apply.py``).

Behavioral reference: ``demucs/apply.py:145-322`` — bag ensemble, random-shift
trick and overlap-add split, with the same numerics:

- chunks are centered windows that draw real neighbouring audio from the
  padded track and zero-pad only beyond its bounds (``TensorChunk.padded``);
- the segments of a track go to the model's device in batches of
  ``batch_size``, one forward per batch, under ``torch.inference_mode``;
- the triangular transition window, the weight normalization and the
  overlap-add stay on the host in fp32 numpy.

Shifts are drawn from an explicit ``random.Random`` exactly as the JAX
package draws them, so tests can pin them; ``shift_offsets`` pins them for
serving (``inference/prewarm.py``). ``apply_model`` routes a track to
the device-resident engine (``demucs_tpu_torch.inference.engine``) as the JAX
package does: by default whenever the model is on the card and the call
allows it.
"""

from __future__ import annotations

import random as _random
import typing as tp

import numpy as np
import torch

from demucs_tpu_torch.models.registry import AnyModel, BagOfModels, Model

__all__ = ["apply_model", "apply_model_tracks", "Chunk", "center_trim"]


class Chunk:
    """Zero-copy (array, offset, length) view — TensorChunk (apply.py:82-124)."""

    def __init__(self, array, offset: int = 0, length: tp.Optional[int] = None):
        if isinstance(array, Chunk):
            base, offset = array.base, array.offset + offset
            total = array.length + array.offset
        else:
            base, total = array, array.shape[-1]
        if not 0 <= offset < total:
            raise ValueError(f"offset {offset} outside [0, {total})")
        if length is None:
            length = total - offset
        else:
            length = min(total - offset, length)
        self.base = base
        self.offset = offset
        self.length = length

    @property
    def shape(self):
        shape = list(self.base.shape)
        shape[-1] = self.length
        return tuple(shape)

    def padded(self, target_length: int) -> np.ndarray:
        delta = target_length - self.length
        total = self.base.shape[-1]
        if delta < 0:
            raise ValueError((target_length, self.length))
        start = self.offset - delta // 2
        end = start + target_length
        correct_start = max(0, start)
        correct_end = min(total, end)
        pad_left = correct_start - start
        pad_right = end - correct_end
        return np.pad(self.base[..., correct_start:correct_end],
                      [(0, 0)] * (self.base.ndim - 1) + [(pad_left, pad_right)])


def center_trim(arr: np.ndarray, length: int) -> np.ndarray:
    delta = arr.shape[-1] - length
    if delta < 0:
        raise ValueError(f"arr must be longer than {length}")
    if delta:
        arr = arr[..., delta // 2 : -(delta - delta // 2)]
    return arr


def _pinned(rng: tp.Optional[_random.Random],
            shift_offsets: tp.Optional[tp.Sequence[int]]) -> tp.Optional[_random.Random]:
    """``rng``, or a ``PinnedShifts`` of ``shift_offsets``; not both."""
    if shift_offsets is None:
        return rng
    if rng is not None:
        raise ValueError("pass either rng or shift_offsets, not both")
    from demucs_tpu_torch.inference.prewarm import PinnedShifts

    return PinnedShifts(shift_offsets)


def _on_card(model: AnyModel) -> bool:
    first = model.models[0] if isinstance(model, BagOfModels) else model
    return first.device.type == "cuda"


def _triangle_weight(segment_length: int, transition_power: float) -> np.ndarray:
    # apply.py:271-276
    weight = np.concatenate([
        np.arange(1, segment_length // 2 + 1, dtype=np.float32),
        np.arange(segment_length - segment_length // 2, 0, -1, dtype=np.float32),
    ])
    return (weight / weight.max()) ** transition_power


def _eager(module: torch.nn.Module, batch: torch.Tensor) -> torch.Tensor:
    return module(batch)


def _run_batched(model: Model, chunks: tp.Sequence[Chunk], target_length: int,
                 batch_size: int,
                 on_chunk: tp.Optional[tp.Callable[[int, str], None]] = None,
                 forward: tp.Callable[[torch.nn.Module, torch.Tensor], torch.Tensor] = _eager
                 ) -> tp.List[np.ndarray]:
    """Forward the chunks, each padded to ``target_length``, in batches of
    ``batch_size`` on the model's device; returns each chunk's center-trimmed
    ``(B, S, C, chunk length)`` output on the host. The last batch is not
    padded: an eager forward has no executable to reuse. ``forward(module,
    batch)`` runs one batch (eagerly by default; the stream passes the CUDA
    graph cache's replay for its full segments), under inference mode, and its
    output is copied to the host before the next batch."""
    device = model.device
    results: tp.List[np.ndarray] = []
    for i in range(0, len(chunks), batch_size):
        group = chunks[i : i + batch_size]
        stacked = np.concatenate([c.padded(target_length) for c in group], axis=0)
        item_b = stacked.shape[0] // len(group)
        if on_chunk is not None:
            for j in range(len(group)):
                on_chunk(i + j, "start")
        with torch.inference_mode():
            out = forward(model.module, torch.from_numpy(stacked).to(device)).cpu().numpy()
        for j, chunk in enumerate(group):
            results.append(center_trim(out[j * item_b : (j + 1) * item_b], chunk.length))
            if on_chunk is not None:
                on_chunk(i + j, "end")
    return results


def apply_model(
    model: AnyModel,
    mix: tp.Union[np.ndarray, Chunk],
    shifts: int = 1,
    split: bool = True,
    overlap: float = 0.25,
    transition_power: float = 1.0,
    progress: bool = False,
    segment: tp.Optional[float] = None,
    callback: tp.Optional[tp.Callable[[dict], None]] = None,
    callback_arg: tp.Optional[dict] = None,
    rng: tp.Optional[_random.Random] = None,
    batch_size: int = 16,
    engine: str = "auto",
    transfer_dtype: tp.Optional[str] = None,
    length_bucket_seconds: tp.Optional[float] = None,
    tail_mode: str = "exact",
    shift_offsets: tp.Optional[tp.Sequence[int]] = None,
) -> np.ndarray:
    """Apply ``model`` to ``mix (B, C, L)`` -> ``(B, S, C, L)`` float32 numpy.

    Flags and semantics match ``demucs/apply.py:145-173``. ``engine``:
    ``"host"`` is this engine; ``"device"`` is the device-resident engine
    (``demucs_tpu_torch.inference.engine``: the track stays on the model's
    device, one copy of the stems back), on the card or the CPU, and raises
    when the call does not allow it; ``"auto"`` takes the device engine when
    the model is on the card and the call allows it: split mode, one ``(1, C,
    L)`` track, no callback. ``transfer_dtype`` (the stems' wire format),
    ``length_bucket_seconds`` and ``tail_mode`` apply to the device engine
    only (``engine._dispatch_track``); the float32 default wire is bit-exact.
    ``shift_offsets``: a pinned set of shift offsets consumed in order
    (``PinnedShifts``) instead of draws from ``rng``; pass one or the other.
    """
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    rng = _pinned(rng, shift_offsets)
    if engine != "host":
        eligible = (split and callback is None and isinstance(mix, np.ndarray)
                    and mix.ndim == 3 and mix.shape[0] == 1)
        if engine == "device" or (eligible and _on_card(model)):
            if not eligible:
                raise ValueError("engine='device' requires split mode, a single (1, C, L) "
                                 "track and no callback")
            from demucs_tpu_torch.inference.engine import device_apply_model

            return device_apply_model(
                model, mix, shifts=shifts, overlap=overlap,
                transition_power=transition_power, segment=segment,
                batch_size=batch_size, rng=rng, transfer_dtype=transfer_dtype,
                progress=progress, length_bucket_seconds=length_bucket_seconds,
                tail_mode=tail_mode)
    if rng is None:
        rng = _random  # the module acts as a Random instance (reference parity)
    callback_arg = dict(callback_arg or {})
    callback_arg.setdefault("model_idx_in_bag", 0)
    callback_arg.setdefault("shift_idx", 0)
    callback_arg.setdefault("segment_offset", 0)

    if isinstance(mix, np.ndarray):
        mix = Chunk(mix.astype(np.float32, copy=False))

    kwargs = dict(shifts=shifts, split=split, overlap=overlap,
                  transition_power=transition_power, progress=progress, segment=segment,
                  rng=rng, batch_size=batch_size, callback=callback, engine="host")

    if isinstance(model, BagOfModels):
        # apply.py:201-229 — fresh random shifts per member.
        estimates = 0.0
        totals = [0.0] * len(model.sources)
        callback_arg["models"] = len(model.models)
        for idx, (sub_model, model_weights) in enumerate(zip(model.models, model.weights)):
            sub_cb = dict(callback_arg)
            sub_cb["model_idx_in_bag"] = idx
            out = apply_model(sub_model, mix, callback_arg=sub_cb, **kwargs)
            for k, inst_weight in enumerate(model_weights):
                out[:, k] *= inst_weight
                totals[k] += inst_weight
            estimates = estimates + out
        for k in range(estimates.shape[1]):
            estimates[:, k] /= totals[k]
        return estimates

    callback_arg.setdefault("models", 1)
    if not transition_power >= 1:
        raise ValueError("transition_power < 1 leads to weird behavior.")
    batch, channels, length = mix.shape

    if shifts:
        # apply.py:237-256
        kwargs["shifts"] = 0
        max_shift = int(0.5 * model.samplerate)
        padded_mix = Chunk(mix.padded(length + 2 * max_shift))
        out = 0.0
        for shift_idx in range(shifts):
            offset = rng.randint(0, max_shift)
            shifted = Chunk(padded_mix, offset, length + max_shift - offset)
            sub_cb = dict(callback_arg)
            sub_cb["shift_idx"] = shift_idx
            res = apply_model(model, shifted, callback_arg=sub_cb, **kwargs)
            out = out + res[..., max_shift - offset :]
        out /= shifts
        return out

    if split:
        # apply.py:257-301, batched.
        kwargs["split"] = False
        out = np.zeros((batch, len(model.sources), channels, length), dtype=np.float32)
        sum_weight = np.zeros(length, dtype=np.float32)
        segment_f = model.segment if segment is None else segment
        if not segment_f > 0.0:
            raise ValueError(f"segment must be positive, got {segment_f}")
        segment_length = int(model.samplerate * segment_f)
        stride = int((1 - overlap) * segment_length)
        offsets = list(range(0, length, stride))
        weight = _triangle_weight(segment_length, transition_power)

        chunks = [Chunk(mix, offset, segment_length) for offset in offsets]
        groups: tp.Dict[int, tp.List[int]] = {}
        for i, chunk in enumerate(chunks):
            groups.setdefault(model.leaf_target(chunk.length, segment), []).append(i)

        bar = None
        if progress:
            import tqdm

            scale = float(format(stride / model.samplerate, ".2f"))
            bar = tqdm.tqdm(total=len(chunks), unit_scale=scale, ncols=120, unit="seconds")

        def on_chunk_factory(indices):
            def on_chunk(group_pos: int, state: str):
                if state == "end" and bar is not None:
                    bar.update(1)
                if callback is not None:
                    cb = dict(callback_arg)
                    cb["segment_offset"] = offsets[indices[group_pos]]
                    cb["state"] = state
                    callback(cb)

            return on_chunk

        chunk_outs: tp.List[tp.Optional[np.ndarray]] = [None] * len(chunks)
        for target, indices in groups.items():
            results = _run_batched(model, [chunks[i] for i in indices], target, batch_size,
                                   on_chunk_factory(indices))
            for i, res in zip(indices, results):
                chunk_outs[i] = res
        if bar is not None:
            bar.close()

        for offset, chunk_out in zip(offsets, chunk_outs):
            chunk_length = chunk_out.shape[-1]
            out[..., offset : offset + segment_length] += weight[:chunk_length] * chunk_out
            sum_weight[offset : offset + segment_length] += weight[:chunk_length]
        if not sum_weight.min() > 0:
            raise AssertionError("overlap-add left samples without weight")
        out /= sum_weight
        return out

    # Leaf (apply.py:302-322), single chunk.
    target = model.leaf_target(length, segment)
    if callback is not None:
        callback(dict(callback_arg, state="start"))
    [res] = _run_batched(model, [Chunk(mix, 0, length)], target, 1)
    if callback is not None:
        callback(dict(callback_arg, state="end"))
    return res


def apply_model_tracks(
    model: AnyModel,
    tracks: tp.Iterable[np.ndarray],
    *,
    shifts: int = 1,
    split: bool = True,
    overlap: float = 0.25,
    transition_power: float = 1.0,
    progress: bool = False,
    segment: tp.Optional[float] = None,
    rng: tp.Optional[_random.Random] = None,
    batch_size: int = 16,
    engine: str = "auto",
    transfer_dtype: tp.Optional[str] = None,
    length_bucket_seconds: tp.Optional[float] = None,
    tail_mode: str = "exact",
    shift_offsets: tp.Optional[tp.Sequence[int]] = None,
) -> tp.Iterator[np.ndarray]:
    """``apply_model`` over several tracks, each ``(1, C, L)`` float: yields
    ``(1, S, C, L)`` stems per track, in order.

    On the device engine (the same choice as ``apply_model``'s), each track's
    copy of its stems to the host overlaps the next track's compute
    (``engine.device_separate_tracks``); on the host engine the tracks run one
    after the other. Set ``length_bucket_seconds`` so that tracks of other
    lengths share the card's graphs. With ``shift_offsets`` every track
    consumes the same pinned offsets from the start of the set.
    """
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    use_device = engine == "device" or (engine == "auto" and split and _on_card(model))
    if use_device and not split:
        raise ValueError("engine='device' requires split mode")

    def checked(items):
        for mix in items:
            mix = np.asarray(mix)
            if mix.ndim != 3 or mix.shape[0] != 1 or mix.dtype.kind != "f":
                raise ValueError("apply_model_tracks expects float (1, C, L) tracks, got "
                                 f"shape {mix.shape} dtype {mix.dtype}; use apply_model "
                                 "for batched input")
            yield mix

    tracks = checked(tracks)
    rng = _pinned(rng, shift_offsets)
    if shift_offsets is not None:
        # one pinned source, reset as each track is pulled: the engines draw
        # a track's offsets before they pull the next one
        def resetting(items, pinned=rng):
            for mix in items:
                pinned.reset()
                yield mix

        tracks = resetting(tracks)
    if use_device:
        from demucs_tpu_torch.inference.engine import device_separate_tracks

        yield from device_separate_tracks(
            model, tracks, shifts=shifts, overlap=overlap,
            transition_power=transition_power, segment=segment, batch_size=batch_size,
            rng=rng, transfer_dtype=transfer_dtype, progress=progress,
            length_bucket_seconds=length_bucket_seconds, tail_mode=tail_mode)
        return
    for mix in tracks:
        yield apply_model(model, mix, shifts=shifts, split=split, overlap=overlap,
                          transition_power=transition_power, progress=progress,
                          segment=segment, rng=rng, batch_size=batch_size, engine="host")
