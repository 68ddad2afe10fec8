"""Device-resident separation engine (port of ``demucs_tpu/inference/engine.py``).

The host engine (``apply.py``) copies every batch's output back to the host
and overlap-adds it there in numpy. This engine keeps the whole track on the
model's device:

  upload the track once into a padded device buffer ->
    [per bag member, per shift pass]
        cut the overlapping segments on the device (the full windows are one
        ``unfold`` view of the buffer, each tail window a ``narrow``) ->
        batched forwards in right-sized batches; on the card each is one
        replay of a CUDA graph captured per (model, batch, channels, target),
        the counterpart of the TPU's one fixed executable per shape ->
        triangle-weighted overlap-add on the device, divided by the true
        weight sum, accumulated into one device buffer
  -> normalize, cast to the wire format, and ONE copy of the stems into
     pinned host memory (with the wire's per-row scales, a few bytes, beside).

Numerics follow the JAX engine: the segment offsets, centered windows
(``TensorChunk.padded``), triangle weights ``** transition_power``, per-source
bag weights and shift averaging of the reference (apply.py:108-124,
:257-301), and the JAX engine's association of the overlap-add sums (strips
of K = ceil(target / stride) segment groups; at overlap <= 0.5 that is the
host's sum). The geometry is plain Python here: the shift offset is drawn on
the host, and the JAX engine traces it only to keep one executable per shape.

Kinds whose leaf target depends on the chunk length (HDemucs, which runs
the chunk's own length, Demucs v2, its ``valid_length``, and HTDemucs
without ``use_train_segment``) run the full windows in the uniform pass and
each ragged tail chunk at its exact leaf target, eagerly (its shape varies
with the shift offset); ``tail_mode="uniform"`` pads the tails to the
uniform target instead (see ``_dispatch_track``). Bag members with other
leaf targets get track buffers of their own.

What the TPU deployment needed and the card does not: the JAX engine splits
the upload into threaded 3 MB pieces and the fetch into 12 MB slices
(engine.py:568-579, :685-712) because its host link collapsed on large single
transfers. Here the track goes up from one pinned buffer and the stems come
back in one ``non_blocking`` copy on a copy stream. The JAX engine also
uploads the track in float16 when the stems' wire is not float32, to halve
that link's load; here the track always goes up in float32 (a 30 s stereo
track is about 10 MB), so the model never computes from a rounded input.

Several devices (``devices=``, the JAX engine's ``mesh``; engine.py:82-245,
:441, :955-987, :1117-1133, :1225): each pass's segment batch is split over
the devices, each running a replica of the module (its own ``GraphCache``
entry, keyed on its device) on its contiguous share; the outputs are
gathered on the model's device before the overlap-add, so the overlap-add
runs in the one-device order. A homogeneous uniform-target bag whose member
count divides the device count fans out instead: member m runs its passes
on its group of ``len(devices) / members`` devices (its segments split
within the group), the per-member stems summed on the model's device in
member order. Each device's share (its upload, replays, captures and sums)
runs with that device current (``_on``): the runtime launches a kernel, a
capture and a replay on the current device, and the kernel wrappers refuse a
tensor of another one. ``group=`` (a ``torch.distributed`` process group) fans a bag
out over the group's ranks: each rank runs its contiguous share of the
members on its own device(s), the weighted sums are all-reduced, and every
rank gets the bag's stems (the shift offsets are drawn for every member on
every rank, model-major, so the draws are the one-process engine's).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import math
import random as _random
import time
import typing as tp
import weakref

import numpy as np
import torch
import torch.distributed as dist

from demucs_tpu_torch.inference.apply import _triangle_weight
from demucs_tpu_torch.kernels import device_cache, retain_tables
from demucs_tpu_torch.kernels.attention import flash_mha, flash_mha_bf16
from demucs_tpu_torch.kernels.stft import istft_dft, stft_dft
from demucs_tpu_torch.models.registry import AnyModel, BagOfModels, Model

__all__ = ["device_apply_model", "device_separate_tracks", "stage_track", "GRAPHS",
           "pass_memory_analysis"]

WIRE_DTYPES = (None, "float32", "float16", "int16", "int8")
_INT8_BLOCK = 1024
# the kernel wrappers a forward launches (K3's two routes count apart)
KERNELS = (stft_dft, istft_dft, flash_mha, flash_mha_bf16)


def _segment_grid(length: int, max_shift: int, stride: int, batch_size: int,
                  shard_size: int = 1) -> tp.Tuple[int, int, int]:
    """Segment grid sized for the largest possible shifted view
    (``length + max_shift`` samples); shorter views leave tail slots empty.
    Right-sizes the batch so padding slots (wasted forwards) are minimal:
    11 segments at batch 8 would run 16 slots; batch 6 runs 12. The batch is
    also the shape of the CUDA graph. With ``shard_size`` devices the
    segments are shared over them first and the batch is each device's.
    Returns ``(batch_size, n_batches, n_pad)``."""
    n_segments = int(math.ceil((length + max_shift) / stride))
    per = int(math.ceil(n_segments / shard_size))
    n_batches = int(math.ceil(per / batch_size))
    batch_size = int(math.ceil(per / n_batches))
    return batch_size, n_batches, n_batches * batch_size * shard_size


def _exact_obuf_len(length: int, max_shift: int, segment_length: int,
                    target: int, stride: int, batch_size: int, shard_size: int = 1) -> int:
    """Length of the unnormalized buffers of the exact-tails pass: the strips
    of the full windows, plus ``target`` of slack for the tail windows."""
    _, _, n_pad = _segment_grid(length, max_shift, stride, batch_size, shard_size)
    K = -(-target // stride)
    ng = -(-n_pad // K)
    return target + max_shift + (K - 1) * stride + ng * K * stride + target


@device_cache(maxsize=16)
def _device_constant(values: tuple, device) -> torch.Tensor:
    """Small float32 vectors the passes reuse (weights, bag scales, totals),
    uploaded once: a pageable copy per pass could stall the queue."""
    return torch.tensor(values, dtype=torch.float32, device=device)


@device_cache(maxsize=8)
def _triangle_weight_dev(segment_length: int, transition_power: float, device) -> torch.Tensor:
    return torch.from_numpy(_triangle_weight(segment_length, transition_power)).to(device)


# ---------------------------------------------------------------------------
# The batched forward: eager on the CPU, a replayed CUDA graph on the card
# ---------------------------------------------------------------------------


def _on(device: torch.device):
    """``device`` current for the block on a card (module docstring); nothing
    on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every capture on ``device`` runs on, and nothing else.
    ``torch.cuda.graph``'s own default is one stream, made on the device
    current at the first capture. A stream that also ran eager work would
    hand the capture the cuBLAS workspace it took then, outside the graphs'
    pool, which ``GraphCache.clear`` frees under the graphs of other caches;
    a capture-only stream takes its workspace inside the first capture."""
    return torch.cuda.Stream(device)


def _launch_counts() -> tp.Dict[str, int]:
    """Each kernel wrapper's launches, then K3's by instance (its routes'
    ``launches_by_instance``) as ``"flash_mha D=128 masked"``."""
    counts = {k.__name__: k.launches for k in KERNELS}
    for k in KERNELS:
        counts.update({f"{k.__name__} {key}": n
                       for key, n in getattr(k, "launches_by_instance", {}).items()})
    return counts


def _take_back(launches: tp.Dict[str, int]) -> None:
    """Subtract ``launches`` (as :func:`_launch_counts` names them) from the
    wrappers' counts."""
    for k in KERNELS:
        k.launches -= launches[k.__name__]
        for key in getattr(k, "launches_by_instance", {}):
            k.launches_by_instance[key] -= launches[f"{k.__name__} {key}"]


class BatchGraph:
    """The forward of one module at one input shape, captured as a CUDA graph.

    One eager forward first, on a side stream as the PyTorch documentation
    asks, so that every lazily built table exists and every kernel is loaded
    before the capture (a table built inside it would be a host copy, which a
    capture refuses). Then the capture, under ``torch.inference_mode()``, from
    a static input into a static output in the pool ``pool``. A failed
    capture raises; nothing falls back to eager.

    The kernel wrappers count a launch when they are called, and during the
    capture they are called but launch nothing: their counts are taken back
    here and kept in ``launches``, the launches one replay makes.

    ``state`` is what the graph baked in besides its input shape
    (``_graph_state``).
    """

    def __init__(self, module: torch.nn.Module, shape: tp.Tuple[int, ...],
                 device: torch.device, pool):
        self.module = weakref.ref(module)
        self.state = _graph_state(module)
        with torch.inference_mode(False):  # written by every replay, in any mode
            self.static_in = torch.zeros(shape, device=device)
        start = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.inference_mode():
            module(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - start
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        # the tables the graph reads by address live as long as the graph
        with retain_tables() as self.tables:
            with torch.inference_mode(), torch.cuda.graph(self.graph, pool=pool,
                                                          stream=_capture_stream(device)):
                self.static_out = module(self.static_in)
        self.capture_s = time.perf_counter() - start
        after = _launch_counts()
        self.launches = {name: after[name] - before[name] for name in after}
        _take_back(self.launches)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """Run the graph on ``batch``; the output stays valid until the next
        replay of a graph of the same pool, so consume it before that."""
        self.static_in.copy_(batch)
        self.graph.replay()
        return self.static_out


def _graph_state(module: torch.nn.Module) -> tuple:
    """What a captured forward depends on besides its input shape: the
    addresses of the parameters it reads, and the module's config, on which
    the forward branches (HTDemucs pads its input to the config's training
    length, which ``Model.segment`` sets) and which sets its precision policy
    (the TF32 flags, the bf16 stages: a graph bakes in the kernels chosen
    under them). The config is a frozen dataclass: a change is a new config,
    which compares unequal, so no graph captured under one policy replays
    under another."""
    return tuple(p.data_ptr() for p in module.parameters()), getattr(module, "cfg", None)


class GraphCache:
    """At most ``maxsize`` :class:`BatchGraph` s, keyed on (module, input
    shape, device), least recently used dropped first. All graphs of a device
    share one memory pool (``torch.cuda.graph_pool_handle()``): a private pool
    per graph would hold the activations of every shape at once (a 30, 12 and
    5 s request run batches of 6, 3 and 1). Sharing is safe because replays
    run one after the other on one stream and each replay's output is
    consumed before the next replay. A graph is captured again when its
    module's parameters moved or its config changed (``_graph_state``)."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self.entries: "collections.OrderedDict[tuple, BatchGraph]" = collections.OrderedDict()
        self.pools: dict = {}
        self.captures = 0
        self.capture_s = 0.0
        self.warmup_s = 0.0
        self.reset_counts()

    def reset_counts(self) -> None:
        """Zero the replay counts (``chip_smoke.py`` does so with the kernels')."""
        self.replays = 0
        self.replayed_launches = dict.fromkeys(_launch_counts(), 0)

    def forward(self, module: torch.nn.Module, batch: torch.Tensor) -> torch.Tensor:
        with _on(batch.device):
            return self._forward(module, batch)

    def _forward(self, module: torch.nn.Module, batch: torch.Tensor) -> torch.Tensor:
        key = (id(module), tuple(batch.shape), batch.device)
        entry = self.entries.get(key)
        if (entry is None or entry.module() is not module
                or entry.state != _graph_state(module)):
            pool = self.pools.get(batch.device)
            if pool is None:
                pool = self.pools[batch.device] = torch.cuda.graph_pool_handle()
            self.entries.pop(key, None)
            entry = BatchGraph(module, tuple(batch.shape), batch.device, pool)
            self.entries[key] = entry
            self.captures += 1
            self.capture_s += entry.capture_s
            self.warmup_s += entry.warmup_s
            while len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
        self.entries.move_to_end(key)
        out = entry(batch)
        self.replays += 1
        for name, n in entry.launches.items():
            self.replayed_launches[name] += n
        return out

    def clear(self) -> None:
        """Drop every graph and the pools' handles. Once no output of a replay
        is held elsewhere, the pools' memory goes back to PyTorch's caching
        allocator, and ``torch.cuda.empty_cache()`` returns it to the card.
        The next forward of a shape captures its graph again."""
        had_pools = bool(self.pools)
        self.entries.clear()
        self.pools.clear()
        if had_pools and torch.cuda.is_available():
            # cuBLAS keeps the workspace it took inside the last capture (32
            # MiB, measured on the H100), which lies in the graphs' pool and
            # would pin that pool's segment; the next product takes a new one
            torch._C._cuda_clearCublasWorkspaces()

    def pool_bytes(self) -> tp.Optional[int]:
        """Device memory the graphs' pools hold (``torch.cuda.memory_snapshot``
        segments of those pools), or None where the snapshot does not say."""
        if not self.pools:
            return 0
        pools = {tuple(p) for p in self.pools.values()}
        segments = torch.cuda.memory_snapshot()
        if not all("segment_pool_id" in s for s in segments):
            return None
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) in pools)

    def stats(self) -> dict:
        return {"graphs": len(self.entries), "captures": self.captures,
                "capture_s": self.capture_s, "warmup_s": self.warmup_s,
                "replays": self.replays, "replayed_launches": dict(self.replayed_launches),
                "pool_bytes": self.pool_bytes()}


GRAPHS = GraphCache()


def _forward(module: torch.nn.Module, batch: torch.Tensor) -> torch.Tensor:
    """``module(batch)``: a graph replay on the card (from ``GRAPHS``, looked
    up at the call), eager on the CPU."""
    if batch.device.type == "cuda":
        return GRAPHS.forward(module, batch)
    with torch.inference_mode():
        return module(batch)


# (id(module), device) -> (weakref to module, its state when copied, replica)
_REPLICAS: tp.Dict[tuple, tuple] = {}


def _module_state(module: torch.nn.Module) -> tuple:
    """What a replica copied: the parameters' and buffers' addresses and
    versions (an in-place update bumps a version) and the config."""
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    return (tuple(t.data_ptr() for t in tensors), tuple(t._version for t in tensors),
            getattr(module, "cfg", None))


def replica(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` on ``device``: the module itself on its own device, else a
    copy made once and kept while the module is unchanged."""
    device = torch.device(device)
    if device == next(module.parameters()).device:
        return module
    key = (id(module), device)
    state = _module_state(module)
    entry = _REPLICAS.get(key)
    if entry is None or entry[0]() is not module or entry[1] != state:
        import copy

        with torch.inference_mode(False), torch.no_grad():
            copied = copy.deepcopy(module).to(device)
        entry = _REPLICAS[key] = (weakref.ref(module), state, copied)
    return entry[2]


def _sharded_forward(module: torch.nn.Module, batch: torch.Tensor,
                     devices: tp.Sequence[torch.device]) -> torch.Tensor:
    """``module(batch)`` with the batch split over ``devices`` in contiguous
    shares (each a replica's forward, a graph replay on a card), gathered
    back on the batch's device in order. Each share is copied out before the
    next forward: two shares on one device replay the same graph."""
    per = batch.shape[0] // len(devices)
    outs = []
    for i, device in enumerate(devices):
        with _on(device):
            part = batch[i * per: (i + 1) * per].to(device, non_blocking=True)
            out = _forward(replica(module, device), part)
            outs.append(out.to(batch.device, copy=True, non_blocking=True))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# One (member, shift) pass
# ---------------------------------------------------------------------------


def _make_pass_body(model: Model, length: int, max_shift: int, segment_length: int,
                    target: int, stride: int, batch_size: int, transition_power: float,
                    segment: tp.Optional[float] = None, exact_tails: bool = False,
                    devices: tp.Optional[tp.Sequence[torch.device]] = None):
    """One (model, shift) pass over a track of ``length`` samples.

    The track buffer is ``(C, buf_len)``: ``[margin | max_shift zeros | track |
    max_shift zeros | margin]`` with ``margin = target``, so every centered
    window is a plain slice. Returns ``pass_fn(track_buf, shift_offset, accum,
    scale)``, which adds ``scale[:, None, None] * stems`` of this pass into
    ``accum (S, C, length)``, normalized by its own weight sum.

    ``exact_tails``: the uniform-target batches take the FULL windows only
    (their target and trim are the same at every offset) and each ragged tail
    chunk runs at its exact reference leaf target (``_tail_forward``), as the
    host engine pads it; the normalization follows (``_normalize``).

    ``devices``: each batch of segments is split over them
    (``_sharded_forward``; ``batch_size`` segments per device).
    """
    module = model.module
    S, C = len(model.sources), model.audio_channels
    shards = len(devices) if devices else 1
    batch_size, _, n_pad = _segment_grid(length, max_shift, stride, batch_size, shards)
    per_device, batch_size = batch_size, batch_size * shards
    margin = target
    K = -(-target // stride)  # windows of one group are P >= target apart: disjoint
    P = K * stride
    ng = -(-n_pad // K)
    trim_full = (target - segment_length) // 2
    obuf_len = (_exact_obuf_len(length, max_shift, segment_length, target, stride,
                                per_device, shards)
                if exact_tails else margin + max_shift + (K - 1) * stride + ng * P)

    def overlap_add(track_buf, shift_offset):
        """Unnormalized ``(out_buf (S, C, obuf_len), wsum_buf (obuf_len,))`` of the
        uniform-target windows, in buffer coordinates."""
        device = track_buf.device
        weight = _triangle_weight_dev(segment_length, transition_power, device)
        view_length = length + max_shift - shift_offset
        n_valid = min(n_pad, -(-view_length // stride))  # o < view_length
        n_full = min(n_valid, max(0, (view_length - segment_length) // stride + 1))
        items = n_full if exact_tails else n_valid
        base = margin + shift_offset  # buffer coordinate of the view's sample 0
        # window i starts at base + i * stride - trim_i; the full ones are one view
        full = track_buf[:, base - trim_full:].unfold(-1, target, stride)
        # Each contribution rolled left by its trim, so that window i lands at
        # base + i * stride, and kept in the layout of the strips: segment i in
        # group i % K, slot i // K. Empty slots stay zero.
        contrib = track_buf.new_zeros(K, S, C, ng, P)
        wroll = track_buf.new_zeros(K, ng, P)
        for b0 in range(0, items, batch_size):
            b1 = min(items, b0 + batch_size)
            batch = track_buf.new_zeros(batch_size, C, target)
            f1 = max(b0, min(b1, n_full))
            if f1 > b0:
                batch[: f1 - b0] = full[:, b0:f1].transpose(0, 1)
            # the tail windows of the batch: (segment, chunk length, trim)
            tails = [(i, min(view_length - i * stride, segment_length)) for i in range(f1, b1)]
            tails = [(i, n, (target - n) // 2) for i, n in tails]
            for i, _, trim in tails:
                start = base + i * stride - trim
                batch[i - b0] = track_buf[:, start : start + target]
            # (batch_size, S, C, target): consume now
            out = _sharded_forward(module, batch, devices) if devices else _forward(module, batch)
            for g in range(K):
                first = b0 + (g - b0) % K  # the batch's first segment of group g
                if first < f1:
                    rows = out[first - b0 : f1 - b0 : K, ..., trim_full:trim_full + segment_length]
                    slots = slice(first // K, first // K + rows.shape[0])
                    torch.mul(rows.permute(1, 2, 0, 3), weight,
                              out=contrib[g, :, :, slots, :segment_length])
                    wroll[g, slots, :segment_length] = weight
            for i, chunk_len, trim in tails:
                torch.mul(out[i - b0, ..., trim : trim + chunk_len], weight[:chunk_len],
                          out=contrib[i % K, :, :, i // K, :chunk_len])
                wroll[i % K, i // K, :chunk_len] = weight[:chunk_len]
        out_buf = track_buf.new_zeros(S, C, obuf_len)
        wsum_buf = track_buf.new_zeros(obuf_len)
        for g in range(K):  # K strip adds instead of one add per segment
            start = base + g * stride
            out_buf[..., start : start + ng * P] += contrib[g].reshape(S, C, ng * P)
            wsum_buf[start : start + ng * P] += wroll[g].reshape(ng * P)
        return out_buf, wsum_buf, view_length

    def pass_fn(track_buf, shift_offset: int, accum, scale):
        out_buf, wsum_buf, view_length = overlap_add(track_buf, shift_offset)
        if exact_tails:
            weight = _triangle_weight_dev(segment_length, transition_power, track_buf.device)
            for o in range(0, view_length, stride):
                chunk_len = min(view_length - o, segment_length)
                if chunk_len < segment_length:
                    _tail_forward(model, track_buf, margin, shift_offset + o, chunk_len,
                                  model.leaf_target(chunk_len, segment), weight, out_buf,
                                  wsum_buf)
        _normalize(out_buf, wsum_buf, margin + max_shift, length, accum, scale)

    return pass_fn


def _tail_forward(model: Model, track_buf: torch.Tensor, margin: int, offset: int,
                  chunk_len: int, tail_target: int, weight: torch.Tensor,
                  out_buf: torch.Tensor, wsum_buf: torch.Tensor) -> None:
    """One ragged tail chunk at its exact leaf target (JAX ``_build_tail_fn``).

    ``offset`` is the chunk's start in the shift-padded track (``[max_shift
    zeros | track | max_shift zeros]``); the window is ``Chunk.padded``'s, cut
    from the device buffer, whose margins hold the zeros that ``padded`` adds.
    Eager: the target changes with the shift offset. The window is copied into
    a fresh contiguous tensor, as the host engine uploads it: over the
    buffer's view (its strides, an offset base) HDemucs's input mean sums in
    another order, a few fp32 ulps of the output."""
    start = margin + offset - (tail_target - chunk_len) // 2
    if start < 0 or start + tail_target > track_buf.shape[-1]:
        raise AssertionError(f"tail window [{start}, {start + tail_target}) outside the buffer")
    window = track_buf[None, :, start : start + tail_target].clone(
        memory_format=torch.contiguous_format)
    with torch.inference_mode():
        out = model.module(window)[0]  # (S, C, tail_target)
    trim = (tail_target - chunk_len) // 2
    pos = margin + offset
    out_buf[..., pos : pos + chunk_len] += out[..., trim : trim + chunk_len] * weight[:chunk_len]
    wsum_buf[pos : pos + chunk_len] += weight[:chunk_len]


def _normalize(out_buf: torch.Tensor, wsum_buf: torch.Tensor, lo: int, length: int,
               accum: torch.Tensor, scale: torch.Tensor) -> None:
    """Divide a pass's track span ``[lo, lo + length)`` by its TRUE weight sum
    and add it, scaled per source, into ``accum`` (JAX ``_build_norm_fn``).
    No epsilon floor: every in-track sample is covered by a segment, and a
    floor like 1e-12 would corrupt track-edge samples whose genuine weight sum
    is below it (``(2 / segment_length) ** transition_power``, about 2e-16 at
    the released segment with power 3)."""
    res = out_buf[..., lo : lo + length] / wsum_buf[lo : lo + length]
    accum += scale[:, None, None] * res


# ---------------------------------------------------------------------------
# Wire formats and the copy to the host
# ---------------------------------------------------------------------------


def _final_body(accum: torch.Tensor, totals: torch.Tensor,
                transfer_dtype: tp.Optional[str]) -> tp.Tuple[torch.Tensor, ...]:
    """Normalize by the bag and shift totals and cast to the wire format:
    float32 (bit-exact), float16, int16 (per source and channel, peak-scaled)
    or int8 (per block of 1024 samples, scales as float16). Returns the
    tensors to copy to the host, the stems first."""
    y = accum / totals[:, None, None]
    if transfer_dtype in (None, "float32"):
        return (y,)
    if transfer_dtype == "float16":
        return (y.half(),)
    if transfer_dtype == "int16":
        scale = y.abs().amax(dim=-1, keepdim=True) / 32766.0 + 1e-12
        return torch.round(y / scale).to(torch.int16), scale
    if transfer_dtype == "int8":
        # Block-adaptive: quantization noise follows the local level (about
        # 44 dB SNR), half the bytes of float16.
        pad = (-y.shape[-1]) % _INT8_BLOCK
        yb = torch.nn.functional.pad(y, (0, pad)).reshape(*y.shape[:-1], -1, _INT8_BLOCK)
        scale = yb.abs().amax(dim=-1, keepdim=True) / 126.0 + 1e-12
        return torch.round(yb / scale).to(torch.int8), scale.half()
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def _start_fetch(result: tp.Tuple[torch.Tensor, ...]):
    """Queue the copy of ``result`` into fresh pinned host memory on the copy
    stream, behind the work that makes it; returns ``(host tensors, event)``.
    Each track gets its own pinned tensors: the caller's numpy arrays are views
    of them, and a reused buffer would be overwritten by the next track."""
    device = result[0].device
    if device.type != "cuda":
        return result, None
    stream = _copy_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in result)
        for h, t in zip(host, result):
            h.copy_(t, non_blocking=True)
            t.record_stream(stream)  # not reused by the allocator before the copy ends
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


def _gather_stems(fetched, transfer_dtype: tp.Optional[str], orig_length: int) -> np.ndarray:
    """Wait for the copy and decode the wire format -> ``(1, S, C, L)`` float32."""
    host, done = fetched
    if done is not None:
        done.synchronize()
    if transfer_dtype == "int16":
        q, scale = (t.numpy() for t in host)
        out = q.astype(np.float32) * scale
    elif transfer_dtype == "int8":
        q, scale = (t.numpy() for t in host)
        out = q.astype(np.float32) * scale.astype(np.float32)
        out = out.reshape(*out.shape[:-2], -1)
    else:
        out = host[0].numpy().astype(np.float32, copy=False)
    return out[None][..., :orig_length]


# ---------------------------------------------------------------------------
# Upload, dispatch, entry points
# ---------------------------------------------------------------------------


def _upload_track(track: np.ndarray, C: int, L: int, margin: int, max_shift: int,
                  device: torch.device) -> torch.Tensor:
    """Copy ``track (C, L)`` to the device once, in float32 from pinned memory,
    and pad it there into the engine buffer (the zero margins never cross the
    link)."""
    src = torch.from_numpy(np.ascontiguousarray(track, dtype=np.float32))
    if device.type == "cuda":
        src = src.pin_memory().to(device, non_blocking=True)
    buf = torch.zeros(C, margin + max_shift + L + max_shift + margin, device=device)
    buf[:, margin + max_shift : margin + max_shift + L] = src
    return buf


def _members(model: AnyModel) -> tp.Tuple[tp.List[Model], tp.List[tp.List[float]]]:
    if isinstance(model, BagOfModels):
        return model.models, model.weights
    return [model], [[1.0] * len(model.sources)]


def _model_device(models: tp.Sequence[Model]) -> torch.device:
    device = models[0].device
    if any(m.device != device for m in models):
        raise ValueError("the device engine needs every bag member on one device")
    return device


@torch.inference_mode()
def stage_track(model: AnyModel, mix: np.ndarray, *, shifts: int = 1,
                segment: tp.Optional[float] = None) -> dict:
    """Upload a track's padded engine buffer(s) to the model's device ahead of
    time. Pass the result as ``device_apply_model(..., prestaged=...)`` to take
    the upload off the dispatch path; the staging arguments must match the
    apply call's."""
    models, _ = _members(model)
    if mix.ndim != 3 or mix.shape[0] != 1:
        raise ValueError(f"expected one (1, C, L) track, got {mix.shape}")
    device = _model_device(models)
    first = models[0]
    max_shift = int(0.5 * first.samplerate) if shifts else 0
    out: dict = {}
    for m in models:
        seg_len = int(first.samplerate * (segment if segment is not None else m.segment))
        key = (seg_len, m.leaf_target(seg_len, segment))
        if key not in out:
            out[key] = _upload_track(mix[0], first.audio_channels, mix.shape[-1], key[1],
                                     max_shift, device)
    return out


def pass_memory_analysis(model: AnyModel, length: int, *, shifts: int = 1,
                         overlap: float = 0.25, transition_power: float = 1.0,
                         segment: tp.Optional[float] = None,
                         batch_size: int = 16) -> tp.Optional[dict]:
    """Device memory of one pass of the device engine over a ``length``-sample
    track (the JAX engine's ``pass_memory_analysis``, engine.py:715, without
    ``mesh``), in GiB: ``argument_gb`` (the first member's weights and its
    padded track buffer), ``output_gb`` (the stems, ``(S, C, length)`` fp32),
    ``temp_gb`` (what the pass needs besides: the CUDA graphs' pool captured
    for its shapes plus the peak of ``torch.cuda.max_memory_allocated`` over a
    warm pass above what was allocated before it, less the track buffer and
    the stems), ``alias_gb`` (0: no buffer is donated), ``peak_estimate_gb``
    (their sum) and ``generated_code_mb`` (the kernel libraries loaded).

    The JAX engine reads XLA's buffer assignment; here the pass runs, twice,
    on a zero track: once to capture its graphs into a cache of its own (the
    caller's ``GRAPHS`` is left as it was, and the analysis's pool is freed
    after), then warm. A graph's replay writes into its pool without the
    allocator seeing it, which is why the pool is counted apart. None on the
    CPU, as the JAX engine returns None where the backend has no analysis.
    """
    global GRAPHS
    from demucs_tpu_torch.kernels import _build

    models, _ = _members(model)
    first = models[0]
    device = first.device
    if device.type != "cuda":
        return None
    S, C = len(first.sources), first.audio_channels
    seg_len = int(first.samplerate * (segment if segment is not None else first.segment))
    target = first.leaf_target(seg_len, segment)
    max_shift = int(0.5 * first.samplerate) if shifts else 0
    track_bytes = 4 * C * (2 * target + 2 * max_shift + length)
    out_bytes = 4 * S * C * length
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in itertools.chain(first.module.parameters(),
                                                first.module.buffers()))
    mix = np.zeros((1, C, length), np.float32)
    kw = dict(shifts=shifts, overlap=overlap, transition_power=transition_power,
              segment=segment, batch_size=batch_size)
    outer, GRAPHS = GRAPHS, GraphCache()
    try:
        device_apply_model(first, mix, rng=_random.Random(0), **kw)  # captures
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        device_apply_model(first, mix, rng=_random.Random(0), **kw)
        torch.cuda.synchronize(device)
        above = torch.cuda.max_memory_allocated(device) - before
        pool = GRAPHS.pool_bytes() or 0
    finally:
        GRAPHS.clear()
        GRAPHS = outer
        torch.cuda.empty_cache()
    arg = weight_bytes + track_bytes
    tmp = max(0, pool + above - track_bytes - out_bytes)
    code = sum(_build.library_path(name).stat().st_size for name in _build._LOADED)
    gib = float(2**30)
    return {
        "argument_gb": round(arg / gib, 3),
        "output_gb": round(out_bytes / gib, 3),
        "temp_gb": round(tmp / gib, 3),
        "alias_gb": 0.0,
        "peak_estimate_gb": round((arg + out_bytes + tmp) / gib, 3),
        "generated_code_mb": round(code / 2**20, 2),
    }


def device_apply_model(model: AnyModel, mix: np.ndarray, **kw) -> np.ndarray:
    """Separate ``mix (1, C, L)`` on the model's device -> ``(1, S, C, L)`` float32.

    Keywords as ``_dispatch_track``. With the default float32 wire it matches
    ``apply_model(engine="host")`` to the forward's own rounding."""
    return _gather_stems(*_dispatch_track(model, mix, **kw))


def device_separate_tracks(model: AnyModel, tracks: tp.Iterable[np.ndarray],
                           **kw) -> tp.Iterator[np.ndarray]:
    """Separate tracks one after the other, yielding ``(1, S, C, L)`` stems per
    track: each track's work is queued before the previous track's copy to the
    host is waited on, so that copy (and the caller's work on the stems)
    overlaps the next track's compute. The same results as one
    ``device_apply_model`` call per track with the same ``rng``."""
    pending = None
    for mix in tracks:
        state = _dispatch_track(model, mix, **kw)
        if pending is not None:
            yield _gather_stems(*pending)
        pending = state
    if pending is not None:
        yield _gather_stems(*pending)


@torch.inference_mode()
def _dispatch_track(
    model: AnyModel,
    mix: np.ndarray,
    *,
    shifts: int = 1,
    overlap: float = 0.25,
    transition_power: float = 1.0,
    segment: tp.Optional[float] = None,
    batch_size: int = 16,
    rng: tp.Optional[_random.Random] = None,
    transfer_dtype: tp.Optional[str] = None,
    progress: bool = False,
    length_bucket_seconds: tp.Optional[float] = None,
    prestaged: tp.Optional[dict] = None,
    tail_mode: str = "exact",
    devices: tp.Optional[tp.Sequence] = None,
    group=None,
):
    """Queue all device work of one track, the copy of its stems to the host
    included; returns what ``_gather_stems`` waits on.

    ``devices``: the devices the segments (or a bag's members) run on, the
    model's own device holding the track and the stems (module docstring);
    ``group``: a process group to fan a bag out over.

    ``transfer_dtype``: the wire format of the stems (``_final_body``); the
    track itself always goes up in float32.

    Bags: the JAX engine runs a homogeneous uniform-target bag as ONE stacked
    program, a ``lax.scan`` over the stacked member parameters around the
    whole per-member pass. The loop over the members here, on one device
    buffer, is the PyTorch form of that scan: the same member-major shift
    draws and per-member weights, one member's activation memory.

    ``tail_mode`` (kinds whose leaf target depends on the chunk length only):
    "exact" runs each ragged tail chunk at its reference leaf target, eagerly;
    "uniform" pads it to the uniform target like the full windows (one graph
    for the whole pass; the tails then see a little more real context than the
    reference's per-length padding). Uniform-target models are exact either way.

    ``length_bucket_seconds``: right-pad the track with zeros to a multiple of
    this length, so that tracks of other lengths share graphs; the stems are
    cropped back. Only the last chunk's context differs.
    """
    if tail_mode not in ("exact", "uniform"):
        raise ValueError(f"unknown tail_mode {tail_mode!r}")
    if transfer_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
    if not transition_power >= 1:
        raise ValueError("transition_power < 1 leads to weird behavior.")
    if rng is None:
        rng = _random  # the module acts as a Random instance (reference parity)
    if mix.ndim != 3 or mix.shape[0] != 1:
        raise ValueError(f"the device engine takes one (1, C, L) track, got {mix.shape}")
    models, weights = _members(model)
    first = models[0]
    device = _model_device(models)
    devices = [torch.device(d) for d in devices] if devices else None
    if prestaged and (devices or group is not None or length_bucket_seconds):
        raise ValueError("prestaged buffers are staged at the exact track length on the "
                         "model's device; they cannot be combined with length bucketing, "
                         "several devices or a process group")
    orig_length = mix.shape[-1]
    if length_bucket_seconds is not None:
        if length_bucket_seconds <= 0:
            raise ValueError(
                f"length_bucket_seconds must be positive, got {length_bucket_seconds}")
        if prestaged:
            raise ValueError("prestaged buffers are staged at the exact track length; "
                             "they cannot be combined with length bucketing")
        bucket = int(length_bucket_seconds * first.samplerate)
        target_len = -(-orig_length // bucket) * bucket
        if target_len != orig_length:
            mix = np.pad(mix, [(0, 0), (0, 0), (0, target_len - orig_length)])

    def uniform_target(m: Model) -> bool:
        return tail_mode == "uniform" or (m.kind == "htdemucs"
                                          and (m.uses_train_segment or segment is not None))

    S, C, L = len(first.sources), first.audio_channels, mix.shape[-1]
    max_shift = int(0.5 * first.samplerate) if shifts else 0
    n_passes = max(1, shifts)
    if progress:
        print(f"device engine: {len(models)} model(s) x {n_passes} shift pass(es) on "
              f"{device}", flush=True)
    homogeneous = all(m.kind == first.kind and m.cfg == first.cfg for m in models)
    # the JAX engine's routing (engine.py:955-987): a homogeneous bag of
    # uniform-target members fans out when its members divide the devices
    fan_out = (devices is not None and len(models) > 1 and homogeneous
               and len(devices) % len(models) == 0 and all(map(uniform_target, models)))
    if group is not None:
        world, me = dist.get_world_size(group), dist.get_rank(group)
        if not (homogeneous and all(map(uniform_target, models))):
            raise ValueError("the fan-out over a process group takes a homogeneous bag of "
                             "uniform-target members")
        mine = [m * world // len(models) == me for m in range(len(models))]
    else:
        mine = [True] * len(models)
    per_member = len(devices) // len(models) if fan_out else 0
    track_dev: dict = dict(prestaged) if prestaged else {}
    accum = torch.zeros(S, C, L, device=device)
    totals = np.zeros(S)
    for index, (member, member_weights) in enumerate(zip(models, weights)):
        seg_f = segment if segment is not None else member.segment
        segment_length = int(first.samplerate * seg_f)
        stride = int((1 - overlap) * segment_length)
        target = member.leaf_target(segment_length, segment)
        # every rank draws every member's offsets: the one-process order
        offsets = [rng.randint(0, max_shift) if shifts else 0 for _ in range(n_passes)]
        totals += np.asarray(member_weights, np.float64) * n_passes
        if not mine[index]:
            continue
        run_on, member_devices = device, devices
        if fan_out:  # member index's group of devices; its stems on the group's first
            member_devices = devices[index * per_member: (index + 1) * per_member]
            run_on = member_devices[0]
        with _on(run_on):
            if run_on != device:
                member = Model(member.kind, member.cfg, replica(member.module, run_on))
            key = (segment_length, target) + ((run_on,) if run_on != device else ())
            if key not in track_dev:
                track_dev[key] = _upload_track(mix[0], C, L, target, max_shift, run_on)
            pass_fn = _make_pass_body(member, L, max_shift, segment_length, target, stride,
                                      batch_size, transition_power, segment,
                                      exact_tails=not uniform_target(member),
                                      devices=member_devices)
            # w * r per pass, and the shift count folded into the final division
            # (totals * n): one unit-weight model then gives the host's
            # sum-then-divide bit for bit at any shift count
            scale = _device_constant(tuple(float(w) for w in member_weights), run_on)
            target_accum = accum if run_on == device else torch.zeros(S, C, L, device=run_on)
            for offset in offsets:
                pass_fn(track_dev[key], offset, target_accum, scale)
        if target_accum is not accum:
            accum += target_accum.to(device)
    if group is not None:
        dist.all_reduce(accum, group=group)
    totals_dev = _device_constant(tuple(np.float32(totals).tolist()), device)
    result = _final_body(accum, totals_dev, transfer_dtype)
    return _start_fetch(result), transfer_dtype, orig_length
