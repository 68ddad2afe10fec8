"""Decoder of diffq-quantized checkpoints (port of the decode side of
``demucs_tpu/zoo/diffq.py``; the format is described in
``docs/diffq_format.md``).

A quantized state (``state["__quantized"]``, ``demucs/states.py:96-107``)
holds no parameter names::

    {"__quantized": True,
     "quantized": [entry, ...],   # one per large parameter, in order
     "others": [tensor, ...],     # the small ones as they are (fp32)
     "float16": [tensor, ...],    # the small ones, when init_kwargs float16
     "meta": {"klass": ..., "init_kwargs": {"min_size": MB, "group_size": n, ...}}}

diffq walks the model's parameters in the reference's registration order and
splits them at ``min_size`` MB. :func:`param_order` takes the port's own
module's ``named_parameters()``: HDemucs and Demucs v2 register their
children in the reference's order; HTDemucs registers ``tencoder`` before
``decoder`` and ``norm_in`` before ``position_embeddings``, so its names are
put in the reference's order of those groups (a stable sort, as the JAX
package sorts its parameter tree). An entry is ``(levels,
scales[, bits])``, decoded group-wise as ``levels / (2**bits - 1) * (max -
min) + min``, or ``levels * scale / (2**(bits-1) - 1)`` for signed levels
with one scale per group. The quantize side (:func:`quantize_entry`,
:func:`quantize_state`) writes the affine layout with per-group bits; the
trainer's export (``train/quantize.py::hard_quantized_state``) uses it.
"""

from __future__ import annotations

import fnmatch
import typing as tp

import numpy as np
import torch

from demucs_tpu_torch.models.registry import build_module

__all__ = ["param_order", "dequantize_entry", "dequantize_state", "quantize_entry",
           "quantize_state", "MIN_SIZE_MB", "GROUP_SIZE"]

MIN_SIZE_MB = 0.2  # conf/config.yaml:287
GROUP_SIZE = 8  # conf/config.yaml:288

# The reference constructors' registration order of the top-level modules
# (htdemucs.py:244-418, hdemucs.py:479-582, demucs.py:308-309) and of the
# cross transformer's children (transformer.py:582-605).
_GROUP_ORDER = ("encoder", "decoder", "tencoder", "tdecoder", "freq_emb", "channel_upsampler",
                "channel_downsampler", "channel_upsampler_t", "channel_downsampler_t",
                "crosstransformer", "lstm")
_TRANSFORMER_ORDER = ("position_embeddings", "norm_in", "norm_in_t", "layers", "layers_t")


def param_order(kind: str, cfg) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    """``(name, shape)`` of every parameter in the reference's registration
    order (the module is built on the meta device: no memory, no weights)."""
    with torch.device("meta"):
        module = build_module(kind, cfg)

    def rank(item) -> tp.Tuple[int, int]:
        parts = item[0].split(".")
        sub = _TRANSFORMER_ORDER.index(parts[1]) if parts[0] == "crosstransformer" else 0
        return _GROUP_ORDER.index(parts[0]), sub

    named = [(name, tuple(p.shape)) for name, p in module.named_parameters()]
    return sorted(named, key=rank)


def _partition(order, min_size_mb: float, exclude: tp.Sequence[str] = ()):
    """(quantized, as-is) name lists, as diffq splits them: quantized when the
    element count STRICTLY exceeds ``min_size_mb`` MB of fp32 and no
    ``exclude`` pattern matches the dotted or the leaf name."""
    min_params = int(min_size_mb * 2**20) // 4
    big, small = [], []
    for name, shape in order:
        leaf = name.rsplit(".", 1)[-1]
        excluded = any(fnmatch.fnmatch(name, pat) or fnmatch.fnmatch(leaf, pat)
                       for pat in exclude)
        numel = int(np.prod(shape)) if shape else 1
        (small if numel <= min_params or excluded else big).append((name, shape))
    return big, small


def _entry_bits(entry, init_kwargs) -> np.ndarray:
    if len(entry) == 3:
        return np.asarray(entry[2], dtype=np.float64)
    return np.asarray(float(init_kwargs.get("bits", 8)))


def dequantize_entry(entry, shape, init_kwargs) -> np.ndarray:
    levels = np.asarray(entry[0])
    scales = entry[1]
    bits = _entry_bits(entry, init_kwargs)
    if bits.ndim == 1:
        bits = bits[:, None]
    lv = levels.astype(np.float64)
    if isinstance(scales, (tuple, list)) and len(scales) == 2:
        mn = np.asarray(scales[0], np.float64)
        mx = np.asarray(scales[1], np.float64)
        out = lv / (2.0**bits - 1.0) * (mx - mn) + mn
    else:
        sc = np.asarray(scales, np.float64)
        if sc.ndim >= 2 and sc.shape[-1] == 2 and levels.shape[-1] != 2:
            mn, mx = sc[..., :1], sc[..., 1:]
            out = lv / (2.0**bits - 1.0) * (mx - mn) + mn
        elif np.issubdtype(levels.dtype, np.signedinteger):
            out = lv * sc / (2.0 ** (bits - 1.0) - 1.0)  # symmetric: scale = group max |w|
        else:
            raise NotImplementedError(
                "unrecognized diffq entry layout "
                f"(levels {levels.dtype}{levels.shape}, scales "
                f"{getattr(sc, 'dtype', type(scales))}{getattr(sc, 'shape', '')}); "
                "docs/diffq_format.md lists the layouts this decoder reads")
    return out.astype(np.float32).reshape(shape)


def dequantize_state(state: dict, kind: str, cfg) -> tp.Dict[str, np.ndarray]:
    """A ``__quantized`` state -> ``{dotted name: float32 array}``."""
    meta = state.get("meta") or {}
    init_kwargs = dict(meta.get("init_kwargs") or {})
    init_kwargs.pop("model", None)
    min_size = float(init_kwargs.get("min_size", MIN_SIZE_MB))
    exclude = tuple(init_kwargs.get("exclude") or ())
    use_fp16 = bool(init_kwargs.get("float16", False))

    big, small = _partition(param_order(kind, cfg), min_size, exclude)
    quantized = list(state.get("quantized") or ())
    passthrough = list(state.get("float16" if use_fp16 else "others") or ())
    if len(quantized) != len(big) or len(passthrough) != len(small):
        raise ValueError(
            f"diffq state does not line up with the {kind} parameter walk: "
            f"{len(quantized)} quantized entries for {len(big)} large params, "
            f"{len(passthrough)} passthrough for {len(small)} small params "
            f"(min_size={min_size} MB). See docs/diffq_format.md.")
    flat: tp.Dict[str, np.ndarray] = {}
    for (name, shape), entry in zip(big, quantized):
        flat[name] = dequantize_entry(entry, shape, init_kwargs)
    for (name, shape), tensor in zip(small, passthrough):
        arr = np.asarray(tensor)
        if arr.shape != shape:
            raise ValueError(f"passthrough tensor shape {arr.shape} != expected {shape} "
                             f"for {name}")
        flat[name] = arr.astype(np.float32)
    return flat


def quantize_entry(arr: np.ndarray, group_size: int, bits: tp.Union[int, np.ndarray]):
    """Group-wise uniform quantization over each group's [min, max] (the
    encoder of :func:`dequantize_entry`'s affine layout) -> ``(levels, scales,
    bits)``: levels uint8 (bits <= 8) or int16, scales fp32 ``(G, 2) = [min,
    max]``, bits uint8 per group. ``bits``: a scalar or one per group (DiffQ's
    learned depths); ``group_size`` 0 makes the whole tensor one group."""
    if group_size == 2:
        # (G, 2) levels read as the packed [min, max] scales layout
        raise ValueError("group_size=2 produces an ambiguous container layout; use "
                         "group_size >= 3 (default 8)")
    raw_bits = np.asarray(bits)
    if raw_bits.max() > 15 or raw_bits.min() < 1:
        # int16 levels hold at most 2**15 - 1 steps; more would wrap silently
        raise ValueError(f"bits must be in [1, 15], got {bits}")
    flat = arr.reshape(-1, group_size) if group_size else arr.reshape(1, -1)
    bits_arr = np.broadcast_to(raw_bits.astype(np.uint8), (flat.shape[0],)).copy()
    nlev = (2.0 ** bits_arr.astype(np.float64) - 1.0)[:, None]
    mn = flat.min(axis=-1, keepdims=True)
    mx = flat.max(axis=-1, keepdims=True)
    span = np.where(mx > mn, mx - mn, 1.0)
    levels = np.round((flat - mn) / span * nlev)
    levels = levels.astype(np.uint8 if bits_arr.max() <= 8 else np.int16)
    scales = np.concatenate([mn, mx], axis=-1).astype(np.float32)
    return levels, scales, bits_arr


def quantize_state(flat_state: tp.Mapping[str, np.ndarray], kind: str, cfg, *,
                   min_size_mb: float = MIN_SIZE_MB, group_size: int = GROUP_SIZE,
                   bits: int = 8) -> dict:
    """A ``__quantized`` container of a flat fp32 state at ``bits`` bits."""
    big, small = _partition(param_order(kind, cfg), min_size_mb)
    quantized = []
    for name, _shape in big:
        arr = np.asarray(flat_state[name], np.float32)
        if group_size and arr.size % group_size:
            raise ValueError(f"{name}: numel {arr.size} not divisible by group_size "
                             f"{group_size}")
        quantized.append(quantize_entry(arr, group_size, bits))
    return {
        "__quantized": True,
        "quantized": quantized,
        "others": [np.asarray(flat_state[name], np.float32) for name, _ in small],
        "float16": [],
        "meta": {"klass": "DiffQuantizer",
                 "init_kwargs": {"min_size": min_size_mb, "group_size": group_size}},
    }
