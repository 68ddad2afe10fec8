"""Native checkpoints: ``.dmx`` = zip of ``meta.json`` and ``params.npz`` or
``quant.npz`` (port of ``demucs_tpu/zoo/native.py``).

The archive holds the model kind, its config as JSON, and either the flat
parameters (fp16 by default, as the released zoo ships them) or a diffq
container (``quant.npz``: ``q{i}.levels``/``.scales``/``.bits`` per quantized
entry and ``o{i}`` per other tensor, ``meta.json["quantized"]`` with the
counts and the quantizer's meta). The JAX package and the port read and
write the same files; a quantized archive is written from the trainer's
export (``train/solver.py::Solver.quantized_state``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import typing as tp
import zipfile
from pathlib import Path

import numpy as np

from demucs_tpu_torch.models.registry import FAMILIES, Model
from demucs_tpu_torch.zoo.convert import flat_state, model_from_flat

__all__ = ["serialize_model", "save_model", "save_with_checksum", "load_native_model"]


def serialize_model(model: Model, training_args: tp.Optional[dict] = None,
                    half: bool = True, quantized_state: tp.Optional[dict] = None) -> bytes:
    """Model -> bytes of the ``.dmx`` container: fp16 weights by default, or
    ``quantized_state`` (a ``__quantized`` container) in their place."""
    meta = {"kind": model.kind, "config": dataclasses.asdict(model.cfg),
            "training_args": training_args or {}, "format_version": 1}
    arrays = {}
    if quantized_state is not None:
        member = "quant.npz"
        meta["quantized"] = {"meta": dict(quantized_state["meta"]),
                             "n_entries": len(quantized_state["quantized"]),
                             "n_others": len(quantized_state["others"])}
        for i, (levels, scales, bits) in enumerate(quantized_state["quantized"]):
            arrays[f"q{i}.levels"] = np.asarray(levels)
            arrays[f"q{i}.scales"] = np.asarray(scales)
            arrays[f"q{i}.bits"] = np.asarray(bits)
        for i, other in enumerate(quantized_state["others"]):
            arrays[f"o{i}"] = np.asarray(other)
    else:
        member = "params.npz"
        for name, arr in flat_state(model.module).items():
            arrays[name] = arr.astype(np.float16) if half and arr.dtype == np.float32 else arr
    npz = io.BytesIO()
    np.savez(npz, **arrays)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        zf.writestr(member, npz.getvalue())
    return buf.getvalue()


def save_model(model: Model, path, training_args: tp.Optional[dict] = None,
               half: bool = True, quantized_state: tp.Optional[dict] = None) -> Path:
    path = Path(path)
    path.write_bytes(serialize_model(model, training_args, half, quantized_state))
    return path


def save_with_checksum(model: Model, path, training_args: tp.Optional[dict] = None,
                       half: bool = True, quantized_state: tp.Optional[dict] = None) -> Path:
    """Save as ``<stem>-<sha256[:8]><suffix>`` beside ``path``: the first 8 hex
    digits of the archive's sha256 in its name (``demucs/states.py:110-118``)."""
    content = serialize_model(model, training_args, half, quantized_state)
    path = Path(path)
    path = path.parent / f"{path.stem}-{hashlib.sha256(content).hexdigest()[:8]}{path.suffix}"
    path.write_bytes(content)
    return path


def _config(kind: str, cfg_dict: dict):
    try:
        cls, _ = FAMILIES[kind]
    except KeyError:
        raise ValueError(f"unknown model kind {kind!r}") from None
    clean = {}
    for key, value in cfg_dict.items():
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        clean[key] = value
    return cls(**clean)


def load_native_model(path, device="cuda") -> Model:
    """Read a ``.dmx`` (float or quantized) into a ``Model`` on ``device``, in eval mode."""
    from demucs_tpu_torch import resolve_device
    from demucs_tpu_torch.zoo.diffq import dequantize_state

    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        member = "quant.npz" if "quantized" in meta else "params.npz"
        with zf.open(member) as f:
            arrays = dict(np.load(io.BytesIO(f.read())))
    kind = meta["kind"]
    cfg = _config(kind, meta["config"])
    if "quantized" in meta:
        qmeta = meta["quantized"]
        state = {
            "__quantized": True,
            "quantized": [(arrays[f"q{i}.levels"], arrays[f"q{i}.scales"], arrays[f"q{i}.bits"])
                          for i in range(qmeta["n_entries"])],
            "others": [arrays[f"o{i}"] for i in range(qmeta["n_others"])],
            "meta": qmeta["meta"],
        }
        arrays = dequantize_state(state, kind, cfg)
    return model_from_flat(kind, cfg, arrays).to(dev)
