"""Native checkpoints: ``.dmx`` = zip of ``meta.json`` + ``params.npz``
(port of the float-parameter part of ``demucs_tpu/zoo/native.py``).

The archive holds the model kind, its config as JSON and the flat parameters
(fp16 by default, as the released zoo ships them). The JAX package and the
port read and write the same files. Quantized archives (``quant.npz``) come
with a later slice and raise.
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

from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.zoo.convert import flat_state, load_flat_state

__all__ = ["serialize_model", "save_model", "load_native_model", "get_model",
           "ModelLoadingError"]


class ModelLoadingError(RuntimeError):
    pass


def serialize_model(model: Model, training_args: tp.Optional[dict] = None,
                    half: bool = True) -> bytes:
    """Model -> bytes of the ``.dmx`` container (fp16 weights by default)."""
    meta = {"kind": model.kind, "config": dataclasses.asdict(model.cfg),
            "training_args": training_args or {}, "format_version": 1}
    arrays = {}
    for name, arr in flat_state(model.module).items():
        arrays[name] = arr.astype(np.float16) if half and arr.dtype == np.float32 else arr
    npz = io.BytesIO()
    np.savez(npz, **arrays)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        zf.writestr("params.npz", npz.getvalue())
    return buf.getvalue()


def save_model(model: Model, path, training_args: tp.Optional[dict] = None,
               half: bool = True) -> Path:
    path = Path(path)
    path.write_bytes(serialize_model(model, training_args, half))
    return path


def _config(kind: str, cfg_dict: dict):
    if kind != "htdemucs":
        raise ModelLoadingError(f"model kind {kind!r} comes with a later slice of the port")
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig

    clean = {}
    for key, value in cfg_dict.items():
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        clean[key] = value
    return HTDemucsConfig(**clean)


def load_native_model(path, device="cuda") -> Model:
    """Read a float-parameter ``.dmx`` into a ``Model`` on ``device`` (eval mode)."""
    from demucs_tpu_torch import resolve_device
    from demucs_tpu_torch.models.htdemucs import HTDemucs

    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        if "quantized" in meta:
            raise ModelLoadingError(
                f"{path}: quantized .dmx archives come with a later slice of the port")
        with zf.open("params.npz") as f:
            arrays = dict(np.load(io.BytesIO(f.read())))
    cfg = _config(meta["kind"], meta["config"])
    module = load_flat_state(HTDemucs(cfg), arrays)
    return Model(meta["kind"], cfg, module.to(dev).eval())


def get_model(name: str, repo, device="cuda") -> Model:
    """Load ``<repo>/<name>.dmx`` (or ``<name>-<8 hex of its sha256>.dmx``).

    Only local ``.dmx`` files are read in this slice: no remote zoo, no
    ``.th`` pickles, no bag ``.yaml`` files.
    """
    if repo is None:
        raise ModelLoadingError("the port loads local .dmx files only: pass a repo folder")
    root = Path(repo)
    if not root.is_dir():
        raise ModelLoadingError(f"{root} must exist and be a directory.")
    plain = root / f"{name}.dmx"
    if plain.is_file():
        return load_native_model(plain, device)
    for file in sorted(root.glob(f"{name}-*.dmx")):
        stem, _, tail = file.stem.rpartition("-")
        if stem == name and len(tail) == 8:
            digest = hashlib.sha256(file.read_bytes()).hexdigest()[:8]
            if digest != tail:
                raise ModelLoadingError(f"Invalid checksum for file {file}, expected "
                                        f"{tail} but got {digest}")
            return load_native_model(file, device)
    raise ModelLoadingError(f"Could not find pre-trained model {name} in {root}.")
