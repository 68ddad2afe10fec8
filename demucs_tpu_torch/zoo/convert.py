"""Carry flat checkpoints (``{dotted name: array}``) into the port's modules.

The JAX package's parameter trees and the reference's state dicts share one
set of dotted names (for example ``encoder.0.dconv.layers.1.3.weight``), and
the port's module attributes reproduce them, so loading is a dtype promotion
plus ``load_state_dict(strict=True)``: a missing, extra or mis-shaped name
raises.

Reference ``.th`` packages (``{klass, args, kwargs, state}``, read by
``zoo/thpickle.py``) also carry the model class's name and constructor
arguments: :func:`config_from_torch_kwargs` maps them to the port's config
classes, as ``demucs_tpu/zoo/torch_load.py:56-108`` does, and
:func:`load_th_model` builds the model (diffq states dequantized, Demucs v2's
legacy names renamed).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from demucs_tpu_torch.models.registry import FAMILIES, Model, build_module

__all__ = ["load_flat_state", "flat_state", "config_from_torch_kwargs", "load_th_model",
           "model_from_flat"]


def load_flat_state(module: torch.nn.Module, flat: tp.Mapping[str, tp.Any]) -> torch.nn.Module:
    """Load ``{dotted name: array}`` into ``module`` strictly.

    float16 and float64 arrays are promoted to float32 (released weights are
    fp16; the models compute in fp32), as ``demucs_tpu.zoo.torch_load.nest_state``
    does.
    """
    state = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        if arr.dtype in (np.float16, np.float64):
            arr = arr.astype(np.float32)
        state[name] = torch.tensor(arr)  # a copy: the source may be read-only
    module.load_state_dict(state, strict=True)
    return module


def flat_state(module: torch.nn.Module) -> tp.Dict[str, np.ndarray]:
    """``{dotted name: float32 array}`` of a module's parameters and buffers
    (a bf16 stage's parameters widened exactly: numpy has no bf16)."""
    return {name: (t.float() if t.is_floating_point() else t).detach().cpu().numpy()
            for name, t in module.state_dict().items()}


_MODEL_CLASS_NAMES = {"HTDemucs": "htdemucs", "HDemucs": "hdemucs", "Demucs": "demucs",
                      "WDemucs": "hdemucs"}


def config_from_torch_kwargs(klass_name: str, args: tuple, kwargs: dict):
    """The port's config for the reference's captured constructor arguments
    -> ``(config, kind)``; keywords the config does not know are dropped
    (``demucs/states.py:50-80``)."""
    kind = _MODEL_CLASS_NAMES.get(klass_name)
    if kind is None:
        raise ValueError(f"Unknown model class {klass_name!r}")
    cls, _ = FAMILIES[kind]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = dict(kwargs)
    if args:
        # every family's signature starts (sources, audio_channels, channels, ...)
        positional = ("sources", "audio_channels", "channels")
        if len(args) > len(positional):
            raise ValueError(f"checkpoint has {len(args)} positional init args; only "
                             f"{positional} are mapped")
        kw.update(zip(positional, args))
    clean = {}
    for key, value in kw.items():
        if key not in fields:
            continue
        if isinstance(value, list):
            value = tuple(value)
        if key == "segment":
            value = float(value)
        clean[key] = value
    if "sources" in clean:
        clean["sources"] = tuple(clean["sources"])
    return cls(**clean), kind


def _demucs_v2_rename_shim(state: dict, depth: int) -> dict:
    """Previous-generation Demucs v2 models stored the rewrite conv at
    Sequential index 2, current ones at 3 (``demucs/demucs.py:438-447``)."""
    state = dict(state)
    for idx in range(depth):
        for a in ("encoder", "decoder"):
            for b in ("bias", "weight"):
                new, old = f"{a}.{idx}.3.{b}", f"{a}.{idx}.2.{b}"
                if old in state and new not in state:
                    state[new] = state.pop(old)
    return state


def model_from_flat(kind: str, cfg, flat: tp.Mapping[str, tp.Any]) -> Model:
    """A ``Model`` on the CPU, in eval mode, holding ``flat`` (strictly loaded)."""
    return Model(kind, cfg, load_flat_state(build_module(kind, cfg), flat).eval())


def load_th_model(path) -> Model:
    """A reference ``.th`` package -> ``Model`` on the CPU.

    No code from the file runs (``zoo/thpickle.py``); fp16 weights are
    promoted to fp32; a diffq state (``__quantized``) is dequantized
    (``zoo/diffq.py``); Demucs v2's legacy names are renamed."""
    from demucs_tpu_torch.zoo.diffq import dequantize_state
    from demucs_tpu_torch.zoo.thpickle import read_th

    pkg = read_th(path)
    klass = pkg["klass"]
    klass_name = klass if isinstance(klass, str) else klass.__name__
    cfg, kind = config_from_torch_kwargs(klass_name, pkg.get("args", ()), pkg.get("kwargs", {}))
    state = pkg["state"]
    if state.get("__quantized"):
        flat = dequantize_state(state, kind, cfg)
    else:
        flat = {k: np.asarray(v) for k, v in state.items()}
    if kind == "demucs":
        flat = _demucs_v2_rename_shim(flat, cfg.depth)
    return model_from_flat(kind, cfg, flat)
