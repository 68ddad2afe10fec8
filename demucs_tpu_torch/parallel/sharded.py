"""Separation over several devices (port of ``demucs_tpu/parallel/sharded.py``).

The reference's only parallel axis is data-parallel; here the overlap-add
segments are the data-parallel unit: the device engine splits each pass's
segment batch over a list of devices (the JAX package's ``(dp,)`` mesh), and
fans a bag's members out over them (``inference/engine.py``). A device list
takes the place of a mesh.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_devices", "default_platform", "auto_devices", "sharded_apply_model"]


def default_platform() -> str:
    """``"cuda"`` where a card is visible, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_devices(n_devices: tp.Optional[int] = None,
                 platform: tp.Optional[str] = None) -> tp.List[torch.device]:
    """The first ``n_devices`` devices of ``platform`` (default: the default
    platform): the local cards, or ``n_devices`` entries of the one CPU (its
    forwards then run one after the other, which the tests use). Asking for
    more cards than there are raises."""
    platform = platform or default_platform()
    if platform == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if platform != "cuda":
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n > count or n < 1:
        raise RuntimeError(f"{n} CUDA device(s) asked for, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def auto_devices(model_device=None) -> tp.Optional[tp.List[torch.device]]:
    """Every local card when there are several and the model is on a card,
    else None (one card, the CPU, or a rank of a process group of several):
    ``apply_model`` uses them without flags. In a multi-process run each
    rank separates its own tracks on its own card (the JAX package's
    ``auto_mesh`` keeps to the process's own chips), so no rank takes the
    cards of the others."""
    if model_device is not None and torch.device(model_device).type != "cuda":
        return None
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return None
    if not torch.cuda.is_available() or torch.cuda.device_count() <= 1:
        return None
    return make_devices(platform="cuda")


def sharded_apply_model(model, mix: np.ndarray, *, devices=None, **kwargs) -> np.ndarray:
    """``device_apply_model`` with the segments (or a bag's members) over
    ``devices`` (default: every local card)."""
    from demucs_tpu_torch.inference.engine import device_apply_model

    if devices is None:
        devices = make_devices()
    return device_apply_model(model, mix, devices=devices, **kwargs)
