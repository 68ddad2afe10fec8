"""Carry flat checkpoints (``{dotted name: array}``) into the port's modules.

The JAX package's parameter trees and the reference's state dicts share one
set of dotted names (for example ``encoder.0.dconv.layers.1.3.weight``), and
the port's module attributes reproduce them, so loading is a dtype promotion
plus ``load_state_dict(strict=True)``: a missing, extra or mis-shaped name
raises.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["load_flat_state", "flat_state"]


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
    """``{dotted name: float32 array}`` of a module's parameters and buffers."""
    return {name: t.detach().cpu().numpy() for name, t in module.state_dict().items()}
