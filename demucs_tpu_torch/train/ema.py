"""Exponential moving average of a module's weights (port of
``demucs_tpu/train/ema.py``; behavioral reference ``demucs/ema.py:15-67``).

The average, unbiased by the count of updates, runs over the fp32 entries of
the state dict (parameters and fp32 buffers); other entries follow the live
module, as the reference's swap leaves them. :func:`swap` copies the average
into the module in place (so CUDA graphs that read the parameters by address
stay valid) and the live weights back after.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["ModelEMA", "swap"]


class ModelEMA:
    """EMA of ``module``'s state; ``update()`` after each step or epoch."""

    def __init__(self, module: torch.nn.Module, decay: float = 0.9999, unbias: bool = True):
        self.module = module
        self.decay = decay
        self.unbias = unbias
        self.count = 0.0
        self.state = {k: v.detach().clone() for k, v in module.state_dict().items()}

    @torch.no_grad()
    def update(self) -> None:
        if self.unbias:
            self.count = self.count * self.decay + 1
            w = 1.0 / self.count
        else:
            w = 1.0 - self.decay
        for key, live in self.module.state_dict().items():
            avg = self.state[key]
            if live.dtype == torch.float32:
                avg.mul_(1 - w).add_(live, alpha=w)
            else:
                avg.copy_(live)

    def state_dict(self) -> dict:
        return {"state": self.state, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        for key, value in state["state"].items():
            self.state[key].copy_(torch.as_tensor(value))


@contextlib.contextmanager
def swap(module: torch.nn.Module, state: dict):
    """Run the block with ``state`` (a state dict of ``module``'s entries,
    e.g. ``ModelEMA.state``) copied into ``module`` in place; the live weights
    are copied back after."""
    live = {k: v.detach().clone() for k, v in module.state_dict().items()}
    with torch.no_grad():
        for key, value in module.state_dict().items():
            value.copy_(state[key])
    try:
        yield
    finally:
        with torch.no_grad():
            for key, value in module.state_dict().items():
                value.copy_(live[key])
