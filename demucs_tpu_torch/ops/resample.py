"""Bandlimited sinc resampling (port of ``demucs_tpu/ops/resample.py``).

The windowed-sinc polyphase resampler of ``julius.resample_frac``, which the
reference uses for Demucs v2's 2x up- and down-sampling
(``demucs/demucs.py:416,432``) and for converting a track's sample rate
(``demucs/audio.py:169-172``). The kernel bank is a copy of the JAX
package's, built in float64 numpy and kept in float32; it is applied as one
strided ``F.conv1d`` (cuDNN on the card), with the edges replicated as julius
pads them.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from demucs_tpu_torch.kernels import device_cache

__all__ = ["resample_frac"]


@functools.lru_cache(maxsize=None)
def _kernels_np(old_sr: int, new_sr: int, zeros: int, rolloff: float):
    sr = min(new_sr, old_sr) * rolloff
    width = math.ceil(zeros * old_sr / sr)
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros)
        window = np.cos(t / zeros / 2 * math.pi) ** 2
        t = t * math.pi
        kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
        # each phase kernel renormalized by its own sum, as julius does: a
        # constant signal comes out exactly constant
        kernel /= kernel.sum()
        kernels.append(kernel)
    return np.stack(kernels).astype(np.float32), width


@device_cache(maxsize=8)
def _kernel_bank(old_sr: int, new_sr: int, zeros: int, rolloff: float,
                 device: torch.device) -> torch.Tensor:
    kernels, _ = _kernels_np(old_sr, new_sr, zeros, rolloff)
    return torch.from_numpy(kernels)[:, None, :].to(device)  # (new_sr, 1, K)


def resample_frac(x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> torch.Tensor:
    """Resample ``x (..., T)`` from ``old_sr`` to ``new_sr`` (only their ratio matters)."""
    gcd = math.gcd(old_sr, new_sr)
    old_sr //= gcd
    new_sr //= gcd
    if old_sr == new_sr:
        return x
    _, width = _kernels_np(old_sr, new_sr, zeros, rolloff)
    kernel = _kernel_bank(old_sr, new_sr, zeros, rolloff, x.device)
    *shape, length = x.shape
    xr = F.pad(x.reshape(-1, 1, length), (width, width + old_sr), mode="replicate")
    y = F.conv1d(xr, kernel, stride=old_sr)  # (B, new_sr, frames)
    y = y.transpose(1, 2).reshape(y.shape[0], -1)  # the phases interleaved
    target = int(Fraction(length * new_sr, old_sr))
    return y[..., :target].reshape(*shape, target)
