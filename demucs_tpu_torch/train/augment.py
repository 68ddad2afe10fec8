"""Batch augmentations on device tensors with an explicit generator (port of
``demucs_tpu/train/augment.py``; behavioral reference ``demucs/augment.py``).

Shift, FlipChannels, FlipSign, Scale and Remix on ``wav (B, S, C, T)``
stacked sources. Each draws its few numbers (offsets, flips, gains, a
permutation, whether to apply) from a CPU ``torch.Generator`` passed in,
never from the global RNG, and applies them on the batch's device; each
``*_with`` function applies given draws (the tests hand them the JAX
package's).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

__all__ = ["AugmentConfig", "shift_aug", "flip_channels_aug", "flip_sign_aug", "scale_aug",
           "remix_aug", "make_augment"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The ``augment`` section's defaults (conf/config.yaml)."""

    shift: int = 8192
    shift_same: bool = False
    flip: bool = True
    scale_proba: float = 1.0
    scale_min: float = 0.25
    scale_max: float = 1.25
    remix_proba: float = 1.0
    remix_group_size: int = 4


def shift_with(wav: torch.Tensor, offsets: torch.Tensor, length: int) -> torch.Tensor:
    """The window ``[offset, offset + length)`` of each (batch, source) row;
    ``offsets (B, S)`` or ``(B, 1)`` (the same for every source)."""
    B, S, C, T = wav.shape
    offsets = offsets.to(wav.device).expand(B, S)
    index = offsets[:, :, None, None] + torch.arange(length, device=wav.device)
    return torch.gather(wav, 3, index.expand(B, S, C, length))


def shift_aug(wav: torch.Tensor, shift: int, same: bool, generator: torch.Generator,
              train: bool = True) -> torch.Tensor:
    """Random time shift by up to ``shift`` samples (augment.py:14-35): output
    length ``T - shift``; eval mode truncates."""
    B, S, C, T = wav.shape
    if shift <= 0:
        return wav
    length = T - shift
    if not train:
        return wav[..., :length]
    offsets = torch.randint(0, shift, (B, 1 if same else S), generator=generator)
    return shift_with(wav, offsets, length)


def flip_channels_with(wav: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """Swap the channels of the (batch, source) rows where ``left (B, S)`` is 1."""
    left = left.to(wav.device).view(*left.shape, 1, 1)
    return torch.where(left == 1, wav.flip(2), wav)


def flip_channels_aug(wav: torch.Tensor, generator: torch.Generator,
                      train: bool = True) -> torch.Tensor:
    """Random left/right swap per (batch, source) (augment.py:38-49)."""
    B, S, C, T = wav.shape
    if not train or C != 2:
        return wav
    return flip_channels_with(wav, torch.randint(0, 2, (B, S), generator=generator))


def flip_sign_with(wav: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """``wav * (2 signs - 1)`` per (batch, source), ``signs (B, S)`` of 0 and 1."""
    signs = signs.to(device=wav.device, dtype=wav.dtype).view(*signs.shape, 1, 1)
    return wav * (2 * signs - 1)


def flip_sign_aug(wav: torch.Tensor, generator: torch.Generator,
                  train: bool = True) -> torch.Tensor:
    """Random sign flip per (batch, source) (augment.py:52-61)."""
    B, S, C, T = wav.shape
    if not train:
        return wav
    return flip_sign_with(wav, torch.randint(0, 2, (B, S), generator=generator))


def scale_aug(wav: torch.Tensor, proba: float, lo: float, hi: float,
              generator: torch.Generator, train: bool = True) -> torch.Tensor:
    """Random gain in ``[lo, hi)`` per (batch, source), applied to the whole
    batch with probability ``proba`` (augment.py:98-111)."""
    B, S, C, T = wav.shape
    if not train or proba <= 0:
        return wav
    scales = lo + (hi - lo) * torch.rand((B, S, 1, 1), generator=generator)
    if float(torch.rand((), generator=generator)) >= proba:
        return wav
    return wav * scales.to(device=wav.device, dtype=wav.dtype)


def remix_with(wav: torch.Tensor, perm: torch.Tensor, group_size: int) -> torch.Tensor:
    """Sources shuffled within groups of ``group_size`` batch items:
    ``out[g, i, s] = wav[g, perm[g, i, s], s]``, ``perm (groups, group_size, S)``."""
    B, S, C, T = wav.shape
    wavg = wav.reshape(B // group_size, group_size, S, C, T)
    index = perm.to(wav.device)[..., None, None].expand(*perm.shape, C, T)
    return torch.gather(wavg, 1, index).reshape(B, S, C, T)


def remix_aug(wav: torch.Tensor, proba: float, group_size: int, generator: torch.Generator,
              train: bool = True) -> torch.Tensor:
    """Shuffle sources within groups of ``group_size`` (augment.py:64-95),
    with probability ``proba``; the groups keep the mix's distribution
    independent of the batch split over processes."""
    B, S, C, T = wav.shape
    if not train or proba <= 0:
        return wav
    group_size = group_size or B
    if B % group_size != 0:
        raise ValueError(f"Batch size {B} must be divisible by group size {group_size}")
    perm = torch.argsort(torch.rand((B // group_size, group_size, S), generator=generator),
                         dim=1)
    if float(torch.rand((), generator=generator)) >= proba:
        return wav
    return remix_with(wav, perm, group_size)


def make_augment(cfg: AugmentConfig, full: bool) -> tp.Callable:
    """The train-time pipeline (solver.py:53-61): Shift, [FlipChannels,
    FlipSign], [Scale, Remix if ``full``] -> ``augment(wav, generator)``."""

    def augment(wav: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        wav = shift_aug(wav, cfg.shift, cfg.shift_same, generator)
        if cfg.flip:
            wav = flip_channels_aug(wav, generator)
            wav = flip_sign_aug(wav, generator)
        if full:
            wav = scale_aug(wav, cfg.scale_proba, cfg.scale_min, cfg.scale_max, generator)
            wav = remix_aug(wav, cfg.remix_proba, cfg.remix_group_size, generator)
        return wav

    return augment
