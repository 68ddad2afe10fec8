"""Multi-head attention, plain PyTorch (port of ``demucs_tpu/ops/attention.py``).

This is the plain version of kernel K3 (``demucs_tpu_torch.kernels.attention``):
the CPU path and the kernel's oracle on the card. Behavioral reference:
``torch.nn.MultiheadAttention`` as Demucs uses it (q scaled by
``head_dim ** -0.5``, softmax over keys).
"""

from __future__ import annotations

import math

import torch

__all__ = ["multihead_attention"]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, C = x.shape
    return x.reshape(B, T, num_heads, C // num_heads).permute(0, 2, 1, 3)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over already-projected q/k/v.

    Args:
        q: ``(B, Tq, C)``; k/v: ``(B, Tk, C)``.
        mask: optional boolean keep-mask ``(Tq, Tk)`` (or broadcastable to
            ``(B, H, Tq, Tk)``); masked-out scores get -inf, so a row with
            no kept key gives NaN.
    Returns:
        ``(B, Tq, C)`` (before the output projection).
    """
    B, Tq, C = q.shape
    head_dim = C // num_heads
    qh = _split_heads(q, num_heads) * (1.0 / math.sqrt(head_dim))
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    scores = qh @ kh.transpose(-1, -2)
    if mask is not None:
        keep = mask.to(device=scores.device, dtype=torch.bool)
        scores = scores.masked_fill(~keep, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    out = weights @ vh
    return out.permute(0, 2, 1, 3).reshape(B, Tq, C)
