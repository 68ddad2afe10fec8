"""Multi-head attention, plain PyTorch (port of ``demucs_tpu/ops/attention.py``).

This is the plain version of kernel K3 (``demucs_tpu_torch.kernels.attention``):
the CPU path and the kernel's oracle on the card. Behavioral reference:
``torch.nn.MultiheadAttention`` as Demucs uses it (q scaled by
``head_dim ** -0.5``, softmax over keys).

bf16 inputs follow the JAX package's dense path rounding for rounding: q is
scaled in its own dtype (the scale rounded to it first, as a JAX weak-typed
scalar is), the scores and the softmax are fp32, the weights are cast to v's
dtype, P V accumulates in fp32 and the output is cast to q's dtype. A
product of two bf16 values is exact in fp32, so the fp32 products of the
upcast operands are the bf16 products with fp32 accumulation.
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
        q: ``(B, Tq, C)``; k/v: ``(B, Tk, C)``, all fp32 or all bf16.
        mask: optional boolean keep-mask ``(Tq, Tk)`` (or broadcastable to
            ``(B, H, Tq, Tk)``); masked-out scores get -inf, so a row with
            no kept key gives NaN.
    Returns:
        ``(B, Tq, C)`` in q's dtype (before the output projection).
    """
    B, Tq, C = q.shape
    head_dim = C // num_heads
    scale = 1.0 / math.sqrt(head_dim)
    if q.dtype != torch.float32:
        scale = torch.tensor(scale, dtype=q.dtype).item()
    qh = _split_heads(q, num_heads) * scale
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        keep = mask.to(device=scores.device, dtype=torch.bool)
        scores = scores.masked_fill(~keep, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = (weights.float() @ vh.float()).to(q.dtype)
    return out.permute(0, 2, 1, 3).reshape(B, Tq, C)
