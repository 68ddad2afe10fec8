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

Train-time dropout: the attention probabilities take the Pallas kernel's
hashed dropout (:func:`dropout_keep`, the pattern of
``demucs_tpu/ops/pallas/attention.py::_attn_kernel``), so the CPU path and
K3 on the card drop the same scores for the same seed; the blocks' dropout
is :func:`apply_dropout`, inverted dropout drawn from a generator.
"""

from __future__ import annotations

import math

import torch

from demucs_tpu_torch.parallel import rows

__all__ = ["multihead_attention", "dropout_keep", "apply_dropout"]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, C = x.shape
    return x.reshape(B, T, num_heads, C // num_heads).permute(0, 2, 1, 3)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, const: int) -> torch.Tensor:
    """``x * const mod 2**32`` for int64 ``x`` in [0, 2**32): two products of
    at most 48 bits, so nothing overflows int64."""
    lo, hi = const & 0xFFFF, const >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def dropout_keep(batch_heads: int, Tq: int, Tk: int, rate: float, seed: int,
                 device=None) -> torch.Tensor:
    """The hashed dropout's keep-mask ``(batch_heads, Tq, Tk)``, bool, of the
    Pallas kernel (``_attn_kernel``, ``_uniform_hash``): the score of query
    row ``r`` and key ``j`` in batch-head ``bh = b * H + h`` is kept where
    murmur3's finalizer of ``r * 0x9E3779B1 ^ j * 0x85EBCA77 ^ (seed + bh *
    0x27D4EB2F)`` (uint32), shifted right by 8 and scaled by 2**-24, is at
    least ``rate`` (in fp32). ``csrc/attention_dropout.cuh`` is the card's."""
    rows = _mul32(torch.arange(Tq, dtype=torch.int64, device=device), 0x9E3779B1)
    cols = _mul32(torch.arange(Tk, dtype=torch.int64, device=device), 0x85EBCA77)
    base = rows[:, None] ^ cols[None, :]
    threshold = torch.tensor(rate, dtype=torch.float32)
    keep = torch.empty(batch_heads, Tq, Tk, dtype=torch.bool, device=device)
    for bh in range(batch_heads):
        x = base ^ ((seed + bh * 0x27D4EB2F) & _M32)
        x = x ^ (x >> 16)
        x = _mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
        keep[bh] = (x >> 8).to(torch.float32) * (2.0 ** -24) >= threshold.to(x.device)
    return keep


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (``demucs_tpu/ops/attention.py::apply_dropout``):
    ``x * keep / (1 - rate)``, ``keep`` drawn on ``x``'s device from a
    generator there seeded by one draw of ``generator`` (a CPU generator: a
    step's draws all come from it, never from the global RNG); under
    ``parallel.rows.global_rows`` the mask of the global batch, cut to this
    rank's rows. Identity when
    ``generator`` is None (eval) or ``rate <= 0``."""
    if generator is None or rate <= 0.0:
        return x
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    local = torch.Generator(device=x.device).manual_seed(seed)
    # a data-parallel rank draws the global batch's mask and keeps its rows
    offset, total = rows.current(x.shape[0])
    keep = torch.rand((total, *x.shape[1:]), device=x.device,
                      generator=local)[offset: offset + x.shape[0]] >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, mask: torch.Tensor | None = None,
                        dropout: float = 0.0, dropout_seed: int | None = None,
                        head_dim: int | None = None) -> torch.Tensor:
    """Scaled dot-product attention over already-projected q/k/v.

    Args:
        q: ``(B, Tq, C)``; k/v: ``(B, Tk, C)``, all fp32 or all bf16.
        mask: optional boolean keep-mask ``(Tq, Tk)`` (or broadcastable to
            ``(B, H, Tq, Tk)``); masked-out scores get -inf, so a row with
            no kept key gives NaN.
        dropout, dropout_seed: train-time dropout of the probabilities at
            that rate, the scores of :func:`dropout_keep` kept and scaled by
            ``1 / (1 - dropout)``.
        head_dim: the dim whose ``head_dim ** -0.5`` scales q, where the
            heads carry zero channels past it (K3's padded path); else
            ``C // num_heads``.
    Returns:
        ``(B, Tq, C)`` in q's dtype (before the output projection).
    """
    B, Tq, C = q.shape
    scale = 1.0 / math.sqrt(head_dim or C // num_heads)
    if q.dtype not in (torch.float32, torch.float64):
        scale = torch.tensor(scale, dtype=q.dtype).item()
    acc = torch.promote_types(q.dtype, torch.float32)  # float64: a reference run
    qh = _split_heads(q, num_heads) * scale
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    scores = qh.to(acc) @ kh.to(acc).transpose(-1, -2)
    if mask is not None:
        keep = mask.to(device=scores.device, dtype=torch.bool)
        scores = scores.masked_fill(~keep, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(vh.dtype)
    if dropout > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout > 0 requires dropout_seed")
        keep = dropout_keep(B * num_heads, Tq, k.shape[1], dropout, dropout_seed,
                            scores.device).view(B, num_heads, Tq, -1)
        weights = weights * keep.to(weights.dtype) / (1.0 - dropout)
    out = (weights.to(acc) @ vh.to(acc)).to(q.dtype)
    return out.permute(0, 2, 1, 3).reshape(B, Tq, C)
