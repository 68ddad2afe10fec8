"""NN primitives with the weight layouts of the reference checkpoints
(port of ``demucs_tpu/ops/nn.py``).

- conv weights ``(out, in/groups, *kernel)``; transposed conv weights
  ``(in, out/groups, *kernel)``; linear weights ``(out, in)`` — the layouts
  of ``torch.nn`` itself, so these are thin wrappers over
  ``torch.nn.functional`` (cuDNN and cuBLAS on the card). The JAX package's
  phase-decomposed transposed convolution was a TPU lowering choice; here
  ``F.conv_transpose*`` computes the same function.
- ``gelu`` is the exact erf form; ``group_norm``/``layer_norm`` use eps 1e-5
  and the biased variance; ``std_unbiased`` uses Bessel's correction.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["conv1d", "conv2d", "conv_transpose1d", "conv_transpose2d", "linear",
           "group_norm", "layer_norm", "glu", "gelu", "std_unbiased", "embedding"]

_Int2 = tp.Union[int, tp.Tuple[int, int]]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def glu(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Gated linear unit along ``axis``."""
    return F.glu(x, dim=axis)


def std_unbiased(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    """Standard deviation with Bessel's correction (``Tensor.std``)."""
    return torch.std(x, dim=axis, keepdim=keepdims, correction=1)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution. ``x (B, C, L)``, ``w (O, I/groups, K)``."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None, *,
           stride: _Int2 = 1, padding: _Int2 = 0, dilation: _Int2 = 1,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution. ``x (B, C, H, W)``, ``w (O, I/groups, Kh, Kw)``."""
    return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: tp.Optional[torch.Tensor] = None, *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """1-D transposed convolution. ``w (I, O, K)``; out_len = (L-1)*stride - 2*padding + K."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: tp.Optional[torch.Tensor] = None, *, stride: _Int2 = 1,
                     padding: _Int2 = 0) -> torch.Tensor:
    """2-D transposed convolution. ``w (I, O, Kh, Kw)``."""
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)


def linear(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine map on the last axis. ``w (out, in)``."""
    return F.linear(x, w, b)


def group_norm(x: torch.Tensor, num_groups: int, w: tp.Optional[torch.Tensor] = None,
               b: tp.Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``x (B, C, *spatial)`` with biased variance."""
    return F.group_norm(x, num_groups, w, b, eps=eps)


def layer_norm(x: torch.Tensor, w: tp.Optional[torch.Tensor] = None,
               b: tp.Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis."""
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=eps)


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; ``table (num_embeddings, dim)``."""
    return F.embedding(ids, table)
