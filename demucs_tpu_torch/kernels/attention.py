"""K3: fused multi-head attention over projected q/k/v.

Replaces ``demucs_tpu/ops/pallas/attention.py`` (``flash_mha``, kernel
``_attn_kernel``) with the kernels of ``csrc/flash_mha.cu``: both products on
the H100's tensor cores (``wgmma``) in the three-term TF32 split, which keeps
fp32-level accuracy whatever ``torch.backends`` says about TF32; an online
softmax over tiles of 64 keys with fp32 accumulators; an optional
``(Tq, Tk)`` boolean keep-mask shared by batch and heads; and the -inf-safe
rescale (a fully masked row gives NaN, as the plain softmax does). Head dims
32, 48 and 64. Each launch first lays K and V out, split and with V
transposed, as the shared-memory image the products read, in a scratch
tensor. The plain version is
:func:`demucs_tpu_torch.ops.attention.multihead_attention`.

Train-time attention dropout (the Pallas kernel's hashed dropout) comes with
the training slice of the port; ``dropout > 0`` raises until then.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from demucs_tpu_torch.kernels import NoBackward, _build
from demucs_tpu_torch.ops.attention import multihead_attention

__all__ = ["flash_mha", "flash_mha_plain", "HEAD_DIMS", "KEY_TILE", "q_scale"]

HEAD_DIMS = (32, 48, 64)
KEY_TILE = 64  # keys per tile of the kernel's loop
# Query rows per block: 64 (one consumer warpgroup) or 128 (two, which overlap
# one's softmax with the other's products; the faster at every released shape
# and batch on the H100, PERF.md).
BLOCK_ROWS = 128

# The plain version of K3, used for CPU tensors and as the kernel's oracle.
flash_mha_plain = multihead_attention


def q_scale(head_dim: int) -> float:
    """The factor q is scaled by before the split: the softmax runs in base 2."""
    return math.log2(math.e) / math.sqrt(head_dim)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the layout pass reads float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_mha")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_mha_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    lib.flash_mha_f32.restype = i
    return lib


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              *, mask: torch.Tensor | None = None, dropout: float = 0.0) -> torch.Tensor:
    """Attention of ``q (B, Tq, C)`` over ``k, v (B, Tk, C)`` with ``num_heads``
    heads -> ``(B, Tq, C)`` (before the output projection).

    ``mask``: optional boolean keep-mask ``(Tq, Tk)``. A CPU tensor takes the
    plain version; a CUDA tensor launches K3 or raises.
    """
    if dropout > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice of the port")
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, mask=mask)
    B, Tq, C = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, C) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if C % num_heads:
        raise ValueError(f"{C} channels do not split into {num_heads} heads")
    d = C // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha supports head dims {HEAD_DIMS}, got {d}")
    if Tk == 0:
        raise ValueError("flash_mha needs at least one key")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"flash_mha expects float32 CUDA tensors, got {t.dtype} "
                            f"on {t.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    keep = None
    if mask is not None:
        if tuple(mask.shape) != (Tq, Tk):
            raise ValueError(f"mask {tuple(mask.shape)} is not (Tq, Tk) = {(Tq, Tk)}")
        keep = mask.to(device=q.device, dtype=torch.uint8).contiguous()
    n_tiles = -(-Tk // KEY_TILE)

    def launch(q, k, v):
        out = torch.empty_like(q)
        image = torch.empty(B, num_heads, n_tiles, 4, KEY_TILE * d, device=q.device)
        status = _lib().flash_mha_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if keep is None else keep.data_ptr(), image.data_ptr(), out.data_ptr(),
            B, Tq, Tk, num_heads, d, q_scale(d), BLOCK_ROWS, _build.stream_ptr(q.device))
        _build.check(status, "flash_mha_f32")
        return out

    out = NoBackward.apply("flash_mha", launch, q, k, v)
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
