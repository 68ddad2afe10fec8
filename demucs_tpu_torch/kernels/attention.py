"""K3: fused multi-head attention over projected q/k/v.

Replaces ``demucs_tpu/ops/pallas/attention.py`` (``flash_mha``, kernel
``_attn_kernel``) with the kernels of ``csrc/flash_mha.cu``, by the dtype of
the inputs (the Pallas kernel takes any float dtype):

- fp32 (:func:`flash_mha`'s own launch): both products on the H100's tensor
  cores (``wgmma``) in the three-term TF32 split, which keeps fp32-level
  accuracy whatever ``torch.backends`` says about TF32 (more accurate than
  any matmul precision string); each launch first lays K and V out, split
  and with V transposed, as the shared-memory image the products read, in a
  scratch tensor.
- bf16 (:func:`flash_mha_bf16`): one bf16 ``wgmma`` per product with fp32
  accumulation, K and V copied into shared memory as they are (no layout
  pass), the softmax scale applied to the fp32 scores, P packed to bf16 in
  registers; the output in bf16.

Both: an online softmax over tiles of 64 keys with fp32 accumulators; an
optional ``(Tq, Tk)`` boolean keep-mask shared by batch and heads; the
-inf-safe rescale (a fully masked row gives NaN, as the plain softmax does).
Head dims 32, 48 and 64. The plain version is
:func:`demucs_tpu_torch.ops.attention.multihead_attention`. Any other dtype
on the card raises.

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

__all__ = ["flash_mha", "flash_mha_bf16", "flash_mha_plain", "HEAD_DIMS", "KEY_TILE",
           "q_scale", "bf16_tiles"]

HEAD_DIMS = (32, 48, 64)
KEY_TILE = 64  # keys per tile of the kernel's loop
# Query rows per block of the fp32 route: 64 (one consumer warpgroup) or 128
# (two, which overlap one's softmax with the other's products; the faster at
# every released shape and batch on the H100, PERF.md). The bf16 route runs
# 128.
BLOCK_ROWS = 128


# The plain version of K3, used for CPU tensors and as the kernel's oracle.
flash_mha_plain = multihead_attention


def q_scale(head_dim: int) -> float:
    """The softmax scale in base 2, log2(e)/sqrt(d): the fp32 route multiplies
    q by it before the split, the bf16 route the fp32 scores."""
    return math.log2(math.e) / math.sqrt(head_dim)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels read 16-byte rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_mha_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    lib.flash_mha_f32.restype = i
    lib.flash_mha_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
    lib.flash_mha_bf16.restype = i
    lib.flash_mha_bf16_tiles.argtypes = [p, p, p, p, p, p, i, p]
    lib.flash_mha_bf16_tiles.restype = i
    return lib


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
             mask: torch.Tensor | None, dtype: torch.dtype):
    """Shapes, head dim and dtype of a CUDA launch -> (B, Tq, Tk, d, keep)."""
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
        if t.device.type != "cuda" or t.dtype != dtype:
            raise TypeError(f"this route of flash_mha takes {dtype} CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
    keep = None
    if mask is not None:
        if tuple(mask.shape) != (Tq, Tk):
            raise ValueError(f"mask {tuple(mask.shape)} is not (Tq, Tk) = {(Tq, Tk)}")
        keep = mask.to(device=q.device, dtype=torch.uint8).contiguous()
    return B, Tq, Tk, d, keep


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              *, mask: torch.Tensor | None = None, dropout: float = 0.0) -> torch.Tensor:
    """Attention of ``q (B, Tq, C)`` over ``k, v (B, Tk, C)`` with ``num_heads``
    heads -> ``(B, Tq, C)`` in their dtype (before the output projection).

    ``mask``: optional boolean keep-mask ``(Tq, Tk)``. A CPU tensor takes the
    plain version; a CUDA tensor launches K3 (fp32 here, bf16 through
    :func:`flash_mha_bf16`) or raises. ``flash_mha.launches`` counts the
    fp32 route's launches.
    """
    if dropout > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice of the port")
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, mask=mask)
    if q.dtype == torch.bfloat16:
        return flash_mha_bf16(q, k, v, num_heads, mask=mask)
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, torch.float32)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
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


def flash_mha_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   *, mask: torch.Tensor | None = None) -> torch.Tensor:
    """K3's bf16 route: bf16 ``q (B, Tq, C)``, ``k, v (B, Tk, C)`` -> bf16
    ``(B, Tq, C)``. A CPU tensor takes the plain version; a bf16 CUDA tensor
    launches the kernel, anything else on the card raises.
    ``flash_mha_bf16.launches`` counts its launches."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, mask=mask)
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, torch.bfloat16)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)

    def launch(q, k, v):
        out = torch.empty_like(q)
        status = _lib().flash_mha_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if keep is None else keep.data_ptr(), out.data_ptr(),
            B, Tq, Tk, num_heads, d, q_scale(d), _build.stream_ptr(q.device))
        _build.check(status, "flash_mha_bf16")
        return out

    out = NoBackward.apply("flash_mha_bf16", launch, q, k, v)
    flash_mha_bf16.launches += 1
    return out


flash_mha.launches = 0
flash_mha_bf16.launches = 0


def bf16_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               p: torch.Tensor) -> tuple:
    """Bring-up check of the bf16 route's two products alone, on the card:
    bf16 ``q, k, v (64, d)`` and fp32 ``p (64, 64)`` -> fp32 ``(Q K^T, bf16(P) V)``
    by one warpgroup's ``wgmma`` s through the kernel's tile image,
    descriptors and fragment maps (a wrong one gives wrong numbers, no error)."""
    d = q.shape[1]
    if d not in HEAD_DIMS or q.shape != (KEY_TILE, d) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"bf16_tiles takes (64, d) tiles, d in {HEAD_DIMS}")
    if p.shape != (KEY_TILE, KEY_TILE) or p.dtype != torch.float32:
        raise ValueError("p must be a (64, 64) float32 tensor")
    q, k, v = (_aligned(t) for t in (q, k, v))
    p = p.contiguous()
    s_out = torch.empty(KEY_TILE, KEY_TILE, device=q.device)
    o_out = torch.empty(KEY_TILE, d, device=q.device)
    status = _lib().flash_mha_bf16_tiles(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                                         s_out.data_ptr(), o_out.data_ptr(), d,
                                         _build.stream_ptr(q.device))
    _build.check(status, "flash_mha_bf16_tiles")
    return s_out, o_out
