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

bf16 inputs (a bf16 stage of HTDemucs) follow the JAX package's rounding
points: a convolution or linear map rounds its product to bf16 and adds the
bias in bf16 after it (fp32 accumulation inside the product: the library's
on the card; on the CPU the product runs in fp32 over the bf16 values and is
rounded once, which is the same function, since a product of two bf16
values is exact in fp32, and its backward is JAX's, whose cast transposes
round each gradient once; oneDNN's bf16 convolution gives wrong values for
some shapes, e.g. 8 to 16 channels at kernel 8, stride 4, padding 2, the
fault that ROADMAP.md records as C3); the norms
take their statistics in fp32, round the normalized values to the input's
dtype, then apply the affine weights in that dtype; GELU and GLU round each
step of JAX's formula.

:func:`bf16_operands` is the card's form of the ``"bfloat16"`` matmul
precision (``models/htdemucs.py::precision_scope``): inside it the fp32
operands of every convolution and product on a CUDA tensor are rounded to
bf16 and the product runs on the TF32 tensor cores, which hold a bf16 value
exactly, so the result is the bf16 product with fp32 accumulation, in fp32.

A 16-bit transposed convolution on the card runs under cuDNN's deterministic
algorithms (:func:`_deterministic16`): cuDNN's default bf16 algorithms for
them gave two forwards of the same input different outputs (1.8-2.6e-2 x
peak over HTDemucs's decoders), and the JAX package gives the same stems
every time. The setting holds for those calls only, not process-wide.
"""

from __future__ import annotations

import contextlib
import functools
import math
import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["conv1d", "conv2d", "conv_transpose1d", "conv_transpose2d", "linear", "matmul",
           "group_norm", "layer_norm", "glu", "gelu", "std_unbiased", "embedding",
           "bf16_operands"]

_Int2 = tp.Union[int, tp.Tuple[int, int]]
_BF16_OPERANDS = False
# full-precision dtypes take the library's op as it is (float64: a reference
# run on the CPU); 16-bit ones round where JAX does (module docstring)
_FULL = (torch.float32, torch.float64)


@contextlib.contextmanager
def bf16_operands(enabled: bool = True):
    """Round the fp32 operands of convolutions and products on CUDA tensors
    to bf16 inside the block (restored on exit). CPU tensors are untouched:
    there every precision string computes true fp32, as in JAX."""
    global _BF16_OPERANDS
    outer, _BF16_OPERANDS = _BF16_OPERANDS, enabled
    try:
        yield
    finally:
        _BF16_OPERANDS = outer


def _operands(*ts: tp.Optional[torch.Tensor]) -> tp.Tuple[tp.Optional[torch.Tensor], ...]:
    if not (_BF16_OPERANDS and ts[0].is_cuda and ts[0].dtype == torch.float32):
        return ts
    return tuple(None if t is None else t.bfloat16().float() for t in ts)


def _bias_after(x: torch.Tensor) -> bool:
    """A 16-bit product is rounded before its bias is added, as in JAX."""
    return x.dtype in (torch.bfloat16, torch.float16)


def _product16(fn: tp.Callable, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(x, w, **kw)`` (a product without its bias) of 16-bit operands, in
    their dtype: the library's on the card, in fp32 rounded once on the CPU
    (module docstring). ``torch.export`` traces the card's form on either
    device, so an exported program is the same wherever it was traced."""
    if x.is_cuda or torch.compiler.is_exporting():
        return fn(x, w, **kw)
    return fn(x.float(), w.float(), **kw).to(x.dtype)


@contextlib.contextmanager
def _deterministic16(x: torch.Tensor):
    """cuDNN's deterministic algorithms for the block when ``x`` is a 16-bit
    CUDA tensor, the flag restored on exit. The flag is read when cuDNN picks
    its algorithm, so a CUDA graph captured inside the block replays the
    deterministic one."""
    if not (x.is_cuda and _bias_after(x)):
        yield
        return
    outer = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = outer


def _add_bias(out: torch.Tensor, b: tp.Optional[torch.Tensor]) -> torch.Tensor:
    if b is None:
        return out
    return out + b.to(out.dtype).reshape(-1, *([1] * (out.dim() - 2)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU. A 16-bit input rounds where ``jax.nn.gelu`` does:
    ``(0.5 x) * erfc(-x * sqrt(0.5))``, each step in its dtype."""
    if x.dtype in _FULL:
        return F.gelu(x)
    # the constant rounded to x's dtype, as JAX rounds it; a Python number, so
    # that the forward copies nothing from the host (a graph capture refuses it)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype).item()
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def glu(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Gated linear unit along ``axis``. A 16-bit input rounds each step of
    the JAX package's ``a * sigmoid(b)``, whose sigmoid XLA expands to
    ``1 / (1 + exp(-b))``."""
    if x.dtype in _FULL:
        return F.glu(x, dim=axis)
    a, b = x.chunk(2, dim=axis)
    return a * (1 / (1 + torch.exp(-b)))


def std_unbiased(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    """Standard deviation with Bessel's correction (``Tensor.std``)."""
    return torch.std(x, dim=axis, keepdim=keepdims, correction=1)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution. ``x (B, C, L)``, ``w (O, I/groups, K)``."""
    x, w = _operands(x, w)
    if _bias_after(x):
        return _add_bias(_product16(F.conv1d, x, w, stride=stride, padding=padding,
                                    dilation=dilation, groups=groups), b)
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None, *,
           stride: _Int2 = 1, padding: _Int2 = 0, dilation: _Int2 = 1,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution. ``x (B, C, H, W)``, ``w (O, I/groups, Kh, Kw)``."""
    x, w = _operands(x, w)
    if _bias_after(x):
        return _add_bias(_product16(F.conv2d, x, w, stride=stride, padding=padding,
                                    dilation=dilation, groups=groups), b)
    return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: tp.Optional[torch.Tensor] = None, *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """1-D transposed convolution. ``w (I, O, K)``; out_len = (L-1)*stride - 2*padding + K."""
    x, w = _operands(x, w)
    if _bias_after(x):
        with _deterministic16(x):
            out = _product16(F.conv_transpose1d, x, w, stride=stride, padding=padding)
        return _add_bias(out, b)
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: tp.Optional[torch.Tensor] = None, *, stride: _Int2 = 1,
                     padding: _Int2 = 0) -> torch.Tensor:
    """2-D transposed convolution. ``w (I, O, Kh, Kw)``."""
    x, w = _operands(x, w)
    if _bias_after(x):
        with _deterministic16(x):
            out = _product16(F.conv_transpose2d, x, w, stride=stride, padding=padding)
        return _add_bias(out, b)
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)


def linear(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine map on the last axis. ``w (out, in)``."""
    x, w = _operands(x, w)
    if _bias_after(x):
        out = _product16(F.linear, x, w)
        return out if b is None else out + b.to(out.dtype)
    return F.linear(x, w, b)


def matmul(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)``, a product under :func:`bf16_operands`."""
    a, b = _operands(a, b)
    if _bias_after(a):
        return _product16(functools.partial(torch.einsum, equation), a, b)
    return torch.einsum(equation, a, b)


def group_norm(x: torch.Tensor, num_groups: int, w: tp.Optional[torch.Tensor] = None,
               b: tp.Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``x (B, C, *spatial)`` with biased variance. A 16-bit
    input is normalized in fp32 and returned in its own dtype."""
    if x.dtype in _FULL:
        return F.group_norm(x, num_groups, w, b, eps=eps)
    B, C = x.shape[:2]
    xg = x.reshape(B, num_groups, -1).float()
    var, mean = torch.var_mean(xg, dim=-1, keepdim=True, correction=0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    return _affine(out, w, b, (1, C) + (1,) * (x.dim() - 2))


def layer_norm(x: torch.Tensor, w: tp.Optional[torch.Tensor] = None,
               b: tp.Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis. A 16-bit input is normalized in fp32 and
    returned in its own dtype."""
    if x.dtype in _FULL:
        return F.layer_norm(x, (x.shape[-1],), w, b, eps=eps)
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    return _affine(((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype), w, b, (-1,))


def _affine(out: torch.Tensor, w: tp.Optional[torch.Tensor], b: tp.Optional[torch.Tensor],
            shape: tp.Tuple[int, ...]) -> torch.Tensor:
    """The norms' weight, then bias, each rounded to ``out``'s dtype (JAX's order)."""
    if w is not None:
        out = out * w.to(out.dtype).reshape(shape)
        if b is not None:
            out = out + b.to(out.dtype).reshape(shape)
    return out


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; ``table (num_embeddings, dim)``."""
    return F.embedding(ids, table)
