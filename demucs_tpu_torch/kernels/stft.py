"""K1 and K2: windowed STFT / inverse STFT, as FFT kernels on the card.

Replaces ``demucs_tpu/ops/pallas/stft.py`` (``stft_chunk_dft``, kernel
``_stft_kernel``; ``istft_chunk_dft``, kernel ``_istft_kernel``) with the CUDA
kernels of ``csrc/stft.cu``. The functions are the Pallas kernels': with ``G``
the window times the real-DFT basis,

    Z[t] = x[t*hop : t*hop + n_fft] @ G          (K1, real and imaginary)

and with ``M`` the window times the inverse real-DFT basis, the iSTFT
overlap-adds ``Zr @ Mr + Zi @ Mi`` of every frame at stride ``hop`` (K2).
Normalization by ``1/sqrt(n_fft)`` and the window-envelope division stay
with the caller (``demucs_tpu_torch.ops.spec``), as in the JAX package.

On the card both run as real FFTs of each frame in shared memory (a complex
FFT of ``n_fft / 2`` points with the half-length packing), for a power-of-two
``n_fft`` from 256 to 16384; another ``n_fft`` on a CUDA tensor raises. They
take the Hann window and a table of twiddles (:func:`_twiddles_np`), built
once per (n_fft, device) in float64 and rounded to fp32, and cached. The plain
versions, used on CPU tensors and as the kernels' oracle, are the dense
products above; their windowed bases (``(n_fft, freqs)`` and ``(freqs,
n_fft)``, re and im; 67 MB in fp32 at n_fft 4096) are built the same way and
cached, and the card's path never builds them.

Gradients. Each is the other's adjoint, windowed bases and all
(``ops/spec.py``: ``M[k, n] = c_k / n_fft * G[n, k]``, with ``c_k`` 1 at bins
0 and ``n_fft / 2`` and 2 elsewhere, and K2 ignoring the imaginary parts of
those two bins). So K2's backward is one K1 launch on the output gradient
times a scale per bin that the kernel applies to its output
(:func:`istft_dft_backward`), and K1's is one K2 launch on the
gradients scaled by ``n_fft / c_k``, zero-padded to the input's length
(:func:`stft_dft_backward`; off the training path, where the mixture carries
no gradient, but a launch never cuts a graph). On the CPU the same formulas
run through the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from demucs_tpu_torch.kernels import _build, device_cache

__all__ = ["stft_dft", "stft_dft_plain", "istft_dft", "istft_dft_plain", "stft_dft_backward",
           "stft_dft_backward_plain", "istft_dft_backward", "istft_dft_backward_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
N_FFT_RANGE = (256, 16384)  # power-of-two n_fft the kernels take
SMEM_MAX = 232448  # bytes of shared memory one block may use on sm_90
GROUP = 8  # K2: output chunks per block, the fastest at 1 and 6 segments on an H100


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft")
    lib.stft_dft_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.stft_dft_f32.restype = _I
    lib.istft_dft_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.istft_dft_f32.restype = _I
    return lib


@device_cache(maxsize=4)
def _stft_basis(n_fft: int, device: torch.device) -> tuple:
    """``(Gr, Gi)``, each ``(n_fft, n_fft // 2 + 1)`` = window * rDFT basis."""
    from demucs_tpu_torch.ops.spec import _hann_np, _rdft_basis_np

    fr, fi = _rdft_basis_np(n_fft)
    win = _hann_np(n_fft)[:, None].astype(np.float64)
    return tuple(torch.from_numpy((win * f).astype(np.float32)).to(device) for f in (fr, fi))


@device_cache(maxsize=4)
def _istft_basis(n_fft: int, device: torch.device) -> tuple:
    """``(Mr, Mi)``, each ``(n_fft // 2 + 1, n_fft)`` = inverse rDFT basis * window."""
    from demucs_tpu_torch.ops.spec import _hann_np, _irdft_basis_np

    mr, mi = _irdft_basis_np(n_fft)
    win = _hann_np(n_fft)[None, :].astype(np.float64)
    return tuple(torch.from_numpy((m * win).astype(np.float32)).to(device) for m in (mr, mi))


def _twiddles_np(n_fft: int) -> np.ndarray:
    """The kernels' twiddle table, complex128, in the layout ``csrc/stft.cu``
    reads: ``exp(-2 pi i m / n_fft)`` for ``m = 0..n_fft/2`` (the split of
    K1, the fold of K2), then for each radix-4 stage of the FFT of ``h =
    n_fft / 2`` points, with sub-transforms of ``ns = 1 or 2, 4 ns, ..., h /
    4`` points done, ``exp(-2 pi i r k / (4 ns))`` for ``r = 1, 2, 3`` and ``k <
    ns``, one run per ``r``."""
    h = n_fft // 2
    parts = [np.exp(-2j * np.pi * np.arange(h + 1) / n_fft)]
    ns = 2 if (h.bit_length() - 1) % 2 else 1  # after the radix-2 stage of an odd log2(h)
    while ns < h:
        parts += [np.exp(-2j * np.pi * r * np.arange(ns) / (4 * ns)) for r in (1, 2, 3)]
        ns *= 4
    return np.concatenate(parts)


@device_cache(maxsize=8)
def _fft_tables(n_fft: int, device: torch.device) -> tuple:
    """The kernels' tables: the Hann window ``(n_fft,)`` and the twiddles
    of :func:`_twiddles_np` as ``(_, 2)`` = re, im, both fp32."""
    from demucs_tpu_torch.ops.spec import _hann_np

    tw = _twiddles_np(n_fft)
    twiddle = np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(_hann_np(n_fft)).to(device), torch.from_numpy(twiddle).to(device)


@device_cache(maxsize=8)
def _bin_scales(n_fft: int, device: torch.device) -> torch.Tensor:
    """``(2, freqs)`` fp32: ``c_k / n_fft``, and the same with 0 at bins 0 and
    ``n_fft / 2``: the per-bin scales of K2's adjoint on the real and the
    imaginary parts (in this layout K1's kernel applies them)."""
    c = np.full(n_fft // 2 + 1, 2.0)
    c[0] = c[-1] = 1.0
    re = c / n_fft
    im = re.copy()
    im[0] = im[-1] = 0.0
    return torch.from_numpy(np.stack([re, im]).astype(np.float32)).to(device)


def _check_cuda(name: str, n_fft: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    lo, hi = N_FFT_RANGE
    if not lo <= n_fft <= hi or n_fft & (n_fft - 1):
        raise ValueError(f"{name}: the CUDA kernel takes a power-of-two n_fft from {lo} "
                         f"to {hi}, got {n_fft}")


def _n_frames(length: int, n_fft: int, hop: int) -> int:
    if length < n_fft:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n_fft}")
    return 1 + (length - n_fft) // hop


def stft_dft_plain(x: torch.Tensor, n_fft: int, hop: int) -> tuple:
    """Plain PyTorch version of :func:`stft_dft` (frames times the basis)."""
    gr, gi = (b.to(x.dtype) for b in _stft_basis(n_fft, x.device))  # float64: a reference run
    frames = x.unfold(-1, n_fft, hop)  # (R, n_frames, n_fft), frame t at t*hop
    return frames @ gr, frames @ gi


def stft_dft(x: torch.Tensor, n_fft: int, hop: int) -> tuple:
    """Windowed, unnormalized real DFT of every frame of ``x (R, L)``.

    Frame ``t`` is ``x[:, t*hop : t*hop + n_fft]`` for ``t < 1 + (L - n_fft)
    // hop``. Returns ``(zr, zi)``, each ``(R, n_frames, n_fft // 2 + 1)``
    float32. A CPU tensor takes :func:`stft_dft_plain`; a CUDA tensor
    launches K1 or raises.
    """
    if x.dim() != 2:
        raise ValueError(f"stft_dft expects (rows, length), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stft_dft_plain(x, n_fft, hop)
    _check_cuda("stft_dft", n_fft, x)
    zr, zi = _Stft.apply(x, n_fft, hop)
    stft_dft.launches += 1
    return zr, zi


def _launch_stft(x: torch.Tensor, n_fft: int, hop: int,
                 scale: torch.Tensor | None = None) -> tuple:
    rows, length = x.shape
    n_frames = _n_frames(length, n_fft, hop)
    window, twiddle = _fft_tables(n_fft, x.device)
    zr = torch.empty(rows, n_frames, n_fft // 2 + 1, device=x.device, dtype=torch.float32)
    zi = torch.empty_like(zr)
    status = _lib().stft_dft_f32(
        x.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
        None if scale is None else scale.data_ptr(), zr.data_ptr(), zi.data_ptr(),
        rows, length, n_frames, n_fft, hop, _build.stream_ptr(x.device))
    _build.check(status, "stft_dft_f32")
    return zr, zi


class _Stft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_fft, hop):
        ctx.args = (n_fft, hop, x.shape[-1])
        return _launch_stft(x, n_fft, hop)

    @staticmethod
    def backward(ctx, gr, gi):
        n_fft, hop, length = ctx.args
        return stft_dft_backward(gr, gi, n_fft, hop, length), None, None


def stft_dft_backward(gr: torch.Tensor | None, gi: torch.Tensor | None, n_fft: int, hop: int,
                      length: int) -> torch.Tensor:
    """The gradient of :func:`stft_dft` at an input of ``length`` samples, from
    the gradients of ``(zr, zi)`` (either may be None: zero): K2 on them
    scaled by ``n_fft / c_k``, zero-padded to ``length``. Needs ``n_fft % hop
    == 0``. A CPU tensor takes the plain K2; a CUDA tensor launches K2's
    kernel or raises (``stft_dft_backward.launches`` counts them)."""
    ar, ai = _adjoint_inputs(gr, gi, n_fft)
    if ar.device.type == "cpu":
        y = istft_dft_plain(ar, ai, n_fft, hop)
    else:
        if n_fft % hop:
            raise ValueError(f"stft_dft_backward needs n_fft % hop == 0, got {n_fft} % {hop}")
        _check_cuda("stft_dft_backward", n_fft, ar, ai)
        y = _launch_istft(ar, ai, n_fft, hop)
        stft_dft_backward.launches += 1
    return torch.nn.functional.pad(y, (0, length - y.shape[-1]))


def _adjoint_inputs(gr, gi, n_fft: int) -> tuple:
    """K2's inputs for K1's adjoint: the gradients (None: zero) times n_fft / c_k."""
    like = gr if gr is not None else gi
    gr = torch.zeros_like(like) if gr is None else gr
    gi = torch.zeros_like(like) if gi is None else gi
    re = _bin_scales(n_fft, like.device)[0]
    return (gr / re).contiguous(), (gi / re).contiguous()


def stft_dft_backward_plain(gr: torch.Tensor | None, gi: torch.Tensor | None, n_fft: int,
                            hop: int, length: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`stft_dft_backward` (the plain K2)."""
    y = istft_dft_plain(*_adjoint_inputs(gr, gi, n_fft), n_fft, hop)
    return torch.nn.functional.pad(y, (0, length - y.shape[-1]))


stft_dft_backward.launches = 0
stft_dft.launches = 0


def istft_dft_plain(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`istft_dft` (frames, then overlap-add)."""
    mr, mi = (b.to(zr.dtype) for b in _istft_basis(n_fft, zr.device))
    rows, n_frames, _ = zr.shape
    ratio = n_fft // hop
    frames = (zr @ mr + zi @ mi).reshape(rows, n_frames, ratio, hop)
    out = zr.new_zeros(rows, n_frames - 1 + ratio, hop)
    for j in range(ratio):  # hop slice j of frame t lands on output chunk t + j
        out[:, j : j + n_frames] += frames[:, :, j]
    return out.reshape(rows, -1)


def istft_group(n_fft: int, hop: int) -> int:
    """Output chunks per K2 block: ``GROUP``, or fewer where one block's shared
    memory (the FFT buffer and the accumulator) would not fit. Each block
    inverts ``group + n_fft / hop - 1`` frames for its ``group`` chunks: fewer
    chunks recompute more FFTs, more chunks fit fewer blocks on an SM."""
    group = GROUP
    while group > 1 and 4 * n_fft + 4 * group * hop > SMEM_MAX:
        group //= 2
    return group


def istft_dft(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Windowed inverse real DFT of ``zr/zi (R, n_frames, n_fft // 2 + 1)`` plus
    overlap-add at stride ``hop`` -> ``(R, (n_frames - 1) * hop + n_fft)``.

    Requires ``n_fft % hop == 0``. The imaginary parts of bins 0 and
    ``n_fft // 2`` contribute nothing (numpy's ``irfft``). A CPU tensor takes
    :func:`istft_dft_plain`; a CUDA tensor launches K2 or raises.
    """
    if zr.dim() != 3 or zr.shape != zi.shape:
        raise ValueError(f"istft_dft expects matching (rows, frames, freqs), got "
                         f"{tuple(zr.shape)} and {tuple(zi.shape)}")
    if zr.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"{zr.shape[-1]} frequencies do not match n_fft={n_fft}")
    if n_fft % hop:
        raise ValueError(f"istft_dft needs n_fft % hop == 0, got {n_fft} % {hop}")
    if zr.device.type == "cpu":
        return istft_dft_plain(zr, zi, n_fft, hop)
    _check_cuda("istft_dft", n_fft, zr, zi)
    out = _Istft.apply(zr, zi, n_fft, hop)
    istft_dft.launches += 1
    return out


def _launch_istft(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    rows, n_frames, _ = zr.shape
    n_chunks = n_frames - 1 + n_fft // hop
    window, twiddle = _fft_tables(n_fft, zr.device)
    out = torch.empty(rows, n_chunks * hop, device=zr.device, dtype=torch.float32)
    status = _lib().istft_dft_f32(
        zr.data_ptr(), zi.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
        out.data_ptr(), rows, n_frames, n_fft, hop, istft_group(n_fft, hop),
        _build.stream_ptr(zr.device))
    _build.check(status, "istft_dft_f32")
    return out


class _Istft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zr, zi, n_fft, hop):
        ctx.args = (n_fft, hop)
        return _launch_istft(zr, zi, n_fft, hop)

    @staticmethod
    def backward(ctx, g):
        n_fft, hop = ctx.args
        gr, gi = istft_dft_backward(g, n_fft, hop)
        return gr, gi, None, None


def istft_dft_backward(g: torch.Tensor, n_fft: int, hop: int) -> tuple:
    """The gradients of :func:`istft_dft`'s ``(zr, zi)`` from the gradient
    ``g (R, (n_frames - 1) * hop + n_fft)`` of its output: ``c_k / n_fft``
    times the real part of K1 on ``g`` and the same times its imaginary part,
    0 at bins 0 and ``n_fft / 2`` (which K2 ignores). A CPU tensor takes the
    plain K1; a CUDA tensor launches K1's kernel or raises
    (``istft_dft_backward.launches`` counts them)."""
    g = g.contiguous()
    if g.device.type == "cpu":
        return istft_dft_backward_plain(g, n_fft, hop)
    _check_cuda("istft_dft_backward", n_fft, g)
    out = _launch_stft(g, n_fft, hop, _bin_scales(n_fft, g.device))  # the scale in the kernel
    istft_dft_backward.launches += 1
    return out


def istft_dft_backward_plain(g: torch.Tensor, n_fft: int, hop: int) -> tuple:
    """Plain PyTorch version of :func:`istft_dft_backward` (the plain K1)."""
    zr, zi = stft_dft_plain(g, n_fft, hop)
    re, im = _bin_scales(n_fft, g.device)
    return zr * re, zi * im


istft_dft_backward.launches = 0
istft_dft.launches = 0
