"""K1 and K2: windowed STFT / inverse STFT as dense real-DFT products.

Replaces ``demucs_tpu/ops/pallas/stft.py`` (``stft_chunk_dft``, kernel
``_stft_kernel``; ``istft_chunk_dft``, kernel ``_istft_kernel``) with the CUDA
kernels of ``csrc/stft.cu``. The math is the Pallas kernels': with ``G`` the
window times the real-DFT basis,

    Z[t] = x[t*hop : t*hop + n_fft] @ G          (K1, real and imaginary)

and with ``M`` the window times the inverse real-DFT basis, the iSTFT
overlap-adds ``Zr @ Mr + Zi @ Mi`` of every frame at stride ``hop`` (K2).
Normalization by ``1/sqrt(n_fft)`` and the window-envelope division stay
with the caller (``demucs_tpu_torch.ops.spec``), as in the JAX package.

The windowed bases (``(n_fft, freqs)`` and ``(freqs, n_fft)``, re and im;
67 MB in fp32 at n_fft 4096) are built once per (n_fft, device) in float64
on the host, rounded to fp32 as the JAX package rounds them, and cached.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from demucs_tpu_torch.kernels import NoBackward, _build

__all__ = ["stft_dft", "stft_dft_plain", "istft_dft", "istft_dft_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft")
    lib.stft_dft_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.stft_dft_f32.restype = _I
    lib.istft_dft_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.istft_dft_f32.restype = _I
    return lib


@functools.lru_cache(maxsize=4)
def _stft_basis(n_fft: int, device: torch.device) -> tuple:
    """``(Gr, Gi)``, each ``(n_fft, n_fft // 2 + 1)`` = window * rDFT basis."""
    from demucs_tpu_torch.ops.spec import _hann_np, _rdft_basis_np

    fr, fi = _rdft_basis_np(n_fft)
    win = _hann_np(n_fft)[:, None].astype(np.float64)
    with torch.inference_mode(False):  # cached: must outlive an inference_mode caller
        return tuple(torch.from_numpy((win * f).astype(np.float32)).to(device)
                     for f in (fr, fi))


@functools.lru_cache(maxsize=4)
def _istft_basis(n_fft: int, device: torch.device) -> tuple:
    """``(Mr, Mi)``, each ``(n_fft // 2 + 1, n_fft)`` = inverse rDFT basis * window."""
    from demucs_tpu_torch.ops.spec import _hann_np, _irdft_basis_np

    mr, mi = _irdft_basis_np(n_fft)
    win = _hann_np(n_fft)[None, :].astype(np.float64)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy((m * win).astype(np.float32)).to(device)
                     for m in (mr, mi))


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _n_frames(length: int, n_fft: int, hop: int) -> int:
    if length < n_fft:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n_fft}")
    return 1 + (length - n_fft) // hop


def stft_dft_plain(x: torch.Tensor, n_fft: int, hop: int) -> tuple:
    """Plain PyTorch version of :func:`stft_dft` (frames times the basis)."""
    gr, gi = _stft_basis(n_fft, x.device)
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
    _check_cuda("stft_dft", x)
    rows, length = x.shape
    n_frames = _n_frames(length, n_fft, hop)
    freqs = n_fft // 2 + 1
    gr, gi = _stft_basis(n_fft, x.device)

    def launch(x):
        zr = torch.empty(rows, n_frames, freqs, device=x.device, dtype=torch.float32)
        zi = torch.empty_like(zr)
        status = _lib().stft_dft_f32(
            x.data_ptr(), gr.data_ptr(), gi.data_ptr(), zr.data_ptr(), zi.data_ptr(),
            rows, length, n_frames, n_fft, hop, freqs, _build.stream_ptr(x.device))
        _build.check(status, "stft_dft_f32")
        return zr, zi

    zr, zi = NoBackward.apply("stft_dft", launch, x)
    stft_dft.launches += 1
    return zr, zi


stft_dft.launches = 0


def istft_dft_plain(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`istft_dft` (frames, then overlap-add)."""
    mr, mi = _istft_basis(n_fft, zr.device)
    rows, n_frames, _ = zr.shape
    ratio = n_fft // hop
    frames = (zr @ mr + zi @ mi).reshape(rows, n_frames, ratio, hop)
    out = zr.new_zeros(rows, n_frames - 1 + ratio, hop)
    for j in range(ratio):  # hop slice j of frame t lands on output chunk t + j
        out[:, j : j + n_frames] += frames[:, :, j]
    return out.reshape(rows, -1)


def istft_dft(zr: torch.Tensor, zi: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Windowed inverse real DFT of ``zr/zi (R, n_frames, n_fft // 2 + 1)`` plus
    overlap-add at stride ``hop`` -> ``(R, (n_frames - 1) * hop + n_fft)``.

    Requires ``n_fft % hop == 0``. A CPU tensor takes :func:`istft_dft_plain`;
    a CUDA tensor launches K2 or raises.
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
    _check_cuda("istft_dft", zr, zi)
    rows, n_frames, freqs = zr.shape
    mr, mi = _istft_basis(n_fft, zr.device)

    def launch(zr, zi):
        out = torch.empty(rows, (n_frames - 1) * hop + n_fft, device=zr.device,
                          dtype=torch.float32)
        status = _lib().istft_dft_f32(
            zr.data_ptr(), zi.data_ptr(), mr.data_ptr(), mi.data_ptr(), out.data_ptr(),
            rows, n_frames, freqs, n_fft, hop, _build.stream_ptr(zr.device))
        _build.check(status, "istft_dft_f32")
        return out

    out = NoBackward.apply("istft_dft", launch, zr, zi)
    istft_dft.launches += 1
    return out


istft_dft.launches = 0
