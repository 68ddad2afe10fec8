"""STFT / iSTFT with the Demucs framing conventions (port of ``demucs_tpu/ops/spec.py``).

Behavioral reference: ``torch.stft``/``torch.istft`` with a periodic Hann
window, ``center=True``, reflect padding and ``normalized=True``, and the
Demucs pad/trim conventions of ``demucs_spec``/``demucs_ispec``.

The transforms run through kernels K1 and K2 (``demucs_tpu_torch.kernels.stft``),
the functions of the JAX package's ``method="pallas"``: on the card the CUDA
FFT kernels, on the CPU their plain versions, the Pallas kernels' dense
chunk-DFT products. The normalization by ``1/sqrt(n_fft)`` and the
window-envelope division stay here, outside the kernels, as in the JAX
package.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from demucs_tpu_torch.kernels import device_cache
from demucs_tpu_torch.kernels.stft import istft_dft, stft_dft

__all__ = ["stft", "istft", "pad1d", "demucs_spec", "demucs_ispec", "cac_pack",
           "cac_unpack"]


@functools.lru_cache(maxsize=None)
def _hann_np(n: int) -> np.ndarray:
    # Periodic Hann window (torch.hann_window default periodic=True).
    t = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rdft_basis_np(n_fft: int) -> tuple:
    eye = np.eye(n_fft, dtype=np.float64)
    basis = np.fft.rfft(eye, axis=-1)  # (n_fft, freqs)
    return basis.real.astype(np.float32), basis.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_basis_np(n_fft: int) -> tuple:
    freqs = n_fft // 2 + 1
    eye = np.eye(freqs, dtype=np.float64)
    mr = np.fft.irfft(eye, n=n_fft, axis=-1)  # irfft of real unit vectors
    mi = np.fft.irfft(1j * eye, n=n_fft, axis=-1)
    return mr.astype(np.float32), mi.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_envelope_np(n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """Sum of squared windows at every output sample (torch.istft denominator)."""
    w2 = _hann_np(n_fft).astype(np.float64) ** 2
    env = np.zeros((n_frames - 1) * hop + n_fft)
    for t in range(n_frames):
        env[t * hop : t * hop + n_fft] += w2
    return env.astype(np.float32)


@device_cache(maxsize=8)
def _window_envelope(n_fft: int, hop: int, n_frames: int, device: torch.device) -> torch.Tensor:
    env = torch.from_numpy(_window_envelope_np(n_fft, hop, n_frames)).to(device)
    return env.clamp_min(1e-11)


def _real(x: torch.Tensor) -> torch.Tensor:
    """fp32, the DSP's type; float64 stays (a reference run on the CPU)."""
    return x if x.dtype == torch.float64 else x.float()


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (left, right), mode="reflect").reshape(*lead, -1)


def stft(x: torch.Tensor, n_fft: int, hop: int, *, normalized: bool = True,
         center: bool = True) -> torch.Tensor:
    """Complex STFT matching ``torch.stft(..., window=hann, pad_mode='reflect')``.

    ``x (..., L)`` real -> complex64 ``(..., n_fft // 2 + 1, n_frames)``.
    """
    if center:
        x = _reflect_pad(x, n_fft // 2, n_fft // 2)
    lead = x.shape[:-1]
    zr, zi = stft_dft(_real(x.reshape(-1, x.shape[-1])).contiguous(), n_fft, hop)
    if normalized:
        scale = 1.0 / math.sqrt(n_fft)
        zr, zi = zr * scale, zi * scale
    z = torch.complex(zr, zi).reshape(*lead, zr.shape[-2], zr.shape[-1])
    return z.transpose(-1, -2)


def istft(z: torch.Tensor, n_fft: int, hop: int, *, length: int | None = None,
          normalized: bool = True, center: bool = True) -> torch.Tensor:
    """Inverse STFT matching ``torch.istft`` (hann window).

    ``z (..., n_fft // 2 + 1, n_frames)`` complex -> real ``(..., length)``;
    with ``length=None`` the overlap-add output minus the center pad on
    both ends.
    """
    n_frames = z.shape[-1]
    zt = z.transpose(-1, -2)  # (..., n_frames, freqs)
    lead = zt.shape[:-2]
    freqs = zt.shape[-1]
    zr = zt.real.reshape(-1, n_frames, freqs)
    zi = zt.imag.reshape(-1, n_frames, freqs)
    if normalized:
        zr, zi = zr * math.sqrt(n_fft), zi * math.sqrt(n_fft)
    y = istft_dft(_real(zr).contiguous(), _real(zi).contiguous(), n_fft, hop)
    y = y.reshape(*lead, y.shape[-1])
    y = y / _window_envelope(n_fft, hop, n_frames, y.device)
    if center:
        pad = n_fft // 2
        if length is not None:
            return y[..., pad : pad + length]
        # torch.istft(center=True, length=None) trims the center pad on both ends
        return y[..., pad : y.shape[-1] - pad]
    if length is not None:
        return y[..., :length]
    return y


def pad1d(x: torch.Tensor, paddings: tuple[int, int], mode: str = "constant",
          value: float = 0.0) -> torch.Tensor:
    """1-D pad on the last axis; reflect-pad stays valid for short inputs.

    Mirrors ``demucs/hdemucs.py:23-40``: when reflect padding is requested
    and the signal is shorter than the largest pad, zeros go in first so the
    reflection is defined.
    """
    length = x.shape[-1]
    padding_left, padding_right = paddings
    if mode == "reflect":
        max_pad = max(padding_left, padding_right)
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            extra_pad_right = min(padding_right, extra_pad)
            extra_pad_left = extra_pad - extra_pad_right
            padding_left -= extra_pad_left
            padding_right -= extra_pad_right
            x = F.pad(x, (extra_pad_left, extra_pad_right))
        return _reflect_pad(x, padding_left, padding_right)
    return F.pad(x, (padding_left, padding_right), value=value)


def demucs_spec(x: torch.Tensor, nfft: int, *, hybrid_old: bool = False) -> torch.Tensor:
    """Demucs-convention spectrogram of ``x (..., L)``: complex ``(..., nfft//2, le)``.

    Pads so frames == ceil(L / hop), drops the Nyquist row and trims 2
    frames on each side (``demucs/htdemucs.py:420-440``).
    """
    hop = nfft // 4
    le = int(math.ceil(x.shape[-1] / hop))
    pad = hop // 2 * 3
    mode = "constant" if hybrid_old else "reflect"
    x = pad1d(x, (pad, pad + le * hop - x.shape[-1]), mode=mode)
    z = stft(x, nfft, hop)[..., :-1, :]
    if z.shape[-1] != le + 4:
        raise AssertionError((tuple(z.shape), le))
    return z[..., 2 : 2 + le]


def demucs_ispec(z: torch.Tensor, length: int, *, hybrid_old: bool = False) -> torch.Tensor:
    """Inverse of :func:`demucs_spec` cropped to ``length``.

    Re-appends the Nyquist row, re-pads 2 frames on each side and inverts
    with the centered iSTFT (``demucs/htdemucs.py:442-450``).
    """
    *lead, freqs, frames = z.shape
    hop = 2 * freqs // 4  # n_fft = 2 * freqs (the Nyquist row was dropped)
    zp = z.new_zeros(*lead, freqs + 1, frames + 4)
    zp[..., :freqs, 2 : 2 + frames] = z
    pad = hop // 2 * 3
    if hybrid_old:
        le = hop * int(math.ceil(length / hop))
        return istft(zp, 4 * hop, hop, length=le)[..., :length]
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    return istft(zp, 4 * hop, hop, length=le)[..., pad : pad + length]


def cac_pack(z: torch.Tensor) -> torch.Tensor:
    """Complex-as-channels: ``(B, C, F, T)`` complex -> ``(B, 2C, F, T)`` real.

    Channel order ``[c0_re, c0_im, c1_re, c1_im, ...]``
    (``demucs/htdemucs.py:452-461``).
    """
    B, C, Fq, T = z.shape
    m = torch.stack([z.real, z.imag], dim=2)  # (B, C, 2, F, T)
    return m.reshape(B, C * 2, Fq, T)


def cac_unpack(m: torch.Tensor) -> torch.Tensor:
    """``(B, S, 2C, F, T)`` real -> ``(B, S, C, F, T)`` complex
    (``demucs/htdemucs.py:463-471``)."""
    B, S, C2, Fq, T = m.shape
    m = m.reshape(B, S, C2 // 2, 2, Fq, T)
    return torch.complex(m[:, :, :, 0].contiguous(), m[:, :, :, 1].contiguous())
