"""Multichannel Wiener filtering by expectation-maximization
(port of ``demucs_tpu/ops/wiener.py``).

Behavioral reference: ``openunmix.filtering.wiener``, which
``demucs/hdemucs.py:661-687`` calls for models with ``cac=False`` (the
MDX-era hybrids). Local Gaussian model EM (Liutkus & Badeau):

    repeat `iterations` times:
      M-step: per-source PSD v_j(t,f) = mean_c |y_j|^2;
              spatial covariance R_j(f) = sum_t y_j y_j^H / (eps + sum_t v_j)
      E-step: C_x(t,f) = sum_j v_j R_j + sqrt(eps) I
              y_j = v_j R_j C_x^{-1} x

It starts from the estimated magnitudes with the mixture's phase, on inputs
scaled down by max(1, max|x| / 10). Complex64 throughout; the 2x2 inverse is
the closed form with the JAX package's epsilon on the determinant. Windows of
300 frames, the last one zero-padded (zero frames add nothing to the
statistics and are cut away).
"""

from __future__ import annotations

import torch

__all__ = ["wiener", "apply_wiener", "magnitude_output"]

_EPS = 1e-10  # openunmix's eps; the E-step adds sqrt(eps) * I


def _inv_hermitian(m: torch.Tensor) -> torch.Tensor:
    """Inverse of small matrices ``(..., C, C)``: closed forms for C = 1 and 2."""
    C = m.shape[-1]
    if C == 1:
        return 1.0 / m
    if C == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        det = torch.where(det.abs() < _EPS, det + _EPS, det)
        inv = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    return torch.linalg.inv(m)


def expectation_maximization(y: torch.Tensor, x: torch.Tensor, iterations: int = 2,
                             eps: float = _EPS) -> torch.Tensor:
    """EM refinement. ``y (..., T, F, C, S)`` complex initial estimates,
    ``x (..., T, F, C)`` complex mixture -> refined ``y``."""
    eye = torch.eye(x.shape[-1], dtype=y.dtype, device=y.device)
    for _ in range(iterations):
        v = (y.abs() ** 2).mean(dim=-2)  # (..., T, F, S)
        num = torch.einsum("...tfcs,...tfds->...fcds", y, y.conj())
        den = eps + v.sum(dim=-3)  # (..., F, S)
        R = num / den[..., :, None, None, :]
        Cx = torch.einsum("...tfs,...fcds->...tfcd", v.to(R.dtype), R) + eps ** 0.5 * eye
        inv_Cx = _inv_hermitian(Cx)
        y = torch.einsum("...tfs,...fcds,...tfde,...tfe->...tfcs", v.to(R.dtype), R, inv_Cx, x)
    return y


def wiener(targets_spectrograms: torch.Tensor, mix_stft: torch.Tensor, iterations: int = 1,
           residual: bool = False, scale_factor: float = 10.0) -> torch.Tensor:
    """openunmix-style Wiener filter of one window (or a batch of windows on
    the leading axes).

    ``targets_spectrograms``: real magnitudes ``(..., T, F, C, S)``;
    ``mix_stft``: complex mixture ``(..., T, F, C)``. Returns complex
    ``(..., T, F, C, S[+1 with residual])``."""
    lead = mix_stft.shape[:-3]
    peak = mix_stft.abs().reshape(*lead, -1).amax(dim=-1) / scale_factor
    max_abs = torch.clamp(peak, min=1.0).reshape(*lead, 1, 1, 1)
    mix = mix_stft / max_abs
    targets = targets_spectrograms / max_abs[..., None]
    phase = torch.exp(1j * torch.angle(mix)).to(torch.complex64)
    y = targets.to(torch.complex64) * phase[..., None]
    if residual:
        y = torch.cat([y, (mix - y.sum(dim=-1))[..., None]], dim=-1)
    if iterations:
        y = expectation_maximization(y, mix.to(torch.complex64), iterations)
    return y * max_abs[..., None]


def apply_wiener(mag_out: torch.Tensor, mix_stft: torch.Tensor, niters: int,
                 residual: bool = False, wiener_win_len: int = 300) -> torch.Tensor:
    """The models' ``_wiener`` (``demucs/htdemucs.py:480-509``): EM
    statistics local to each window of ``wiener_win_len`` frames of each item.

    ``mag_out (B, S, C, F, T)`` magnitudes, ``mix_stft (B, C, F, T)`` complex
    -> complex ``(B, S, C, F, T)``."""
    B, S, C, Fq, T = mag_out.shape
    mags = mag_out.permute(0, 4, 3, 2, 1)  # (B, T, F, C, S)
    mix = mix_stft.permute(0, 3, 2, 1)  # (B, T, F, C)
    n_win = -(-T // wiener_win_len)
    Tp = n_win * wiener_win_len
    if Tp != T:
        mags = torch.nn.functional.pad(mags, (0, 0, 0, 0, 0, 0, 0, Tp - T))
        mix = torch.nn.functional.pad(mix, (0, 0, 0, 0, 0, Tp - T))
    mw = mags.reshape(B * n_win, wiener_win_len, Fq, C, S)
    xw = mix.reshape(B * n_win, wiener_win_len, Fq, C)
    out = wiener(mw, xw, niters, residual=residual)
    out = out.reshape(B, Tp, Fq, C, -1)[:, :T]
    if residual:
        out = out[..., :-1]
    return out.permute(0, 4, 3, 2, 1)


def magnitude_output(mag_out: torch.Tensor, mix_stft: torch.Tensor, niters: int,
                     residual: bool = False) -> torch.Tensor:
    """The complex stems of a ``cac=False`` model (``demucs/hdemucs.py:644-687``,
    ``htdemucs.py:463-509``) from its magnitudes ``mag_out (B, S, C, F, T)``
    and the mixture's spectrogram ``mix_stft (B, C, F, T)``: the mixture's
    phase where ``niters < 0``, else Wiener EM (:func:`apply_wiener`)."""
    if niters < 0:
        return mix_stft[:, None] / (1e-8 + mix_stft.abs()[:, None]) * mag_out
    return apply_wiener(mag_out, mix_stft, niters, residual=residual)
