"""Native BSS Eval (images) — SDR / ISR / SIR / SAR without museval
(the port's copy of ``demucs_tpu/ops/bsseval.py``; numpy and scipy, on the
host).

Implements the BSS Eval "images" decomposition (Vincent, Gribonval, Fevotte,
"Performance Measurement in Blind Audio Source Separation", IEEE TASLP 2006)
in the museval-v4 configuration the reference uses
(``demucs/evaluate.py:57-64``: ``compute_permutation=False``,
``framewise_filters=False``, ``bsseval_sources_version=False``, 1 s
window/hop): the distortion filters are estimated ONCE over the whole track,
the metric energies are then framed.

Decomposition of an estimated source image ``est`` w.r.t. reference images
``refs (nsrc, nchan, T)``, with an ``flen``-tap least-squares projector per
output channel:

    s_true  = refs[j]
    e_spat  = P_j(est)   - s_true     (projection onto source j's channels)
    e_interf= P_all(est) - P_j(est)   (projection onto ALL sources' channels)
    e_artif = est        - P_all(est)

    SDR = 10log10 ||s_true + e_spat||^2            / ||e_interf + e_artif||^2
    ISR = 10log10 ||s_true||^2                     / ||e_spat||^2
    SIR = 10log10 ||s_true + e_spat||^2            / ||e_interf||^2
    SAR = 10log10 ||s_true + e_spat + e_interf||^2 / ||e_artif||^2

Projections solve the block-Toeplitz normal equations built from FFT
cross-correlations of the signals (exact least squares, bss_eval's G matrix).
Energies are per-window sums over channels; silent windows yield NaN
(callers aggregate with nanmedian, ``demucs/evaluate.py:163-166``).
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["bss_eval_images", "project"]

_EPS = np.finfo(np.float64).eps


class _Projector:
    """Least-squares projector onto 0..flen-1 sample delays of ``signals``.

    Factorizes the (n*flen, n*flen) block-Toeplitz Gram once; ``apply``
    projects any target with two FFT passes + one triangular solve.
    """

    def __init__(self, signals: np.ndarray, flen: int):
        from scipy.linalg import cho_factor, toeplitz

        self.signals = np.ascontiguousarray(signals, np.float64)
        self.flen = flen
        n, T = self.signals.shape
        self.nfft = 1 << int(np.ceil(np.log2(T + flen - 1)))
        self.sf = np.fft.rfft(self.signals, self.nfft, axis=-1)

        G = np.empty((n * flen, n * flen), np.float64)
        lags = np.arange(flen)
        for i in range(n):
            for k in range(i, n):
                # r[d] = sum_u s_i[u] s_k[u+d]; no wraparound for |d| < flen
                r = np.fft.irfft(np.conj(self.sf[i]) * self.sf[k], self.nfft)
                # block[a, b] = sum_t s_i[t-a] s_k[t-b] = r[a-b]
                block = toeplitz(r[lags], r[(-lags) % self.nfft])
                G[i * flen:(i + 1) * flen, k * flen:(k + 1) * flen] = block
                if k != i:
                    G[k * flen:(k + 1) * flen, i * flen:(i + 1) * flen] = block.T
        # tiny Tikhonov ridge: G is numerically singular when stems correlate
        ridge = _EPS * max(1.0, float(np.trace(G)) / G.shape[0])
        self._cho = cho_factor(G + ridge * np.eye(G.shape[0]), lower=True)

    def apply(self, target: np.ndarray) -> np.ndarray:
        """Project each target channel: (m, T) -> (m, T)."""
        from scipy.linalg import cho_solve
        from scipy.signal import fftconvolve

        n, T = self.signals.shape
        flen = self.flen
        yf = np.fft.rfft(np.ascontiguousarray(target, np.float64),
                         self.nfft, axis=-1)
        D = np.empty((target.shape[0], n * flen), np.float64)
        lags = np.arange(flen)
        for c in range(target.shape[0]):
            for i in range(n):
                # D[c,(i,a)] = sum_t s_i[t-a] y_c[t] = cc[a]
                cc = np.fft.irfft(np.conj(self.sf[i]) * yf[c], self.nfft)
                D[c, i * flen:(i + 1) * flen] = cc[lags]
        H = cho_solve(self._cho, D.T).T.reshape(target.shape[0], n, flen)

        out = np.zeros((target.shape[0], T), np.float64)
        for c in range(target.shape[0]):
            # P(y_c) = sum_i h[c,i] * s_i  (FIR convolution per regressor)
            acc = fftconvolve(self.signals, H[c], axes=-1)[..., :T]
            out[c] = acc.sum(axis=0)
        return out


def project(signals: np.ndarray, target: np.ndarray, flen: int) -> np.ndarray:
    """One-shot least-squares delayed-copies projection (see _Projector)."""
    return _Projector(signals, flen).apply(target)


def _framed_energy(x: np.ndarray, win: int, hop: int) -> np.ndarray:
    """Per-window energy summed over channels: (C, T) -> (n_frames,)."""
    T = x.shape[-1]
    nwin = int(np.floor((T - win + hop) / hop)) if T >= win else 0
    if nwin <= 0:  # short track: one whole-signal frame
        return np.array([float(np.sum(x * x))])
    out = np.empty(nwin)
    for f in range(nwin):
        seg = x[..., f * hop:f * hop + win]
        out[f] = float(np.sum(seg * seg))
    return out


def _db(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """10log10(num/den) with museval's silent-frame semantics: 0/x -> -inf,
    x/0 -> +inf, 0/0 -> nan (museval divides under errstate and nanmedian
    keeps the infs in the aggregation) — so the native path and an
    installed museval report identical medians for the same track."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return 10.0 * np.log10(np.asarray(num, np.float64)
                               / np.asarray(den, np.float64))


def bss_eval_images(references: np.ndarray, estimates: np.ndarray,
                    window: int, hop: int, flen: int = 512
                    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BSS Eval images metrics, global filters, framed energies.

    references/estimates: ``(nsrc, T, nchan)`` (museval's layout, as used by
    ``demucs/evaluate.py:45-58``). Returns ``(sdr, isr, sir, sar)``, each of
    shape ``(nsrc, n_frames)``.
    """
    refs = np.ascontiguousarray(np.swapaxes(references, 1, 2), np.float64)
    ests = np.ascontiguousarray(np.swapaxes(estimates, 1, 2), np.float64)
    nsrc, nchan, T = refs.shape
    assert ests.shape == refs.shape, (ests.shape, refs.shape)

    # The all-sources projector is shared by every estimated source.
    proj_all = _Projector(refs.reshape(nsrc * nchan, T), flen)

    sdr, isr, sir, sar = [], [], [], []
    for j in range(nsrc):
        est = ests[j]
        s_true = refs[j]
        p_j = project(refs[j], est, flen)
        p_all = proj_all.apply(est)
        e_spat = p_j - s_true
        e_interf = p_all - p_j
        e_artif = est - p_all

        e_true_spat = s_true + e_spat
        num_sdr = _framed_energy(e_true_spat, window, hop)
        sdr.append(_db(num_sdr, _framed_energy(e_interf + e_artif, window, hop)))
        isr.append(_db(_framed_energy(s_true, window, hop),
                       _framed_energy(e_spat, window, hop)))
        sir.append(_db(num_sdr, _framed_energy(e_interf, window, hop)))
        sar.append(_db(_framed_energy(e_true_spat + e_interf, window, hop),
                       _framed_energy(e_artif, window, hop)))
    return (np.stack(sdr), np.stack(isr), np.stack(sir), np.stack(sar))
