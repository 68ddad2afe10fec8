"""The port's BSS-eval (demucs_tpu_torch.ops.bsseval) against
demucs_tpu.ops.bsseval on the same numpy inputs: the same float64 algorithm,
so every metric within 1e-9 dB, with NaN and inf in the same frames."""

import numpy as np
import pytest

from demucs_tpu.ops import bsseval as jbss
from demucs_tpu_torch.ops import bsseval as tbss

SR = 8000
FLEN = 128  # shorter taps than museval's 512: the same algebra, faster


def _case(kind, nsrc=3, nchan=2, seconds=3, seed=0):
    rng = np.random.default_rng(seed)
    T = seconds * SR
    raw = rng.standard_normal((nsrc, nchan, T + 8))
    refs = np.stack([[np.convolve(c, np.ones(9) / 9.0, "valid") for c in s] for s in raw])
    if kind == "noisy":
        ests = refs + 0.3 * rng.standard_normal(refs.shape)
    elif kind == "leaky":  # each estimate holds some of the next source
        ests = refs + 0.2 * np.roll(refs, 1, axis=0) + 0.05 * rng.standard_normal(refs.shape)
    else:  # "silent": a silent second of one source, in its reference and estimate
        refs[1, :, SR:2 * SR] = 0.0
        ests = refs + 0.1 * rng.standard_normal(refs.shape)
        ests[1, :, SR:2 * SR] = 0.0
    return np.swapaxes(refs, 1, 2), np.swapaxes(ests, 1, 2)  # museval's (nsrc, T, nchan)


@pytest.mark.parametrize("kind", ["noisy", "leaky", "silent"])
def test_bss_eval_images_matches_jax(kind):
    refs, ests = _case(kind)
    want = jbss.bss_eval_images(refs, ests, window=SR, hop=SR, flen=FLEN)
    got = tbss.bss_eval_images(refs, ests, window=SR, hop=SR, flen=FLEN)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 3)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.array_equal(np.isinf(g), np.isinf(w))
        fin = np.isfinite(w)
        assert np.abs(g[fin] - w[fin]).max() <= 1e-9


def test_project_matches_jax():
    refs, ests = _case("leaky", nsrc=2)
    signals = np.swapaxes(refs, 1, 2).reshape(4, -1)
    target = np.swapaxes(ests, 1, 2)[0]
    want = jbss.project(signals, target, FLEN)
    got = tbss.project(signals, target, FLEN)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_short_track_is_one_frame():
    refs, ests = _case("noisy", seconds=1)
    refs, ests = refs[:, :SR // 2], ests[:, :SR // 2]
    sdr = tbss.bss_eval_images(refs, ests, window=SR, hop=SR, flen=FLEN)[0]
    assert sdr.shape == (3, 1) and np.isfinite(sdr).all()
