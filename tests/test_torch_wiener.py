"""Port's Wiener EM filter (demucs_tpu_torch.ops.wiener) against
demucs_tpu.ops.wiener on the CPU: apply_wiener over 300-frame windows (the
last one zero-padded), with and without the residual, and wiener on one
window, on seeded complex mixtures and magnitudes.

Tolerance: 1e-5 x peak. Both compute in complex64; the EM's products and
the closed-form 2x2 inverse sum in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops import wiener as jw
from demucs_tpu_torch.ops import wiener as tw

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-5


def _inputs(B=1, S=4, C=2, F=48, T=640, seed=0, scale=30.0):
    rng = np.random.default_rng(seed)
    mix = ((rng.standard_normal((B, C, F, T)) + 1j * rng.standard_normal((B, C, F, T)))
           * scale).astype(np.complex64)
    mags = (np.abs(rng.standard_normal((B, S, C, F, T))) * scale).astype(np.float32)
    return mags, mix


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("niters,residual,B", [(0, False, 1), (1, False, 2), (2, False, 1),
                                              (1, True, 1), (3, True, 2)])
def test_apply_wiener_matches_jax(niters, residual, B):
    mags, mix = _inputs(B=B, seed=niters)
    want = np.asarray(jw.apply_wiener(jnp.asarray(mags), jnp.asarray(mix), niters,
                                      residual=residual))
    got = tw.apply_wiener(torch.from_numpy(mags), torch.from_numpy(mix), niters,
                          residual=residual).numpy()
    _close(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_wiener_one_window_matches_jax(channels):
    """C = 1 and 2 take the closed-form inverses, C = 3 the general one; a
    quiet mixture (max |x| under 10) is not rescaled."""
    mags, mix = _inputs(C=channels, T=50, seed=channels, scale=1.0 if channels == 3 else 30.0)
    m = np.transpose(mags[0], (3, 2, 1, 0))  # (T, F, C, S)
    x = np.transpose(mix[0], (2, 1, 0))  # (T, F, C)
    want = np.asarray(jw.wiener(jnp.asarray(m), jnp.asarray(x), 2, residual=True))
    got = tw.wiener(torch.from_numpy(m), torch.from_numpy(x), 2, residual=True).numpy()
    _close(got, want)


def test_estimates_sum_to_the_mixture():
    """The EM gains sum to the identity: the sources add up to the mixture."""
    mags, mix = _inputs(T=300, seed=9)
    out = tw.apply_wiener(torch.from_numpy(mags), torch.from_numpy(mix), 2).numpy()
    err = np.abs(out.sum(axis=1) - mix).max()
    assert err <= 1e-3 * np.abs(mix).max()
