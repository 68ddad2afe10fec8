"""Port's STFT/iSTFT (demucs_tpu_torch.ops.spec, kernels K1/K2 on their plain
CPU versions) against demucs_tpu.ops.spec, with method="fft" and with
method="pallas" (Pallas interpret mode on the CPU, as test_pallas_stft.py).

Tolerances: atol 2e-6 on the normalized spectrum and 3e-6 on the round trip,
the bounds the JAX package holds its own Pallas kernels to: both sides sum
the same fp32 products in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops import spec as S
from demucs_tpu.ops.pallas import stft as PS
from demucs_tpu_torch.kernels import stft as K
from demucs_tpu_torch.ops import spec as T

METHODS = ["fft", "pallas"]


@pytest.fixture(autouse=True)
def _interpret():
    old = PS._INTERPRET
    PS._INTERPRET = True
    yield
    PS._INTERPRET = old


def _signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(1, 44100), (2, 3, 22050)])
def test_stft_matches_jax(shape, method):
    x = _signal(shape, 0)
    want = np.asarray(S.stft(jnp.asarray(x), 4096, 1024, method=method))
    got = T.stft(torch.from_numpy(x), 4096, 1024).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("method", METHODS)
def test_istft_matches_jax(method):
    x = _signal((2, 44100), 1)
    z = np.array(S.stft(jnp.asarray(x), 4096, 1024, method="fft"))  # writable copy
    want = np.asarray(S.istft(jnp.asarray(z), 4096, 1024, length=44100, method=method))
    got = T.istft(torch.from_numpy(z), 4096, 1024, length=44100).numpy()
    np.testing.assert_allclose(got, want, atol=3e-6)
    # length=None trims the center pad on both ends, as torch.istft does
    want = np.asarray(S.istft(jnp.asarray(z), 4096, 1024, method=method))
    got = T.istft(torch.from_numpy(z), 4096, 1024).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-6)


def test_istft_roundtrip():
    x = _signal((2, 44100), 1)
    z = T.stft(torch.from_numpy(x), 4096, 1024)
    y = T.istft(z, 4096, 1024, length=44100).numpy()
    np.testing.assert_allclose(y, x, atol=3e-6)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("length", [8192, 7001])
def test_demucs_spec_and_ispec_match_jax(method, length):
    x = _signal((1, 2, length), 2)
    want = np.asarray(S.demucs_spec(jnp.asarray(x), 2048, method=method))
    got = T.demucs_spec(torch.from_numpy(x), 2048).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    back_want = np.asarray(S.demucs_ispec(jnp.asarray(want), length, method=method))
    back = T.demucs_ispec(torch.from_numpy(got), length).numpy()
    assert back.shape == (1, 2, length)
    np.testing.assert_allclose(back, back_want, atol=3e-6)


@pytest.mark.parametrize("hybrid_old", [False, True])
def test_demucs_spec_conventions(hybrid_old):
    """Short inputs (reflect pad longer than the signal) and the hybrid_old
    constant padding follow the JAX package."""
    x = _signal((1, 2, 300), 3)
    want = np.asarray(S.demucs_spec(jnp.asarray(x), 1024, hybrid_old=hybrid_old,
                                    method="fft"))
    got = T.demucs_spec(torch.from_numpy(x), 1024, hybrid_old=hybrid_old).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    back_want = np.asarray(S.demucs_ispec(jnp.asarray(want), 300, hybrid_old=hybrid_old,
                                          method="fft"))
    back = T.demucs_ispec(torch.from_numpy(got), 300, hybrid_old=hybrid_old).numpy()
    np.testing.assert_allclose(back, back_want, atol=3e-6)


def test_cac_pack_roundtrip_matches_jax():
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((2, 2, 8, 5)) + 1j * rng.standard_normal((2, 2, 8, 5))
         ).astype(np.complex64)
    want = np.asarray(S.cac_pack(jnp.asarray(z)))
    got = T.cac_pack(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    m = np.stack([want, 2 * want], axis=1)  # (B, S, 2C, F, T)
    np.testing.assert_array_equal(T.cac_unpack(torch.from_numpy(m)).numpy(),
                                  np.asarray(S.cac_unpack(jnp.asarray(m))))


def test_k1_plain_matches_pallas_kernel():
    """K1's plain version == stft_chunk_dft (interpret) on the hop-chunked signal."""
    x = _signal((3, 40 * 512), 5)
    zr, zi = PS.stft_chunk_dft(jnp.asarray(x.reshape(3, 40, 512)), 2048, 512)
    got_r, got_i = K.stft_dft_plain(torch.from_numpy(x), 2048, 512)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(zr), atol=2e-4)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(zi), atol=2e-4)


def test_k2_plain_matches_pallas_kernel():
    """K2's plain version == istft_chunk_dft (interpret), before the envelope."""
    rng = np.random.default_rng(6)
    zr = rng.standard_normal((2, 30, 1025)).astype(np.float32)
    zi = rng.standard_normal((2, 30, 1025)).astype(np.float32)
    want = np.asarray(PS.istft_chunk_dft(jnp.asarray(zr), jnp.asarray(zi), 2048, 512))
    got = K.istft_dft_plain(torch.from_numpy(zr), torch.from_numpy(zi), 2048, 512).numpy()
    assert got.shape == want.shape == (2, 29 * 512 + 2048)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cached_bases_outlive_inference_mode():
    """The bases and window envelope are cached on first use; a first use
    under torch.inference_mode must not leave inference tensors in the cache
    that a later autograd-tracked call cannot use."""
    x = torch.from_numpy(_signal((1, 2, 3000), 8))
    with torch.inference_mode():
        T.demucs_ispec(T.demucs_spec(x, 1536), 3000)
    w = torch.ones((), requires_grad=True)
    y = T.demucs_ispec(T.demucs_spec(x * w, 1536), 3000)
    y.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad)


def test_kernel_wrappers_take_plain_version_on_cpu():
    x = torch.from_numpy(_signal((2, 8192), 7))
    before = (K.stft_dft.launches, K.istft_dft.launches)
    zr, zi = K.stft_dft(x, 2048, 512)
    y = K.istft_dft(zr, zi, 2048, 512)
    assert y.shape == (2, (zr.shape[1] - 1) * 512 + 2048)
    assert (K.stft_dft.launches, K.istft_dft.launches) == before
    with pytest.raises(ValueError):
        K.istft_dft(zr, zi, 2048, 500)  # n_fft % hop != 0
