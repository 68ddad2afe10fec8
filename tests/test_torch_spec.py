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

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

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


def _fft_model(c, tw):
    """csrc/stft.cu::fft_shared, stage by stage: forward complex FFT of the
    last axis (h points) by Stockham radix-2/4 stages, each radix-4 stage's
    twiddles read from its run of the wrapper's table ``tw``."""
    h = c.shape[-1]
    log2h = h.bit_length() - 1
    a, ns = c, 1
    if log2h & 1:
        v0, v1 = a[..., : h // 2], a[..., h // 2 :]
        a, ns = torch.stack([v0 + v1, v0 - v1], dim=-1).reshape(c.shape), 2
    q = h // 4
    j = torch.arange(q)
    off = h + 1  # past the split's W^m, m = 0..h
    while ns < h:
        k = j % ns
        w = [1] + [tw[off + (r - 1) * ns + k] for r in (1, 2, 3)]
        v0, v1, v2, v3 = (a[..., j + r * q] * w[r] for r in range(4))
        s0, s1, s2, s3 = v0 + v2, v0 - v2, v1 + v3, -1j * (v1 - v3)
        d = (j - k) * 4 + k
        b = torch.empty_like(a)
        b[..., d], b[..., d + ns], b[..., d + 2 * ns], b[..., d + 3 * ns] = (
            s0 + s2, s1 + s3, s0 - s2, s1 - s3)
        a, off, ns = b, off + 3 * ns, ns * 4
    assert off == tw.shape[0]
    return a


def _k1_model(x, n_fft, hop):
    """K1 as the kernel computes it: window, pack pairs, half-length FFT, split."""
    win, tw = K._fft_tables(n_fft, x.device)
    tw = torch.complex(tw[:, 0], tw[:, 1])
    h = n_fft // 2
    y = x.unfold(-1, n_fft, hop) * win
    c = _fft_model(torch.complex(y[..., 0::2], y[..., 1::2]), tw)
    m = torch.arange(h + 1)
    p, q = c[..., m % h], c[..., (h - m) % h].conj()
    z = (p + q) / 2 + tw[m] * (p - q) / 2j
    return z.real, z.imag


def _k2_model(zr, zi, n_fft, hop):
    """K2 as the kernel computes it: fold the bins (imaginary DC and Nyquist
    ignored), forward FFT of the conjugate, unpack, window, overlap-add in
    order of frames."""
    win, tw = K._fft_tables(n_fft, zr.device)
    tw = torch.complex(tw[:, 0], tw[:, 1])
    h = n_fft // 2
    zi = zi.clone()
    zi[..., 0] = zi[..., h] = 0
    x = torch.complex(zr, zi)
    m = torch.arange(h)
    p, q = x[..., m], x[..., h - m].conj()
    c = (p + q) / 2 + 1j * (p - q) / 2 * tw[m].conj()
    f = _fft_model(c.conj(), tw).conj() / h
    frames = torch.stack([f.real, f.imag], dim=-1).reshape(*zr.shape[:-1], n_fft) * win
    rows, n_frames, _ = zr.shape
    out = zr.new_zeros(rows, (n_frames - 1) * hop + n_fft)
    for t in range(n_frames):
        out[:, t * hop : t * hop + n_fft] += frames[:, t]
    return out


@pytest.mark.parametrize("n_fft,hop", [(256, 100), (512, 128), (2048, 512)])
def test_fft_kernels_algorithm_matches_plain(n_fft, hop):
    """The kernels' FFT algorithm (half-length packing, Stockham stages with
    the wrapper's twiddle table, the split and the fold), modelled in torch
    on the CPU, against the plain dense versions: 1e-4 x peak, the kernels'
    tolerance on the card."""
    x = torch.from_numpy(_signal((3, 9 * n_fft + 37), 9))
    got, want = _k1_model(x, n_fft, hop), K.stft_dft_plain(x, n_fft, hop)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    if n_fft % hop:
        return
    rng = np.random.default_rng(10)
    zr, zi = (torch.from_numpy(rng.standard_normal((2, 11, n_fft // 2 + 1)).astype(np.float32))
              for _ in range(2))
    zi[..., 0] = zi[..., -1] = 5.0  # imaginary DC and Nyquist contribute nothing
    got, want = _k2_model(zr, zi, n_fft, hop), K.istft_dft_plain(zr, zi, n_fft, hop)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("n_fft,hop,group", [(4096, 1024, 8), (512, 64, 8), (16384, 4096, 8),
                                             (8192, 8192, 4), (16384, 16384, 2)])
def test_istft_group_fits_shared_memory(n_fft, hop, group):
    """K2's output chunks per block: 8, or fewer where the FFT buffer (4 n_fft
    bytes) and the accumulator (4 group hop bytes) would pass 227 KB."""
    assert K.istft_group(n_fft, hop) == group
    assert 4 * n_fft + 4 * group * hop <= K.SMEM_MAX


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
