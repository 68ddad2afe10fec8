"""Port's sinc resampler (demucs_tpu_torch.ops.resample) against
demucs_tpu.ops.resample.resample_frac, and convert_audio and read_audio at
another sample rate than the model's, on the CPU.

Tolerance: 1e-6 absolute on signals of unit peak (the same float64-built
kernels in float32, one convolution summed in another order); the kernel
banks are equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu import audio as jaudio
from demucs_tpu.ops import resample as jr
from demucs_tpu_torch import audio
from demucs_tpu_torch.ops import resample as tr

ATOL = 1e-6


def _signal(*shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    return (x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("old,new", [(1, 2), (2, 1), (48000, 44100), (44100, 16000),
                                     (3, 5), (22050, 44100)])
def test_resample_frac_matches_jax(old, new):
    x = _signal(2, 3, 3001)
    want = np.asarray(jr.resample_frac(jnp.asarray(x), old, new))
    got = tr.resample_frac(torch.from_numpy(x), old, new).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ATOL


def test_kernel_bank_is_the_jax_one():
    for args in [(1, 2, 24, 0.945), (160, 147, 24, 0.945)]:
        got, width = tr._kernels_np(*args)
        want, want_width = jr._kernels_np(*args)
        assert width == want_width and np.array_equal(got, want)


def test_constant_stays_constant():
    y = tr.resample_frac(torch.ones(1, 1, 1000), 1, 2)
    assert y.shape == (1, 1, 2000) and (y - 1).abs().max() < 5e-6


def test_convert_audio_from_48k_matches_jax(tmp_path):
    wav = _signal(1, 4800, seed=1)  # mono, 0.1 s at 48 kHz
    want = jaudio.convert_audio(wav, 48000, 44100, 2)
    got = audio.convert_audio(wav, 48000, 44100, 2)
    assert got.shape == want.shape == (2, 4410)
    assert np.abs(got - want).max() <= ATOL
    path = tmp_path / "t.wav"
    audio.write_wav(path, _signal(2, 4800, seed=2), 48000, as_float=True)
    read, sr = audio.read_audio(path, samplerate=44100, channels=2)
    jread, jsr = jaudio.read_audio(path, samplerate=44100, channels=2)
    assert sr == jsr == 44100 and read.shape == (2, 4410)
    assert np.abs(read - jread).max() <= ATOL
