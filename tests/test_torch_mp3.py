"""The port's mp3 codec (demucs_tpu_torch/mp3io.py: libmp3lame encode,
libmpg123 decode) against the JAX package's mp3io on the same PCM, made from
a seed with numpy.

Tolerance: none between the port and JAX (the same libraries with the same
settings must give the same bytes and the same decoded samples); the round
trip itself is lossy and held to an SNR, as in tests/test_mp3.py. The tests
skip where the libraries are absent.
"""

import numpy as np
import pytest

from demucs_tpu import audio as jaudio
from demucs_tpu import mp3io as jmp3
from demucs_tpu_torch import audio, mp3io


@pytest.fixture
def libs():
    if not (mp3io.lame_available() and mp3io.mpg123_available()):
        pytest.skip("libmp3lame or libmpg123 is absent")


def _signal(channels=2, seconds=1.0, sr=44100, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = [0.45 * np.sin(2 * np.pi * 220.0 * (c + 1) * t) + 0.02 * rng.standard_normal(t.size)
            for c in range(channels)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("channels,bitrate,quality,int16", [
    (2, 320, 2, False), (1, 192, 5, False), (2, 128, 7, True)])
def test_lame_bytes_equal_jax(libs, channels, bitrate, quality, int16):
    wav = _signal(channels, seed=channels + quality)
    wav[0, :10] = 1.5  # the clamp of the reference's i16 conversion
    if int16:
        wav = (np.clip(wav, -1, 1) * (2**15 - 1)).astype(np.int16)
    assert mp3io.encode_mp3(wav, 44100, bitrate, quality) == jmp3.encode_mp3(
        wav, 44100, bitrate, quality)


def test_decode_equals_jax_and_keeps_length(libs, tmp_path):
    wav = _signal(2, seconds=1.3, seed=3)
    path = tmp_path / "x.mp3"
    mp3io.write_mp3(path, wav, 44100, bitrate=320, quality=2)
    got, sr = mp3io.read_mp3(path)
    want, jsr = jmp3.read_mp3(path)
    assert sr == jsr == 44100 and got.shape == wav.shape  # gapless: the exact length
    np.testing.assert_array_equal(got, want)
    snr = 10 * np.log10(np.mean(wav**2) / np.mean((got - wav) ** 2))
    assert snr > 28.0


def test_save_audio_mp3_honours_bitrate_and_preset(libs, tmp_path):
    wav = _signal(2, seed=4)
    audio.save_audio(wav, tmp_path / "port.mp3", 44100, bitrate=192, preset=7)
    jaudio.save_audio(wav, tmp_path / "jax.mp3", 44100, bitrate=192, preset=7)
    assert (tmp_path / "port.mp3").read_bytes() == (tmp_path / "jax.mp3").read_bytes()
    audio.save_audio(wav, tmp_path / "best.mp3", 44100, bitrate=192, preset=2)
    assert (tmp_path / "best.mp3").read_bytes() != (tmp_path / "port.mp3").read_bytes()
    got, sr = audio.read_audio(tmp_path / "port.mp3")
    assert sr == 44100 and got.shape == wav.shape


def test_encoder_refuses_bad_input(libs):
    with pytest.raises(ValueError, match="1 or 2 channels"):
        mp3io.encode_mp3(np.zeros((3, 100), np.float32), 44100)
    with pytest.raises(ValueError, match="2..7"):
        mp3io.encode_mp3(np.zeros((2, 100), np.float32), 44100, quality=9)
    with pytest.raises(ValueError, match="float or int16"):
        mp3io.encode_mp3(np.zeros((2, 100), np.int32), 44100)
