"""The port's WAV window reader (csrc/wavio.cpp through demucs_tpu_torch.native)
against its plain twin, the port's Python reader (audio.read_wav +
convert_audio_channels), and against the JAX package's C++ reader
(demucs_tpu.native.read_wav_window) on the same files; the prefetcher's
examples; the training set's tail window (tests/test_native.py:32-81).

Tolerances: the windows are equal bit for bit (the same decode, operation
for operation); the prefetcher's normalized examples within 1e-6 of
(window - mean) / std computed in numpy (it multiplies by 1/std in fp32).
"""

import numpy as np
import pytest

from demucs_tpu import native as jnative
from demucs_tpu_torch import audio as ta
from demucs_tpu_torch import native

FORMATS = [("i16", 16, False), ("i24", 24, False), ("i32", 32, False), ("f32", 32, True)]


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    files = {}
    for name, bits, as_float in FORMATS:
        wav = np.clip(rng.standard_normal((2, 5000)) * 0.3, -0.99, 0.99).astype(np.float32)
        path = root / f"{name}.wav"
        ta.write_wav(path, wav, 44100, bits_per_sample=bits, as_float=as_float)
        files[name] = path
    mono = np.clip(rng.standard_normal((1, 3000)) * 0.3, -0.99, 0.99).astype(np.float32)
    ta.write_wav(root / "mono.wav", mono, 44100)
    files["mono"] = root / "mono.wav"
    return files


def _plain(path, offset, frames, channels, out=None):
    """The Python reader's window, zero-padded to ``frames`` (into ``out``)."""
    wav, _ = ta.read_wav(path, frame_offset=offset, num_frames=frames)
    wav = np.pad(ta.convert_audio_channels(wav, channels), [(0, 0), (0, frames - wav.shape[-1])])
    if out is not None:
        out[...] = wav
    return wav


def test_info_matches_the_header(wav_files):
    for name, bits, as_float in FORMATS:
        info = native.wav_info(wav_files[name])
        assert info == {"samplerate": 44100, "channels": 2, "frames": 5000, "bits": bits,
                        "format": 3 if as_float else 1}
        jinfo = jnative.wav_info(wav_files[name])
        assert all(info[k] == jinfo[k] for k in jinfo)


@pytest.mark.parametrize("name", [f[0] for f in FORMATS])
@pytest.mark.parametrize("offset,frames,channels", [
    (1000, 2000, 2), (0, 5000, 2), (4000, 2000, 2), (0, 5000, 1), (4500, 1000, 1), (6000, 300, 2)])
def test_window_is_bit_equal_to_both_readers(wav_files, name, offset, frames, channels):
    """Windows inside the file, through its end (zero tail), past it, and
    the mono downmix."""
    path = wav_files[name]
    got = native.read_wav_window(path, offset, frames, channels)
    assert got.shape == (channels, frames) and got.dtype == np.float32
    into = np.full((3, channels, frames), 7.0, np.float32)  # one stem of an example
    assert np.shares_memory(native.read_wav_window(path, offset, frames, channels, out=into[1]),
                            into)
    np.testing.assert_array_equal(into[1], got)
    assert (into[[0, 2]] == 7.0).all()
    np.testing.assert_array_equal(got, _plain(path, offset, frames, channels))
    np.testing.assert_array_equal(got, jnative.read_wav_window(path, offset, frames, channels))
    if offset + frames > 5000:
        assert (got[:, max(0, 5000 - offset):] == 0).all()


def test_mono_file_is_upmixed(wav_files):
    got = native.read_wav_window(wav_files["mono"], 100, 2000, 2)
    np.testing.assert_array_equal(got, _plain(wav_files["mono"], 100, 2000, 2))
    np.testing.assert_array_equal(got[0], got[1])


def test_errors_raise(wav_files, tmp_path):
    with pytest.raises(ValueError, match="cannot open"):
        native.read_wav_window(tmp_path / "missing.wav", 0, 10, 2)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError, match="RIFF"):
        native.wav_info(bad)
    with pytest.raises(ValueError, match="fewer channels"):
        native.read_wav_window(wav_files["i16"], 0, 10, 3)
    with pytest.raises(ValueError, match="bad window"):
        native.read_wav_window(wav_files["i16"], -1, 10, 2)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.read_wav_window(wav_files["i16"], 0, 10, 2, out=np.empty((10, 2), np.float32).T)


def test_prefetcher_examples(wav_files):
    files = [wav_files["i16"], wav_files["f32"], wav_files["i24"], wav_files["i32"]]
    offsets = (0, 500, 2500, 4900)
    with native.NativePrefetcher(channels=2, frames=3000, sources=4, num_threads=3) as pf:
        for offset in offsets:
            pf.add_job(files, offset, mean=0.1, std=2.0)
        pf.start()
        assert len(pf) == len(offsets)
        for i in reversed(range(len(offsets))):  # any order
            example = pf.get(i)
            assert example.shape == (4, 2, 3000)
            for s, f in enumerate(files):
                window = native.read_wav_window(f, offsets[i], 3000, 2)
                np.testing.assert_allclose(example[s], (window - 0.1) / 2.0, atol=1e-6)
        with pytest.raises(IndexError):
            pf.get(len(offsets))


def test_prefetcher_reports_a_failed_job(wav_files, tmp_path):
    with native.NativePrefetcher(channels=2, frames=100, sources=1, num_threads=2) as pf:
        pf.add_job([wav_files["i16"]], 0)
        pf.add_job([tmp_path / "missing.wav"], 0)
        pf.start()
        assert pf.get(0).shape == (1, 2, 100)
        with pytest.raises(ValueError, match="cannot open"):
            pf.get(1)
        with pytest.raises(RuntimeError):
            pf.add_job([wav_files["i16"]], 0)


@pytest.mark.parametrize("channels", [2, 1])
def test_wavset_tail_window_matches_the_python_reader(tmp_path, monkeypatch, channels):
    """The training set's windows through the C++ reader equal the Python
    reader's, the tail's padding lands after the normalization (true zeros,
    demucs/wav.py:163-184), and the JAX package's Wavset gives the same."""
    from demucs_tpu.train.wav import Wavset as JaxWavset
    from demucs_tpu_torch.train import wav as twav

    sources = ("drums", "bass", "other", "vocals")
    rng = np.random.default_rng(3)
    tdir = tmp_path / "train" / "Track"
    tdir.mkdir(parents=True)
    sr, length = 8000, 3 * 8000
    for s in sources:
        wav = (rng.standard_normal((2, length)) * 0.2 + 0.05).astype(np.float32)
        ta.write_wav(tdir / f"{s}.wav", wav, sr, bits_per_sample=24)
    meta = twav.build_metadata(tmp_path / "train", list(sources))
    kw = dict(segment=2.0, shift=1.5, samplerate=sr, channels=channels, normalize=True)
    ds = twav.Wavset(tmp_path / "train", meta, list(sources), **kw)
    tail = len(ds) - 1  # runs past the end of the file
    got = [ds[i] for i in range(len(ds))]
    jax_set = JaxWavset(tmp_path / "train", meta, list(sources), **kw)
    for i, example in enumerate(got):
        np.testing.assert_allclose(example, jax_set[i], atol=1e-6)
    assert np.abs(got[tail][..., -1000:]).max() == 0.0
    monkeypatch.setattr(native, "read_wav_window", _plain)  # the plain twin
    for i, example in enumerate(got):
        np.testing.assert_array_equal(example, ds[i])
