"""The port's audio input and output (demucs_tpu_torch/audio.py, avio.py and the
CLI's output formats) against the JAX package's, on signals made from a seed
with numpy.

Tolerance: none where both sides run the same decoder (the libavcodec shim,
the port's FLAC codec): the samples must be equal. The CLI's stems are
checked for their files and shapes; the automatic wire for equality with
the JAX CLI's choice. The libavcodec cases skip where the shim cannot be
built; where the ffmpeg binaries exist, the shim path is chosen explicitly.
"""

import itertools
import random

import numpy as np
import pytest

from demucs_tpu import audio as jaudio
from demucs_tpu import avio as javio
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.zoo.native import save_model as jax_save_model
from demucs_tpu_torch import audio, avio, flacio, mp3io
from demucs_tpu_torch import separate as tsep

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SR = 44100


@pytest.fixture
def shim(monkeypatch):
    """The libavcodec shim, with AudioFile on it (not on ffmpeg) in both packages."""
    if not avio.available():
        pytest.skip(f"the libavcodec shim cannot be built: {avio.unavailable_reason()[:200]}")
    monkeypatch.setattr(audio, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(jaudio, "ffmpeg_available", lambda: False)


def _tones(channels=2, seconds=1.0, sr=SR, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = [0.4 * np.sin(2 * np.pi * (220 + 110 * c) * t) + 0.02 * rng.standard_normal(t.size)
            for c in range(channels)]
    return np.stack(rows).astype(np.float32)


def test_audiofile_multistream_equals_jax(shim, tmp_path):
    stems = np.stack([_tones(seed=s) * (0.5 + 0.2 * s) for s in range(3)])
    path = tmp_path / "track.stem.mp4"
    avio.encode_multi(path, stems, SR, "alac")
    port, ref = audio.AudioFile(path), jaudio.AudioFile(path)
    assert len(port) == len(ref) == 3
    assert port.channels(1) == 2 and port.samplerate(2) == SR
    assert port.duration == ref.duration > 0
    np.testing.assert_array_equal(port.read(streams=slice(None)), ref.read(streams=slice(None)))
    one = port.read(streams=1)
    np.testing.assert_array_equal(one, ref.read(streams=1))
    assert one.shape == (2, SR) and np.abs(one - stems[1]).max() < 1e-4
    # sample-exact seek of shim mode
    window = port.read(seek_time=0.25, duration=0.5, streams=0)
    assert window.shape == (2, 22050)
    np.testing.assert_array_equal(window, port.read(streams=0)[:, 11025:33075])
    small = port.read(seek_time=0.25, duration=0.5, streams=0, samplerate=22050, channels=1)
    assert small.shape == (1, 11025)


@pytest.mark.parametrize("kind", ["ogg", "lpc_flac_16", "lpc_flac_24", "wav", "mp3"])
def test_read_audio_routes_and_equals_jax(shim, tmp_path, kind):
    wav = _tones(seed=len(kind))
    if kind == "ogg":
        path = tmp_path / "x.ogg"
        avio.encode(path, wav, SR, "libvorbis", 160000)
    elif kind.startswith("lpc_flac"):
        # libavcodec's encoder at level 8 writes LPC subframes, which the
        # port's own encoder never does: the port's decoder reads them
        bits = int(kind[-2:])
        lim = (1 << (bits - 1)) - 1
        pcm = np.round(wav * lim).astype(np.int32)
        path = tmp_path / "x.flac"
        avio.encode_flac(path, pcm, SR, bits, compression_level=8)
        got, sr, got_bits = flacio.decode_flac(path.read_bytes())
        assert (sr, got_bits) == (SR, bits)
        np.testing.assert_array_equal(got, pcm)
    elif kind == "wav":
        path = tmp_path / "x.wav"
        audio.write_wav(path, wav, SR, bits_per_sample=24)
    else:
        if not mp3io.lame_available():
            pytest.skip("libmp3lame is absent")
        path = tmp_path / "x.mp3"
        mp3io.write_mp3(path, wav, SR)
    got, sr = audio.read_audio(path)
    want, jsr = jaudio.read_audio(path)
    assert sr == jsr == SR
    np.testing.assert_array_equal(got, want)
    got, sr = audio.read_audio(path, samplerate=22050, channels=1)
    assert sr == 22050 and got.shape[0] == 1


def test_read_audio_without_any_decoder_raises(tmp_path, monkeypatch):
    path = tmp_path / "x.ogg"
    path.write_bytes(b"OggS" + bytes(100))
    monkeypatch.setattr(audio, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(avio, "available", lambda: False)
    with pytest.raises(RuntimeError, match="neither the libavcodec shim nor the ffmpeg"):
        audio.read_audio(path)


def test_duration_is_never_negative(shim, tmp_path):
    """A FLAC whose STREAMINFO states no length (total samples 0, as a
    streaming encoder writes it): the container and its stream state no
    duration. JAX's AudioFile returns -1.0 here; the port decodes the stream."""
    pcm = np.round(_tones(seconds=0.5) * 32767).astype(np.int32)
    data = bytearray(flacio.encode_flac(pcm, SR, 16))
    packed = int.from_bytes(data[18:26], "big") & ~((1 << 36) - 1)
    data[18:26] = packed.to_bytes(8, "big")
    path = tmp_path / "nolength.flac"
    path.write_bytes(bytes(data))
    streams, stated = avio.probe(path)
    assert stated < 0 and streams[0]["frames"] == 0  # nothing is stated
    assert audio.AudioFile(path).duration == 0.5
    assert jaudio.AudioFile(path).duration == -1.0  # the behaviour not copied


@pytest.mark.parametrize("order", ["stereo_then_mono", "mono_then_stereo"])
def test_shim_refuses_a_channel_change_mid_stream(shim, tmp_path, order):
    """Two mp3 streams of 2 and 1 channels, back to back. The JAX shim copies
    planes by the stream's first channel count: mono frames after stereo ones
    read a plane that does not exist (a crash), stereo after mono drops a
    channel silently. The port's shim refuses the file."""
    if not mp3io.lame_available():
        pytest.skip("libmp3lame is absent")
    stereo, mono = mp3io.encode_mp3(_tones(2), SR, 128), mp3io.encode_mp3(_tones(1), SR, 128)
    path = tmp_path / "chained.mp3"
    path.write_bytes(stereo + mono if order == "stereo_then_mono" else mono + stereo)
    with pytest.raises(RuntimeError, match="channel count or sample format changed"):
        avio.decode_file(path)
    if order == "mono_then_stereo":  # JAX decodes it without a word (one channel)
        assert javio.decode_file(path)[0].shape[0] == 1


@pytest.mark.parametrize("bits", [16, 24])
def test_save_audio_flac_equals_jax(tmp_path, bits):
    wav = _tones(seed=bits) * 1.3  # past full scale: the clip mode acts
    audio.save_audio(wav, tmp_path / "port.flac", SR, bits_per_sample=bits)
    jaudio.save_audio(wav, tmp_path / "jax.flac", SR, bits_per_sample=bits)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    got, sr = audio.read_audio(tmp_path / "port.flac")
    assert sr == SR and got.shape == wav.shape
    with pytest.raises(ValueError, match="Invalid suffix"):
        audio.save_audio(wav, tmp_path / "x.ogg", SR)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    root = tmp_path_factory.mktemp("repo")
    cfg = jht.HTDemucsConfig(sources=("drums", "bass", "other", "vocals"), channels=8,
                             depth=4, nfft=2048, t_layers=2, t_heads=2, segment=0.5,
                             samplerate=8000)
    jax_save_model(JaxModel("htdemucs", cfg, jht.init_htdemucs(cfg, seed=5)), root / "tiny.dmx")
    return root


@pytest.mark.parametrize("fmt", ["flac", "mp3"])
def test_cli_writes_flac_and_mp3_stems(repo, tmp_path, fmt):
    if fmt == "mp3" and not mp3io.lame_available():
        pytest.skip("libmp3lame is absent")
    track = tmp_path / "song.flac"  # a FLAC input, read by the port's own codec
    audio.save_audio(_tones(seconds=0.6, sr=8000), track, 8000)
    out = tmp_path / "out"
    random.seed(3)
    tsep.main([str(track), "--repo", str(repo), "-n", "tiny", "-o", str(out), "-d", "cpu",
               "--batch-size", "2", f"--{fmt}", "--mp3-bitrate", "64", "--mp3-preset", "7"])
    stems = sorted((out / "tiny" / "song").glob("*"))
    assert [p.name for p in stems] == [f"{s}.{fmt}" for s in ("bass", "drums", "other",
                                                               "vocals")]
    for path in stems:
        wav, sr = audio.read_audio(path)
        assert sr == 8000 and wav.shape == (2, 4800)


_FLAGS = [[]] + [[f] for f in ("--float32", "--int24", "--flac", "--mp3")] + [
    [d, f] for d, f in itertools.product(("--float32", "--int24"), ("--flac", "--mp3"))]


@pytest.mark.parametrize("flags", _FLAGS, ids=lambda f: "+".join(f) or "wav16")
def test_auto_wire_follows_jax_rule(flags, monkeypatch):
    """For each combination of depth and format flags, the port's CLI asks its
    Separator for the wire the JAX CLI asks for."""
    from demucs_tpu import runtime
    from demucs_tpu import separate as jsep

    seen = {}

    class Stop(Exception):
        pass

    def stub(key):
        def make(*args, **kwargs):
            seen[key] = kwargs["transfer_dtype"]
            raise Stop

        return make

    monkeypatch.setattr(runtime, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jsep, "Separator", stub("jax"))
    monkeypatch.setattr(tsep, "Separator", stub("port"))
    for key, main in (("jax", jsep.main), ("port", tsep.main)):
        with pytest.raises(Stop):
            main(["track.wav", "-n", "tiny", *flags])
    assert seen["port"] == seen["jax"]
    args = tsep.get_parser().parse_args(["t.wav", *flags])
    assert tsep.auto_wire(args) == ("int16" if not flags else "float16")
