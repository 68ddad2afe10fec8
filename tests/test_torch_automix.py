"""The port's beat tracker and chroma (demucs_tpu_torch.ops.beats) and its
automix tool (demucs_tpu_torch.automix) against the JAX package's
(demucs_tpu.ops.beats, tools/automix.py) on synthetic songs made from a seed.

The beats functions are the same numpy arithmetic: bit-equal. The automix
functions match, pitch-shift, align and build from the same catalog with
both ``random`` states seeded alike: the same choices, and the same audio
within 1e-6 (the repitch augment's parity, tests/test_torch_timestretch.py:
the same numpy and scipy arithmetic, operation for operation).
"""

import importlib.util
import random
import wave
from pathlib import Path

import numpy as np
import pytest

from demucs_tpu.ops import beats as jbeats
from demucs_tpu.train.wav import Wavset as JWavset
from demucs_tpu.train.wav import build_metadata as jbuild_metadata
from demucs_tpu_torch import automix as tmix
from demucs_tpu_torch.ops import beats as tbeats
from demucs_tpu_torch.train.wav import Wavset as TWavset
from demucs_tpu_torch.train.wav import build_metadata as tbuild_metadata

SR = 44100
PARITY = 1e-6
# (bpm, bass Hz, first beat s) of the synthetic songs: 126 and 63 (half time) fit 120
SONGS = {"song_a": (120.0, 110.0, 0.30), "song_b": (126.0, 123.47, 0.55),
         "song_c": (63.0, 103.83, 0.20)}
SONG_SECONDS = 6.0


def _jax_automix():
    spec = importlib.util.spec_from_file_location(
        "jax_automix", Path(__file__).resolve().parent.parent / "tools" / "automix.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jmix = _jax_automix()


def _clicks(bpm: float, first: float, seconds: float, sr: int, seed: int) -> np.ndarray:
    """Decaying noise bursts on every beat."""
    rng = np.random.default_rng(seed)
    y = np.zeros(int(seconds * sr))
    burst = rng.standard_normal(int(0.03 * sr)) * np.exp(-np.arange(int(0.03 * sr)) / (0.005 * sr))
    t = first
    while t < seconds - 0.05:
        i = int(t * sr)
        y[i:i + len(burst)] += burst[:len(y) - i]
        t += 60.0 / bpm
    return y


def _tone(freq: float, seconds: float, sr: int, bpm: float = 0.0) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    y = np.sin(2 * np.pi * freq * t)
    if bpm:  # a note on every beat
        y *= 0.5 + 0.5 * np.cos(2 * np.pi * t * bpm / 60.0) ** 2
    return y


def _write(path: Path, wav: np.ndarray, sr: int = SR) -> None:
    pcm = np.clip(np.round(wav.T * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(wav.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _song(folder: Path, seed: int, bpm: float, bass_hz: float, first: float) -> None:
    folder.mkdir(parents=True)
    rng = np.random.default_rng(100 + seed)
    stems = {"drums": 0.5 * _clicks(bpm, first, SONG_SECONDS, SR, seed),
             "bass": 0.4 * _tone(bass_hz, SONG_SECONDS, SR, bpm),
             "other": 0.2 * _tone(bass_hz * 3, SONG_SECONDS, SR),
             "vocals": 0.2 * _tone(440.0 + 20 * seed, SONG_SECONDS, SR)}
    mix = 0
    for name, mono in stems.items():
        wav = np.stack([mono, mono]) + 0.01 * rng.standard_normal((2, len(mono)))
        mix = mix + wav
        _write(folder / f"{name}.wav", wav)
    _write(folder / "mixture.wav", mix / 2)


@pytest.fixture(scope="module")
def musdb(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("musdb")
    for seed, (name, (bpm, hz, first)) in enumerate(SONGS.items()):
        _song(root / "train" / name, seed, bpm, hz, first)
    return root


@pytest.fixture(scope="module")
def catalogs(musdb, tmp_path_factory):
    """Each side's analysis of the three songs (its own Wavset, trackers and
    cache), and the tool's with its bass histograms as (12, 1) columns: the
    tool's analyse_track writes them (12,), which its best_pitch_shift
    cannot take (a numpy AxisError once a donor fits the tempo); the port
    keeps them (12, 1)."""
    out = {}
    root = musdb / "train"
    metadata = tbuild_metadata(root, tmix.SOURCES, normalize=False)  # sorted by name
    assert metadata == jbuild_metadata(root, tmix.SOURCES, normalize=False)
    for side, mix, wavset in (("port", tmix, TWavset), ("jax", jmix, JWavset)):
        dset = wavset(root, metadata, tmix.SOURCES, samplerate=SR, channels=2, normalize=False)
        dset.sig = "synthetic"
        cache = tmp_path_factory.mktemp(f"cache_{side}")
        analyses = [mix.analyse_track(dset, i, cache) for i in range(len(dset))]
        assert all(a is not None for a, _ in analyses), side
        out[side] = [a for a, _ in analyses]
    return out["port"], out["jax"], [a.with_(chroma_hist=a.chroma_hist[:, None])
                                     for a in out["jax"]]


# ---- beats ----

def _signals():
    sr = 22050
    return {
        "clicks_100": (_clicks(100.0, 0.1, 8.0, sr, 1), sr),
        "clicks_140_stereo": (np.stack([_clicks(140.0, 0.25, 6.0, sr, 2)] * 2), sr),
        "tone_chord": (_tone(220.0, 3.0, sr) + 0.5 * _tone(277.18, 3.0, sr), sr),
        "silence": (np.zeros(sr), sr),
        "short": (_clicks(120.0, 0.0, 0.3, sr, 3), sr),
    }


@pytest.mark.parametrize("name", list(_signals()))
def test_onset_strength_and_tempo_bit_equal(name):
    y, sr = _signals()[name]
    want = jbeats.onset_strength(y, sr)
    got = tbeats.onset_strength(y, sr)
    np.testing.assert_array_equal(got, want)
    assert tbeats._estimate_tempo(got, sr, 512) == jbeats._estimate_tempo(want, sr, 512)


@pytest.mark.parametrize("name", list(_signals()))
@pytest.mark.parametrize("units", ["time", "frames"])
def test_beat_track_bit_equal(name, units):
    y, sr = _signals()[name]
    tempo, beats = tbeats.beat_track(y, sr, units=units)
    want_tempo, want_beats = jbeats.beat_track(y, sr, units=units)
    assert tempo == want_tempo
    np.testing.assert_array_equal(beats, want_beats)
    if name.startswith("clicks_100") and units == "time":
        assert abs(tempo - 100.0) < 5.0 and len(beats) > 8


@pytest.mark.parametrize("name", list(_signals()))
def test_chroma_stft_bit_equal(name):
    y, sr = _signals()[name]
    got = tbeats.chroma_stft(y, sr)
    np.testing.assert_array_equal(got, jbeats.chroma_stft(y, sr))
    assert got.shape[0] == 12


# ---- automix ----

def test_sliding_rms_and_backends():
    x = np.random.default_rng(0).standard_normal((2, 30001))
    np.testing.assert_array_equal(tmix.sliding_rms(x), jmix.sliding_rms(x))
    y, sr = _signals()["clicks_100"]
    track, chroma = tmix._beat_and_chroma_backends()
    want_track, want_chroma = jmix._beat_and_chroma_backends()
    got, want = track(y), want_track(y)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(chroma(y), want_chroma(y))


def test_analyse_track_equal(catalogs):
    port, jax, _ = catalogs
    assert len(port) == len(jax) == len(SONGS)
    for got, want in zip(port, jax):
        assert got.index == want.index and got.tempo == want.tempo
        np.testing.assert_array_equal(got.beats, want.beats)
        assert got.chroma_hist.shape == (12, 1)
        np.testing.assert_array_equal(got.chroma_hist[:, 0], want.chroma_hist)
        np.testing.assert_array_equal(got.stems, want.stems)
    tempos = sorted(a.tempo for a in port)
    assert 55 < tempos[0] < 70 and 110 < tempos[1] < 135  # the clicks' tempi were found


def test_best_pitch_shift_equal(catalogs):
    port, _, _ = catalogs
    rng = np.random.default_rng(5)
    hists = [a.chroma_hist for a in port] + [rng.random((12, 1)) for _ in range(4)]
    for a in hists:
        for b in hists:
            assert tmix.best_pitch_shift(a, b) == jmix.best_pitch_shift(a, b)
    shifted = np.roll(hists[-1], 3)
    assert tmix.best_pitch_shift(shifted, hists[-1]) == 3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_candidate_equal(catalogs, seed):
    port, _, jax = catalogs
    for ref in range(len(port)):
        for pitch_match in (True, False):
            got = want = None
            random.seed(seed)
            try:
                got = tmix.find_candidate(port[ref], port, pitch_match=pitch_match)
            except RuntimeError as err:
                got = str(err)
            random.seed(seed)
            try:
                want = jmix.find_candidate(jax[ref], jax, pitch_match=pitch_match)
            except RuntimeError as err:
                want = str(err)
            if isinstance(want, str):
                assert got == want
                continue
            (cand, delta, semis), (wcand, wdelta, wsemis) = got, want
            assert (cand.index, cand.tempo, delta, semis) == (wcand.index, wcand.tempo, wdelta,
                                                              wsemis)


@pytest.mark.parametrize("source,delta,semitones", [(1, 0.05, 2), (3, -0.1, -1), (0, 0.0, 0)])
def test_borrow_stem_equal(catalogs, source, delta, semitones):
    port, jax, _ = catalogs
    wav, donor = tmix.borrow_stem(port[1], source, delta, semitones)
    want_wav, want_donor = jmix.borrow_stem(jax[1], source, delta, semitones)
    assert wav.shape == want_wav.shape
    assert np.abs(wav - want_wav).max() <= PARITY
    np.testing.assert_array_equal(donor.beats, want_donor.beats)


def test_align_stems_equal(catalogs):
    port, _, _ = catalogs
    parts = [(a.stems[k], a.beats) for k, a in enumerate(port)]
    parts.append((port[0].stems[3][:, :SR * 3], port[0].beats[:3] + 0.01))
    got = tmix.align_stems(parts)
    np.testing.assert_array_equal(got, jmix.align_stems(parts))
    assert got.shape[0] == len(parts)


@pytest.mark.parametrize("seed", [0, 7])
def test_build_track_equal(catalogs, seed):
    port, _, jax = catalogs
    for ref in range(len(port)):
        random.seed(seed)
        try:
            got = tmix.build_track(ref, port)
        except RuntimeError as err:
            got = str(err)
        random.seed(seed)
        try:
            want = jmix.build_track(ref, jax)
        except RuntimeError as err:
            want = str(err)
        if isinstance(want, str):
            assert got == want
            continue
        assert got.shape == want.shape and got.shape[0] == len(tmix.SOURCES)
        assert np.abs(got - want).max() <= PARITY
        assert np.isfinite(got).all() and np.abs(got).max() > 0


def test_main_writes_the_tools_songs(musdb, catalogs, tmp_path):
    """The entry point on the synthetic MusdbHQ folder: one song per catalog
    entry, the mixture and the four stems, each the tool's main loop
    (random.seed(4321), build_track, the shared scale) on the tool's
    catalog, within one step of the 16-bit grid."""
    _, _, jax = catalogs
    out = tmp_path / "automix"
    tmix.main(["--musdb", str(musdb), "--out", str(out), "--cache", str(tmp_path / "cache"),
               "--copies", "1", "--workers", "1"])
    written = sorted(p.relative_to(out) for p in out.rglob("*.wav"))
    assert len(written) == 5 * len(SONGS)
    random.seed(4321)
    for index in range(len(jax)):
        track = jmix.build_track(index, jax)
        mix = track.sum(0)
        scale = max(1, 1.01 * np.abs(mix).max())
        folder = out / "train" / f"0_{index}"
        want = {"mixture": mix / scale, **dict(zip(tmix.SOURCES, track / scale))}
        for name, wav in want.items():
            got = _read(folder / f"{name}.wav").reshape(-1, 2).T
            pcm = np.clip(np.round(wav * 32767), -32768, 32767)
            assert got.shape == pcm.shape
            assert np.abs(got.astype(np.int64) - pcm).max() <= 1, (index, name)


def _read(path: Path) -> np.ndarray:
    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")
