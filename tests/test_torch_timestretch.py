"""The port's time-stretch and repitch augment (demucs_tpu_torch.ops.timestretch,
demucs_tpu_torch.train.repitch) against the JAX package's on the same seeded
inputs, the tone tests of tests/test_timestretch.py on the port's functions,
and the repitch wrapper's seeded draws.

Tolerances: max abs diff 1e-6 against the JAX package's functions (the same
numpy and scipy arithmetic, operation for operation); the tone tests keep
tests/test_timestretch.py's bounds.
"""

import numpy as np
import pytest

from demucs_tpu.ops import timestretch as jts
from demucs_tpu.train import repitch as jrepitch
from demucs_tpu_torch.ops import timestretch as tts
from demucs_tpu_torch.train import repitch as trepitch

SR = 22050
PARITY = 1e-6


def _tone(freq, seconds=2.0, sr=SR, channels=2):
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([np.sin(2 * np.pi * freq * t)] * channels).astype(np.float32)


def _noise(seed, seconds=1.0, channels=2):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((channels, int(seconds * SR)))).astype(np.float32)


def _domfreq(x, sr=SR):
    w = x[0].astype(np.float64) * np.hanning(x.shape[-1])
    return np.argmax(np.abs(np.fft.rfft(w))) * sr / x.shape[-1]


def _rms(x):
    core = np.asarray(x, np.float64)[:, x.shape[-1] // 4: -x.shape[-1] // 4]
    return float(np.sqrt((core ** 2).mean()))


@pytest.mark.parametrize("rate", [0.8, 0.99, 1.01, 1.25])
def test_time_stretch_tone(rate):
    tone = _tone(440.0)
    y = tts.time_stretch(tone, rate)
    assert y.shape == (2, round(tone.shape[-1] / rate))
    assert abs(_domfreq(y) - 440.0) < 2.0  # pitch kept
    assert abs(_rms(y) - _rms(tone)) < 0.02  # energy kept


@pytest.mark.parametrize("ratio", [0.5, 0.891, 1.122, 2.0])
def test_resample_tone(ratio):
    tone = _tone(440.0)
    y = tts.resample(tone, ratio)
    assert y.shape == (2, round(tone.shape[-1] * ratio))
    assert abs(_domfreq(y) - 440.0 / ratio) < 3.0
    assert abs(_rms(y) - _rms(tone)) < 0.02


@pytest.mark.parametrize("pitch,tempo", [(2.0, 5.0), (-3.0, -8.0), (0.0, 12.0)])
def test_repitch_native_semantics(pitch, tempo):
    """soundstretch's parameters: duration / (1 + tempo/100), pitch in semitones."""
    tone = _tone(440.0)
    y = tts.repitch_native(tone, pitch, tempo)
    assert y.shape == (2, round(tone.shape[-1] / (1 + tempo / 100)))
    want_f = 440.0 * 2 ** (pitch / 12)
    assert abs(_domfreq(y) - want_f) < 0.01 * want_f
    assert abs(_rms(y) - _rms(tone)) < 0.03


@pytest.mark.parametrize("rate", [0.88, 1.0, 1.07, 1.12])
def test_time_stretch_matches_jax(rate):
    x = _noise(1)
    got, want = tts.time_stretch(x, rate), jts.time_stretch(x, rate)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PARITY
    short = _noise(2, seconds=0.1)  # shorter than a WSOLA frame: the plain resampling
    assert np.abs(tts.time_stretch(short, rate) - jts.time_stretch(short, rate)).max() <= PARITY


@pytest.mark.parametrize("ratio", [0.891, 1.0 / 2 ** (1 / 12), 1.122])
def test_resample_matches_jax(ratio, monkeypatch):
    x = _noise(3)
    assert np.abs(tts.resample(x, ratio) - jts.resample(x, ratio)).max() <= PARITY
    # the numpy polyphase path, where scipy is missing
    import scipy.signal

    monkeypatch.delattr(scipy.signal, "resample_poly")
    got, want = tts.resample(x, ratio, block=4096), jts.resample(x, ratio, block=4096)
    assert got.shape == want.shape and np.abs(got - want).max() <= PARITY


@pytest.mark.parametrize("pitch,tempo", [(2, 5.0), (-2, -7.5), (0, 12.0), (1, 0.0), (0, 0.0)])
def test_repitch_native_matches_jax(pitch, tempo):
    x = _noise(4)
    got, want = tts.repitch_native(x, pitch, tempo), jts.repitch_native(x, pitch, tempo)
    assert got.shape == want.shape and np.abs(got - want).max() <= PARITY


class _Stems:
    """Four seeded stereo stems an item."""

    def __len__(self):
        return 6

    def __getitem__(self, index):
        rng = np.random.default_rng(index)
        return (0.1 * rng.standard_normal((4, 2, SR))).astype(np.float32)


@pytest.mark.parametrize("same", [True, False])
def test_wrapper_matches_jax_repitch_on_the_same_plan(same):
    """Each item through the port's wrapper equals the JAX package's repitch
    of each stem on the wrapper's plan, cropped to 0.88 of the input."""
    wrapped = trepitch.RepitchedWrapper(_Stems(), proba=1.0, same=same, samplerate=SR, seed=3)
    assert wrapped.backend == "native"  # no soundstretch binary here
    distinct = set()
    for index in range(2):
        plan = wrapped.plan(index, 4)
        distinct.add(len(set(plan)))
        got = wrapped[index]
        streams = _Stems()[index]
        want = np.stack([jrepitch.repitch(s, p, t, voice=k == 3, samplerate=SR,
                                          backend="native")[:, :int(0.88 * SR)]
                         for k, (s, (p, t)) in enumerate(zip(streams, plan))])
        assert got.shape == want.shape == (4, 2, int(0.88 * SR))
        assert np.abs(got - want).max() <= PARITY
    assert (distinct == {1}) == same  # same=False draws per stem


def test_wrapper_plan_is_seeded_and_bounded():
    """The plan depends on (seed, epoch, index) only, whatever the order of
    the reads; pitches are whole semitones in ±max_pitch, tempos within
    ±max_tempo; an item not drawn is only cropped."""
    ds = _Stems()
    a = trepitch.RepitchedWrapper(ds, proba=0.5, seed=7, samplerate=SR)
    b = trepitch.RepitchedWrapper(ds, proba=0.5, seed=7, samplerate=SR)
    plans = [a.plan(i, 4) for i in range(200)]
    assert [b.plan(i, 4) for i in reversed(range(200))][::-1] == plans
    fired = [p for p in plans if p is not None]
    assert 60 < len(fired) < 140  # proba 0.5 of 200
    for plan in fired:
        assert len(set(plan)) == 1  # same=True
        pitch, tempo = plan[0]
        assert pitch in range(-2, 3) and -12 <= tempo <= 12
    assert len({p[0][0] for p in fired}) == 5  # every semitone of ±2 drawn
    a.set_epoch(1)
    assert [a.plan(i, 4) for i in range(200)] != plans
    c = trepitch.RepitchedWrapper(ds, proba=0.5, seed=8, samplerate=SR)
    assert [c.plan(i, 4) for i in range(200)] != plans
    index = next(i for i, p in enumerate(plans) if p is None)
    np.testing.assert_array_equal(b[index], ds[index][..., :int(0.88 * SR)])


def test_loader_epoch_reaches_the_wrapper():
    from demucs_tpu_torch.train.distrib import DataLoader

    wrapped = trepitch.RepitchedWrapper(_Stems(), proba=0.0, samplerate=SR)
    loader = DataLoader(wrapped, 2)
    loader.set_epoch(4)
    assert wrapped.epoch == 4
    assert next(iter(loader)).shape == (2, 4, 2, int(0.88 * SR))


def test_backend_names():
    assert trepitch.backend_name("native") == "native"
    assert trepitch.backend_name("auto") in ("native", "soundstretch")
    with pytest.raises(ValueError, match="backend"):
        trepitch.backend_name("rubberband")
