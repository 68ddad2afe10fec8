"""Pinned shifts and prewarm (demucs_tpu_torch.inference.prewarm, the
``shift_offsets`` of apply_model, apply_model_tracks and Separator) against
demucs_tpu's, called directly (tests/test_prewarm.py's fixture needs the
PyTorch reference package).

Tolerance: 1e-5 x peak, the engines' bound (tests/test_torch_apply.py); the
pinned offsets are checked to be the ones consumed by comparing with the
same draws from a random.Random on the port's own engines, bit for bit.
"""

import random

import numpy as np
import pytest

from demucs_tpu.inference.apply import apply_model as jax_apply
from demucs_tpu.inference.apply import apply_model_tracks as jax_apply_tracks
from demucs_tpu.inference.prewarm import PinnedShifts as JaxPinnedShifts
from demucs_tpu.inference.prewarm import prewarm as jax_prewarm
from demucs_tpu.models.registry import BagOfModels as JaxBag
from demucs_tpu_torch.inference import engine
from demucs_tpu_torch.inference.apply import apply_model, apply_model_tracks
from demucs_tpu_torch.inference.prewarm import PinnedShifts, prewarm
from demucs_tpu_torch.models.registry import BagOfModels

from test_torch_apply import _pair, _track, one_torch_thread  # noqa: F401 (autouse fixture)

OFFSETS = (700, 3100, 40)  # samples at 8 kHz: max_shift is 4000


@pytest.fixture(scope="module")
def exact():
    """HTDemucs without its training segment: ragged tails at their own length
    (the exact-tail kinds whose shapes follow the shift offset)."""
    return _pair(7, use_train_segment=False)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pinned_shifts_cycle_reset_and_check_their_range():
    for cls in (PinnedShifts, JaxPinnedShifts):
        pinned = cls([3, 1, 2])
        assert [pinned.randint(0, 5) for _ in range(5)] == [3, 1, 2, 3, 1]
        pinned.reset()
        assert pinned.randint(0, 5) == 3
        with pytest.raises(ValueError, match="outside the engine's draw range"):
            cls([9]).randint(0, 5)
        with pytest.raises(ValueError, match="non-empty"):
            cls([])
        with pytest.raises(ValueError, match=">= 0"):
            cls([1, -2])


@pytest.mark.parametrize("engine_name", ["host", "device"])
@pytest.mark.parametrize("shifts", [2, 4])
def test_shift_offsets_match_jax(exact, engine_name, shifts):
    jm, tm = exact
    mix = _track(seed=3)
    want = jax_apply(jm, mix, shifts=shifts, batch_size=2, engine="host",
                     shift_offsets=OFFSETS)
    got = apply_model(tm, mix, shifts=shifts, batch_size=2, engine=engine_name,
                      shift_offsets=OFFSETS)
    _close(got, want)
    # the same draws from a random.Random give the same stems, bit for bit
    draws = random.Random()
    draws.randint = PinnedShifts(OFFSETS).randint
    assert np.array_equal(got, apply_model(tm, mix, shifts=shifts, batch_size=2,
                                           engine=engine_name, rng=draws))


def test_shift_offsets_exclude_rng(exact):
    _, tm = exact
    with pytest.raises(ValueError, match="either rng or shift_offsets"):
        apply_model(tm, _track(), shift_offsets=OFFSETS, rng=random.Random(0))
    with pytest.raises(ValueError, match="either rng or shift_offsets"):
        list(apply_model_tracks(tm, [_track()], shift_offsets=OFFSETS, rng=random.Random(0)))


@pytest.mark.parametrize("engine_name", ["host", "device"])
def test_shift_offsets_reset_per_track(exact, engine_name):
    """Every track consumes the pinned set from its start: the same as one call
    per track, and as JAX's apply_model_tracks."""
    jm, tm = exact
    tracks = [_track(seconds, seed=10 + i) for i, seconds in enumerate((1.15, 0.7, 1.15))]
    got = list(apply_model_tracks(tm, tracks, shifts=2, batch_size=2, engine=engine_name,
                                  shift_offsets=OFFSETS))
    single = [apply_model(tm, t, shifts=2, batch_size=2, engine=engine_name,
                          shift_offsets=OFFSETS) for t in tracks]
    want = list(jax_apply_tracks(jm, tracks, shifts=2, batch_size=2, engine="host",
                                 shift_offsets=OFFSETS))
    for g, s, w in zip(got, single, want):
        assert np.array_equal(g, s)
        _close(g, w)


def test_bag_draws_member_major(exact):
    """A bag consumes the pinned set member after member, cycling (JAX's order)."""
    (j1, t1), (j2, t2) = exact, _pair(8, use_train_segment=False)
    weights = [[1.0, 0.5, 1.0, 2.0], [0.5, 1.0, 1.0, 1.0]]
    mix = _track(seed=5)
    want = jax_apply(JaxBag([j1, j2], weights), mix, shifts=2, batch_size=2, engine="host",
                     shift_offsets=OFFSETS)
    for name in ("host", "device"):
        got = apply_model(BagOfModels([t1, t2], weights), mix, shifts=2, batch_size=2,
                          engine=name, shift_offsets=OFFSETS)
        _close(got, want)


@pytest.mark.parametrize("kw", [
    dict(shifts=2, shift_offsets=OFFSETS),  # the set is larger than a track's draws
    dict(shifts=1, shift_offsets=None),  # random shifts: exact tails cannot be warmed
    dict(shifts=0, shift_offsets=None),
    dict(shifts=1, shift_offsets=None, tail_mode="uniform"),
])
def test_prewarm_report_matches_jax(exact, kw):
    jm, tm = exact
    want = jax_prewarm(jm, [0.6, 1.2], batch_size=2, engine="host", **kw)
    calls = []
    real = engine.device_apply_model

    def counted(*args, **kwargs):
        calls.append(kwargs["shifts"])
        return real(*args, **kwargs)

    engine.device_apply_model = counted
    try:
        got = prewarm(tm, [1.2, 0.6, 0.6], batch_size=2, engine="device", **kw)
    finally:
        engine.device_apply_model = real
    strip = [{k: v for k, v in entry.items() if k != "warm_time_s"} for entry in got]
    assert strip == [{k: v for k, v in e.items() if k != "warm_time_s"} for e in want]
    assert all(e["warm_time_s"] >= 0 for e in got)
    # with a pinned set of 3 offsets, each warm run takes 3 shift passes (all of them)
    assert calls == [3, 3] if kw["shift_offsets"] else calls == [kw["shifts"]] * 2


def test_prewarm_uniform_kind_keeps_its_shift_count():
    """HTDemucs with its training segment has no ragged tails: prewarm keeps the
    serving shift count, and reports its tails warm, as JAX's does."""
    jm, tm = _pair(7)
    want = jax_prewarm(jm, 0.6, shifts=1, shift_offsets=OFFSETS, batch_size=2, engine="host")
    got = prewarm(tm, 0.6, shifts=1, shift_offsets=OFFSETS, batch_size=2, engine="device")
    assert [e["tails_warmed"] for e in got] == [e["tails_warmed"] for e in want] == [True]
