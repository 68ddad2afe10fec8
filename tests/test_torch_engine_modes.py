"""Port's device-resident engine against the JAX package's device_apply_model
and the port's host engine, as tests/test_torch_engine.py (whose fixtures and
tolerances these share), for the engine's modes: exact and uniform tails,
weighted and mixed bags, length buckets and the reduced-precision wires.

Tolerances: 1e-5 x peak for the float32 wire; the float16, int16 and int8
wires within one quantization step of the JAX engine's output plus that
1e-5 x peak, and int8 at more than 40 dB SNR.
"""

import random

import numpy as np
import pytest

from demucs_tpu.inference import engine as jeng
from demucs_tpu.models.registry import BagOfModels as JaxBag
from demucs_tpu_torch.inference import engine
from demucs_tpu_torch.inference.apply import apply_model
from demucs_tpu_torch.models.registry import BagOfModels

from test_torch_apply import _pair, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_engine import _close, _mix, pair, pair_exact  # noqa: F401 (fixtures)


@pytest.mark.parametrize("segments,tail_mode", [(2.3, "exact"), (1.2, "exact"),
                                                (2.3, "uniform")])
def test_exact_and_uniform_tails_match_jax(pair_exact, segments, tail_mode):
    jm, tm = pair_exact
    mix = _mix(segments, seed=3)
    kw = dict(shifts=2, overlap=0.25, batch_size=2, tail_mode=tail_mode)
    want = jeng.device_apply_model(jm, mix, rng=random.Random(77), **kw)
    got = engine.device_apply_model(tm, mix, rng=random.Random(77), **kw)
    _close(got, want)
    if tail_mode == "exact":  # exact tails are the host engine's padding
        host = apply_model(tm, mix, engine="host", shifts=2, batch_size=2,
                           rng=random.Random(77))
        _close(got, host)


@pytest.mark.parametrize("shifts", [0, 1, 2])
def test_weighted_bag_matches_jax(shifts):
    (j1, t1), (j2, t2) = _pair(7), _pair(8)
    weights = [[1.0, 0.5, 1.0, 2.0], [0.5, 1.0, 1.0, 1.0]]
    mix = _mix(2.3, seed=1)
    kw = dict(shifts=shifts, batch_size=2)
    want = jeng.device_apply_model(JaxBag([j1, j2], weights), mix, rng=random.Random(99), **kw)
    bag = BagOfModels([t1, t2], weights)
    got = engine.device_apply_model(bag, mix, rng=random.Random(99), **kw)
    _close(got, want)
    host = apply_model(bag, mix, engine="host", rng=random.Random(99), **kw)
    _close(got, host)


def test_mixed_bag_matches_jax_and_host(pair, pair_exact):
    """One member with the train segment (uniform targets) and one without
    (exact tails), on one track buffer."""
    mix = _mix(1.2, seed=9)
    kw = dict(shifts=1, batch_size=2)
    want = jeng.device_apply_model(JaxBag([pair[0], pair_exact[0]]), mix,
                                   rng=random.Random(13), **kw)
    bag = BagOfModels([pair[1], pair_exact[1]])
    got = engine.device_apply_model(bag, mix, rng=random.Random(13), **kw)
    _close(got, want)
    _close(got, apply_model(bag, mix, engine="host", rng=random.Random(13), **kw))


def test_length_bucket_matches_jax(pair):
    jm, tm = pair
    mix = _mix(2.3, seed=4)  # 9200 samples, padded to 12000 by 0.75 s buckets
    kw = dict(shifts=1, batch_size=2, length_bucket_seconds=0.75)
    want = jeng.device_apply_model(jm, mix, rng=random.Random(5), **kw)
    got = engine.device_apply_model(tm, mix, rng=random.Random(5), **kw)
    assert got.shape == (1, 4, 2, mix.shape[-1])
    _close(got, want)
    with pytest.raises(ValueError, match="positive"):
        engine.device_apply_model(tm, mix, length_bucket_seconds=0.0)
    staged = engine.stage_track(tm, mix)
    with pytest.raises(ValueError, match="bucket"):
        engine.device_apply_model(tm, mix, prestaged=staged, length_bucket_seconds=0.75)


def _blocks_max(y, block):
    pad = (-y.shape[-1]) % block
    yb = np.abs(np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, pad)]))
    m = yb.reshape(*y.shape[:-1], -1, block).max(axis=-1, keepdims=True)
    return np.repeat(m, block, axis=-1).reshape(*y.shape[:-1], -1)[..., : y.shape[-1]]


@pytest.mark.parametrize("wire", ["float16", "int16", "int8"])
def test_wire_formats_within_one_step_of_jax(pair, wire):
    jm, tm = pair
    mix = _mix(2.3, seed=6)
    kw = dict(shifts=0, batch_size=2, transfer_dtype=wire)
    # the port uploads the track in float32 whatever the wire; so does JAX here
    want = jeng.device_apply_model(jm, mix, input_transfer_dtype=None, **kw)
    got = engine.device_apply_model(tm, mix, **kw)
    exact = engine.device_apply_model(tm, mix, shifts=0, batch_size=2)
    peak = np.abs(exact).max()
    if wire == "float16":
        step = np.abs(exact) * 2.0**-10
    elif wire == "int16":
        step = np.abs(exact).max(axis=-1, keepdims=True) / 32766.0
    else:
        step = _blocks_max(exact, 1024) / 126.0
    assert got.shape == want.shape == exact.shape
    assert (np.abs(got - want) <= step + 1e-5 * peak).all()
    if wire != "float16":  # the rounding to the wire's own grid: half a step, and for
        # int8 the float16 rounding of its scales, up to 126 x 2**-11 of a step
        half = 0.5 if wire == "int16" else 0.5 + 126 * 2.0**-11
        assert (np.abs(got - exact) <= half * step + 1e-5 * peak).all()
    if wire == "int8":  # noise follows the blocks' level
        snr = 10 * np.log10((exact**2).mean() / ((got - exact) ** 2).mean())
        assert snr > 40, snr
    with pytest.raises(ValueError, match="transfer_dtype"):
        engine.device_apply_model(tm, mix, transfer_dtype="bfloat16")
