"""Port's host engine (demucs_tpu_torch.inference.apply.apply_model) against the
JAX package's apply_model(engine="host"): the same weights, the same pinned
random.Random for the shifts, a ragged 2.3-segment track, batch size 2;
then a two-member bag.

Tolerance: 1e-5 x peak — the forward's own fp32 deviation (well under the
model-level 2e-4 x peak) carried through the same overlap-add.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from demucs_tpu.inference.apply import apply_model as jax_apply
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import BagOfModels as JaxBag
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.zoo.torch_load import flatten_state
from demucs_tpu_torch.inference.apply import apply_model
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models.registry import BagOfModels, Model
from demucs_tpu_torch.zoo.convert import load_flat_state

SOURCES = ("drums", "bass", "other", "vocals")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU forwards (imported by the other
    port files that run them): they gain nothing from more, and the suite runs
    several workers on one machine, where each worker's threads contend with
    the others' (on an 8-core machine, three workers of the engine tests took
    ten times as long with the default threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed, **overrides):
    jcfg = jht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                              t_heads=2, segment=0.5, samplerate=8000, **overrides)
    params = jht.init_htdemucs(jcfg, seed=seed)
    tcfg = tht.HTDemucsConfig(**dataclasses.asdict(jcfg))
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    module = load_flat_state(tht.HTDemucs(tcfg), flat).eval()
    return JaxModel("htdemucs", jcfg, params), Model("htdemucs", tcfg, module)


def _track(seconds=2.3 * 0.5, seed=0):
    n = int(seconds * 8000)
    return (np.random.default_rng(seed).standard_normal((1, 2, n)) * 0.1).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shifts,split,seconds", [
    (1, True, 2.3 * 0.5), (0, True, 2.3 * 0.5), (0, False, 0.3)])
def test_apply_matches_jax_host_engine(shifts, split, seconds):
    jm, tm = _pair(7)
    mix = _track(seconds)
    kw = dict(shifts=shifts, split=split, overlap=0.25, batch_size=2)
    want = jax_apply(jm, mix, rng=random.Random(1234), engine="host", **kw)
    got = apply_model(tm, mix, rng=random.Random(1234), **kw)
    assert got.dtype == np.float32
    _close(got, want)


def test_bag_matches_jax_host_engine():
    (j1, t1), (j2, t2) = _pair(7), _pair(8)
    weights = [[1.0, 0.5, 1.0, 2.0], [0.5, 1.0, 1.0, 1.0]]
    mix = _track(seed=1)
    want = jax_apply(JaxBag([j1, j2], weights), mix, shifts=1, batch_size=2,
                     rng=random.Random(99), engine="host")
    got = apply_model(BagOfModels([t1, t2], weights), mix, shifts=1, batch_size=2,
                      rng=random.Random(99))
    _close(got, want)


def test_callbacks_and_engine_choice():
    _, tm = _pair(7)
    events = []
    apply_model(tm, _track(), shifts=0, batch_size=2, callback=events.append)
    assert [e["state"] for e in events].count("start") == 4  # 4 chunks at stride 0.375 s
    assert sorted(e["segment_offset"] for e in events if e["state"] == "end") == [
        0, 3000, 6000, 9000]
    # the device engine runs on the CPU too, and only where the call allows it
    want = apply_model(tm, _track(), shifts=0, batch_size=2, engine="host")
    got = apply_model(tm, _track(), shifts=0, batch_size=2, engine="device")
    _close(got, want)
    with pytest.raises(ValueError, match="callback"):
        apply_model(tm, _track(), engine="device", callback=events.append)
