"""Port's device-resident engine (demucs_tpu_torch.inference.engine) against the
JAX package's device_apply_model (called directly, on the CPU) and against the
port's host engine, at the small config of test_torch_apply.py: the same
weights, the same mixtures (numpy, seeded) and the same pinned random.Random
for the shifts.

Tolerances: 1e-5 x peak for the float32 wire (the forward's own fp32
deviation carried through the overlap-add, as in test_torch_apply.py);
pipelined and prestaged calls equal to single calls, bit for bit. The
engine's modes (tails, bags, buckets, wires): tests/test_torch_engine_modes.py.
"""

import random

import numpy as np
import pytest
import torch

from demucs_tpu.inference import engine as jeng
from demucs_tpu_torch.inference import engine
from demucs_tpu_torch.inference.apply import apply_model, apply_model_tracks
from demucs_tpu_torch.kernels import retain_tables
from demucs_tpu_torch.models import transformer

from test_torch_apply import _pair, one_torch_thread  # noqa: F401 (autouse fixture)

SEGMENT = 4000  # samples: 0.5 s at 8 kHz


@pytest.fixture(scope="module")
def pair():
    return _pair(7)


@pytest.fixture(scope="module")
def pair_exact():
    """HTDemucs without the train segment: its tails run at their own length."""
    return _pair(7, use_train_segment=False)


def _mix(segments, seed=0):
    n = int(segments * SEGMENT)
    return (np.random.default_rng(seed).standard_normal((1, 2, n)) * 0.1).astype(np.float32)


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("segments,shifts,overlap,batch_size,power", [
    (2.3, 1, 0.25, 2, 1.0), (2.3, 0, 0.25, 3, 1.0), (2.3, 2, 0.25, 2, 1.0),
    (3.3, 2, 0.6, 3, 1.0), (1.2, 1, 0.6, 2, 1.0), (0.3, 1, 0.25, 2, 1.0),
    (3.3, 1, 0.25, 2, 3.0)])
def test_device_engine_matches_jax_and_host(pair, segments, shifts, overlap, batch_size, power):
    jm, tm = pair
    mix = _mix(segments)
    kw = dict(shifts=shifts, overlap=overlap, batch_size=batch_size, transition_power=power)
    want = jeng.device_apply_model(jm, mix, rng=random.Random(1234), **kw)
    got = engine.device_apply_model(tm, mix, rng=random.Random(1234), **kw)
    _close(got, want)
    routed = apply_model(tm, mix, engine="device", rng=random.Random(1234), **kw)
    assert np.array_equal(routed, got)
    host = apply_model(tm, mix, engine="host", rng=random.Random(1234), **kw)
    _close(got, host)
    if power > 1:  # the edges, where the weight sums are tiny, at their own scale
        edges = np.r_[0:5, mix.shape[-1] - 5 : mix.shape[-1]]
        _close(got[..., edges], host[..., edges])


def test_prestaged_track_equals_single_call(pair):
    _, tm = pair
    mix = _mix(2.3, seed=8)
    want = engine.device_apply_model(tm, mix, shifts=2, batch_size=2, rng=random.Random(3))
    staged = engine.stage_track(tm, mix, shifts=2)
    assert list(staged) == [(SEGMENT, SEGMENT)]
    got = engine.device_apply_model(tm, mix, shifts=2, batch_size=2, rng=random.Random(3),
                                    prestaged=staged)
    assert np.array_equal(got, want)


def test_pipelined_tracks_equal_single_calls(pair):
    _, tm = pair
    tracks = [_mix(s, seed=10 + i) for i, s in enumerate((2.3, 1.2, 3.3))]
    rng = random.Random(21)
    want = [engine.device_apply_model(tm, t, batch_size=2, rng=rng) for t in tracks]
    got = list(engine.device_separate_tracks(tm, tracks, batch_size=2, rng=random.Random(21)))
    routed = list(apply_model_tracks(tm, tracks, engine="device", batch_size=2,
                                     rng=random.Random(21)))
    assert len(got) == len(routed) == 3
    for w, g, r in zip(want, got, routed):
        assert np.array_equal(g, w) and np.array_equal(r, w)
    host = list(apply_model_tracks(tm, tracks, batch_size=2, rng=random.Random(21)))
    for h, w in zip(host, want):  # on the CPU "auto" takes the host engine
        _close(w, h)
    with pytest.raises(ValueError, match="float"):
        list(apply_model_tracks(tm, [np.zeros((2, 2, 100), np.float32)], engine="device"))


def test_engine_routing(pair, monkeypatch):
    _, tm = pair
    mix = _mix(1.2, seed=2)
    calls = []
    monkeypatch.setattr(engine, "device_apply_model",
                        lambda *a, **k: calls.append(k) or np.zeros(0))
    apply_model(tm, mix, batch_size=2)  # the model is on the CPU: the host engine
    assert calls == []
    apply_model(tm, mix, engine="device", transfer_dtype="int16", tail_mode="uniform",
                length_bucket_seconds=1.0)
    assert calls and calls[0]["transfer_dtype"] == "int16"
    assert (calls[0]["tail_mode"], calls[0]["length_bucket_seconds"]) == ("uniform", 1.0)
    for bad in (dict(callback=print), dict(split=False)):
        with pytest.raises(ValueError, match="engine='device'"):
            apply_model(tm, mix, engine="device", **bad)
    with pytest.raises(ValueError, match="engine='device'"):
        apply_model(tm, np.concatenate([mix, mix]), engine="device")
    with pytest.raises(ValueError, match="engine"):
        apply_model(tm, mix, engine="tpu")


@pytest.mark.parametrize("length,max_shift,stride,batch_size", [
    (9200, 4000, 3000, 2), (9200, 4000, 3000, 16), (1200, 0, 3000, 3), (13200, 4000, 1600, 8)])
def test_segment_grid_matches_jax(length, max_shift, stride, batch_size):
    assert engine._segment_grid(length, max_shift, stride, batch_size) == \
        jeng._segment_grid(length, max_shift, stride, batch_size)
    assert engine._exact_obuf_len(length, max_shift, 4000, 4000, stride, batch_size) == \
        jeng._exact_obuf_len(length, max_shift, 4000, 4000, stride, batch_size)


def test_positional_embeddings_cached_outside_inference_mode():
    """The forward reads its embeddings from a cache per shape and device,
    built outside inference mode; a graph capture keeps what it read."""
    transformer._sin_embedding.cache_clear()
    with torch.inference_mode():
        emb = transformer.sin_embedding(37, 16, device=torch.device("cpu"))
        emb2d = transformer.sin_embedding_2d(16, 5, 7, device=torch.device("cpu"))
    assert not emb.is_inference() and not emb2d.is_inference()
    with retain_tables() as kept:
        assert transformer.sin_embedding(37, 16, device=torch.device("cpu")) is emb
        assert transformer.sin_embedding_2d(16, 5, 7, device=torch.device("cpu")) is emb2d
    assert kept == [emb, emb2d]
    assert transformer.sin_embedding(37, 16) is not emb  # another device key
    assert transformer._sin_embedding.cache_info().hits == 1
    w = torch.ones((), requires_grad=True)
    (transformer.sin_embedding(37, 16, device=torch.device("cpu")) * w).sum().backward()
    assert w.grad is not None


def test_registry_segment_and_train_segment(pair, pair_exact):
    _, tm = _pair(7)
    assert tm.uses_train_segment and not pair_exact[1].uses_train_segment
    state = engine._graph_state(tm.module)
    assert engine._graph_state(tm.module) == state
    tm.segment = 0.25
    assert tm.segment == 0.25 and tm.module.cfg.segment == 0.25
    assert tm.valid_length(100) == 2000  # the module pads to the new training length
    assert engine._graph_state(tm.module) != state  # a captured graph is stale now


def _family_pair(kind, seed):
    """(JAX Model, port Model) of a small HDemucs or Demucs v2 (BLSTM and
    LocalState from depth 4 and 3) at 8 kHz, segment 0.5 s, with the same
    weights (the port's seeded init is the JAX package's)."""
    import dataclasses

    from demucs_tpu.models import demucs as jd
    from demucs_tpu.models import hdemucs as jh
    from demucs_tpu.models.registry import Model as JaxModel
    from demucs_tpu_torch.models import demucs as td
    from demucs_tpu_torch.models import hdemucs as th
    from demucs_tpu_torch.models.registry import Model

    sources = ("drums", "bass", "other", "vocals")
    if kind == "hdemucs":
        jcfg = jh.HDemucsConfig(sources=sources, channels=8, nfft=1024, samplerate=8000,
                                segment=0.5)
        jparams, tcfg = jh.init_hdemucs(jcfg, seed), th.HDemucsConfig(**dataclasses.asdict(jcfg))
        module = th.init_hdemucs(tcfg, seed)
    else:
        jcfg = jd.DemucsConfig(sources=sources, channels=8, depth=4, samplerate=8000,
                               segment=0.5, dconv_lstm=3, dconv_attn=3)
        jparams, tcfg = jd.init_demucs(jcfg, seed), td.DemucsConfig(**dataclasses.asdict(jcfg))
        module = td.init_demucs(tcfg, seed)
    return JaxModel(kind, jcfg, jparams), Model(kind, tcfg, module.eval())


@pytest.mark.parametrize("kind,segments,shifts", [("hdemucs", 1.3, 1), ("demucs", 2.3, 2),
                                                  ("demucs", 0.7, 0)])
def test_hdemucs_and_demucs_match_jax_and_host(kind, segments, shifts):
    """Exact tails: each ragged tail chunk at its own leaf target (HDemucs the
    chunk's length, Demucs v2 its valid_length), as the host engine pads it."""
    jm, tm = _family_pair(kind, 3)
    mix = _mix(segments, seed=4)
    kw = dict(shifts=shifts, batch_size=2)
    want = jeng.device_apply_model(jm, mix, rng=random.Random(8), **kw)
    got = engine.device_apply_model(tm, mix, rng=random.Random(8), **kw)
    _close(got, want)
    host = apply_model(tm, mix, engine="host", rng=random.Random(8), **kw)
    _close(got, host)


def test_mixed_kind_bag_with_segment_override_matches_jax():
    """HTDemucs, HDemucs and Demucs v2 in one bag whose segment (0.75 s)
    raises the two others' 0.5 s, on one track with per-source weights: each
    leaf target gets its own track buffer."""
    from demucs_tpu.models.registry import BagOfModels as JaxBag
    from demucs_tpu_torch.models.registry import BagOfModels

    pairs = [_pair(7), _family_pair("hdemucs", 4), _family_pair("demucs", 5)]
    weights = [[1.0, 0.5, 0.0, 1.0], [0.5, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 2.0]]
    jbag = JaxBag([p[0] for p in pairs], weights, segment=0.75)
    bag = BagOfModels([p[1] for p in pairs], weights, segment=0.75)
    assert [m.segment for m in bag.models] == [m.segment for m in jbag.models] == [0.5, 0.75,
                                                                                   0.75]
    mix = _mix(1.4, seed=6)
    want = jeng.device_apply_model(jbag, mix, shifts=1, batch_size=2, rng=random.Random(9))
    got = engine.device_apply_model(bag, mix, shifts=1, batch_size=2, rng=random.Random(9))
    _close(got, want)
    host = apply_model(bag, mix, engine="host", shifts=1, batch_size=2, rng=random.Random(9))
    _close(got, host)
    staged = engine.stage_track(bag, mix, shifts=1)
    assert len(staged) == 3  # one buffer per (segment, leaf target)


@pytest.mark.parametrize("kind", ["hdemucs", "demucs"])
@pytest.mark.parametrize("seconds,shifts", [(0.3, 0), (0.3, 1), (0.9, 1)])
def test_exact_tails_bit_equal_to_host_engine(kind, seconds, shifts):
    """With the same windows per forward (batch 1: each window its own
    forward on both engines), the device engine equals the host engine bit for
    bit. Its tail windows are cut from the padded track buffer: a view with the
    buffer's strides and an offset base, over which HDemucs's input mean sums in
    another order than over the host engine's fresh array (a few fp32 ulps of
    the output, up to 5e-7 x peak on the card). The engine copies each tail
    window into a fresh contiguous tensor first."""
    _, tm = _family_pair(kind, 5)
    mix = _mix(seconds / 0.5, seed=6)
    kw = dict(shifts=shifts, batch_size=1)
    got = engine.device_apply_model(tm, mix, rng=random.Random(3), **kw)
    want = apply_model(tm, mix, engine="host", rng=random.Random(3), **kw)
    assert np.array_equal(got, want)


def test_pass_memory_analysis_is_none_on_the_cpu(pair):
    """As the JAX engine's where the backend gives no analysis; the caller's
    graph cache is left as it was."""
    _, tm = pair
    before = engine.GRAPHS
    assert engine.pass_memory_analysis(tm, 3 * SEGMENT) is None
    assert engine.pass_memory_analysis(tm, 3 * SEGMENT, shifts=0, segment=0.4) is None
    assert engine.GRAPHS is before


def test_graph_cache_clear_drops_every_graph_and_pool():
    """clear() forgets the graphs and the pools' handles (on the card their
    memory then goes back with torch.cuda.empty_cache(); the card test and
    chip_smoke.py's memory phase measure it); counts are kept and the next
    forward of a shape captures again."""
    cache = engine.GraphCache(maxsize=4)
    cache.entries[("module", (6, 2, 8), "cuda:0")] = object()
    cache.entries[("module", (1, 2, 8), "cuda:0")] = object()
    cache.pools["cuda:0"] = (0, 1)
    cache.captures = 2
    cache.clear()
    assert not cache.entries and not cache.pools and cache.pool_bytes() == 0
    assert cache.captures == 2 and cache.stats()["graphs"] == 0
