"""The port's StreamSeparator (demucs_tpu_torch/inference/streaming.py) against
the port's offline apply_model(shifts=0) and against the JAX package's
StreamSeparator, on HTDemucs (the train segment: one target for every
segment) and Demucs v2 (valid_length pads with real future samples: the
stream's lookahead), small widths, the same weights, mixtures made from a
seed with numpy and fed in ragged chunks drawn from a seed.

Tolerances: 1e-6 absolute against the port's own offline output (JAX's
tests/test_streaming.py bound: the same forwards, one segment per batch
against batches of several); 1e-5 x peak against JAX's stream (the
forward's fp32 deviation between the packages, as in test_torch_apply.py).
"""

import numpy as np
import pytest

from demucs_tpu.inference.streaming import StreamSeparator as JaxStream
from demucs_tpu_torch.inference.apply import apply_model
from demucs_tpu_torch.inference.streaming import StreamSeparator
from demucs_tpu_torch.models.registry import BagOfModels

from test_torch_apply import _pair, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_engine import _family_pair

SEGMENT = 4000  # samples: 0.5 s at 8 kHz


@pytest.fixture(scope="module")
def models():
    return {"htdemucs": _pair(7), "demucs": _family_pair("demucs", 3)}


def _mix(segments, seed):
    n = int(segments * SEGMENT)
    return (np.random.default_rng(seed).standard_normal((1, 2, n)) * 0.1).astype(np.float32)


def _ragged(total, seed, low=100, high=3000):
    rng = np.random.default_rng(seed)
    sizes = []
    while total:
        sizes.append(int(min(total, rng.integers(low, high))))
        total -= sizes[-1]
    return sizes


def _stream(stream, mix, sizes):
    parts, pos = [], 0
    for n in sizes:
        parts.append(stream.feed(mix[0, :, pos:pos + n]))
        pos += n
    parts.append(stream.flush())
    return np.concatenate(parts, axis=-1)[None]


@pytest.fixture(scope="module")
def streamed(models):
    """Per family: (mix, chunk sizes, the port's streamed stems, its stream)."""
    out = {}
    for kind, segments in (("htdemucs", 3.3), ("demucs", 2.7)):
        mix = _mix(segments, seed=len(kind))
        sizes = _ragged(mix.shape[-1], seed=len(kind))
        stream = StreamSeparator(models[kind][1])
        out[kind] = (mix, sizes, _stream(stream, mix, sizes), stream)
    return out


@pytest.mark.parametrize("kind", ["htdemucs", "demucs"])
def test_stream_equals_offline_apply_model(models, streamed, kind):
    mix, _, got, stream = streamed[kind]
    want = apply_model(models[kind][1], mix, shifts=0, split=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (stream._ahead > 0) == (kind == "demucs")  # Demucs v2 waits for its lookahead
    # full segments through the graph cache (eager on the CPU), the tails eagerly
    n_segments = -(-mix.shape[-1] // stream.stride)
    assert stream.graph_segments + stream.eager_segments == n_segments
    assert stream.eager_segments == sum(o + SEGMENT > mix.shape[-1]
                                        for o in range(0, mix.shape[-1], stream.stride))


@pytest.mark.parametrize("kind", ["htdemucs", "demucs"])
def test_stream_equals_jax_stream(models, streamed, kind):
    mix, sizes, got, _ = streamed[kind]
    want = _stream(JaxStream(models[kind][0]), mix, sizes)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_chunking_invariance(models):
    model = models["htdemucs"][1]
    mix = _mix(2.2, seed=32)
    n = mix.shape[-1]
    one = _stream(StreamSeparator(model), mix, [n])
    many = _stream(StreamSeparator(model), mix, [1000] * (n // 1000) + [n % 1000])
    np.testing.assert_allclose(one, many, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["htdemucs", "demucs"])
def test_emits_incrementally_within_latency(models, kind):
    stream = StreamSeparator(models[kind][1])
    mix = _mix(3, seed=34)[0]
    fed = emitted = 0
    for pos in range(0, mix.shape[-1], SEGMENT // 2):
        emitted += stream.feed(mix[:, pos:pos + SEGMENT // 2]).shape[-1]
        fed = min(pos + SEGMENT // 2, mix.shape[-1])
        assert fed - emitted <= stream.latency_samples
    assert emitted > 0  # not only at the flush
    assert emitted + stream.flush().shape[-1] == mix.shape[-1]


def test_flush_is_terminal_and_inputs_checked(models):
    model = models["htdemucs"][1]
    stream = StreamSeparator(model)
    stream.feed(_mix(0.25, seed=35)[0])
    stream.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        stream.feed(np.zeros((2, 10), np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        stream.flush()
    with pytest.raises(ValueError, match="feed expects"):
        StreamSeparator(model).feed(np.zeros((1, 10), np.float32))
    with pytest.raises(TypeError, match="single models"):
        StreamSeparator(BagOfModels([model]))
