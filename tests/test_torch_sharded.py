"""Separation over several devices (demucs_tpu_torch.parallel.sharded, the
device engine's ``devices=`` and ``group=``) on the CPU, against the JAX
package's mesh paths on its 8-device virtual CPU mesh (the same cases as
``tests/test_sharded_inference.py`` and ``tests/test_multiprocess_inference.py``)
and against the port's one-device engine, at ``test_torch_apply.py``'s small
HTDemucs: the same weights and mixtures, the same pinned offsets.

Tolerances: 1e-5 x peak against JAX (the forward's fp32 deviation through
the overlap-add, as in ``test_torch_engine.py``); 1e-6 x peak against the
port's one-device engine (the same forwards on batches cut in other sizes);
the int16 wire 1e-3 x peak, as JAX's own test. The two-rank fan-out (Gloo CPU
processes, ``tests/torch_mp_worker.py``) against the one-process sequential
engine, 2e-5 x peak as JAX's worker holds it.
"""

import random

import numpy as np
import pytest

from demucs_tpu.inference.engine import device_apply_model as jax_apply
from demucs_tpu.models.registry import BagOfModels as JaxBag
from demucs_tpu.parallel.sharded import make_mesh, sharded_apply_model as jax_sharded
from demucs_tpu_torch.inference import engine
from demucs_tpu_torch.models.registry import BagOfModels
from demucs_tpu_torch.parallel import sharded

import torch_mp_worker as W
from test_torch_apply import _pair, one_torch_thread  # noqa: F401 (autouse fixture)

SEGMENT = 4000  # samples: 0.5 s at 8 kHz


@pytest.fixture(scope="module")
def pairs():
    return [_pair(s) for s in (0, 7, 11, 13)]


def _mix(segments, seed):
    n = int(segments * SEGMENT)
    return (np.random.default_rng(seed).standard_normal((1, 2, n)) * 0.1).astype(np.float32)


def _close(got, want, tol):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-3)


class _FixedOffsets:
    def __init__(self, values):
        self.values = list(values)

    def randint(self, a, b):
        v = self.values.pop(0)
        assert a <= v <= b
        return v


@pytest.mark.parametrize("k", [2, 3, 8])
def test_segments_over_devices_match_jax_mesh_and_one_device(pairs, cpu_devices, k):
    jm, tm = pairs[0]
    mix = _mix(2.2, seed=40)
    want = jax_sharded(jm, mix, mesh=make_mesh(8, platform="cpu"), shifts=0,
                       transfer_dtype=None, input_transfer_dtype=None)
    one = engine.device_apply_model(tm, mix, shifts=0)
    got = sharded.sharded_apply_model(tm, mix, devices=["cpu"] * k, shifts=0)
    _close(got, want, 1e-5)
    _close(got, one, 1e-6)


def test_segments_over_devices_with_shifts_and_exact_tails(cpu_devices):
    """HTDemucs without the train segment (its tails at their own length) and
    two shift passes: the full windows over the devices, the tails eager."""
    jm, tm = _pair(7, use_train_segment=False)
    mix = _mix(2.3, seed=44)
    kw = dict(shifts=2, batch_size=2)
    one = engine.device_apply_model(tm, mix, rng=random.Random(9), **kw)
    got = sharded.sharded_apply_model(tm, mix, devices=["cpu"] * 4, rng=random.Random(9), **kw)
    want = jax_apply(jm, mix, rng=random.Random(9), mesh=make_mesh(4, platform="cpu"),
                     transfer_dtype=None, input_transfer_dtype=None, **kw)
    _close(got, one, 1e-6)
    _close(got, want, 1e-5)


def _bags(pairs, n, weights=None):
    jax_bag = JaxBag([j for j, _ in pairs[:n]], weights=weights)
    bag = BagOfModels([t for _, t in pairs[:n]], weights=weights)
    return jax_bag, bag


@pytest.mark.parametrize("devices,segments,shifts,offsets,weights", [
    (2, 1.6, 0, None, [[1.0, 2.0, 1.0, 0.5], [0.5, 1.0, 1.0, 1.0]]),  # one member a device
    (8, 2.3, 0, None, [[1.0, 2.0, 1.0, 0.5], [0.5, 1.0, 1.0, 1.0]]),  # 4-way segments a member
    (2, 1.2, 2, [777, 2025, 31, 1500], None)])  # the offsets drawn model-major
def test_bag_fanout_matches_jax_and_sequential(pairs, cpu_devices, devices, segments, shifts,
                                               offsets, weights):
    jax_bag, bag = _bags(pairs, 2, weights)
    mix = _mix(segments, seed=41)

    def rng():
        return _FixedOffsets(offsets) if offsets else None

    sequential = engine.device_apply_model(bag, mix, shifts=shifts, rng=rng())
    fanned = engine.device_apply_model(bag, mix, shifts=shifts, rng=rng(),
                                       devices=["cpu"] * devices)
    want = jax_apply(jax_bag, mix, shifts=shifts, rng=rng(),
                     mesh=make_mesh(devices, platform="cpu"), transfer_dtype=None,
                     input_transfer_dtype=None)
    _close(fanned, sequential, 1e-6)
    _close(fanned, want, 1e-5)


def test_bag_fanout_four_members_int16_shifts(pairs, cpu_devices):
    """htdemucs_ft-shaped: 4 members, one per device, random shifts, int16 wire."""
    jax_bag, bag = _bags(pairs, 4)
    mix = _mix(1.3, seed=43)
    offsets = [100, 900, 250, 1700]
    kw = dict(shifts=1, transfer_dtype="int16")
    sequential = engine.device_apply_model(bag, mix, rng=_FixedOffsets(offsets), **kw)
    fanned = engine.device_apply_model(bag, mix, rng=_FixedOffsets(offsets),
                                       devices=["cpu"] * 4, **kw)
    want = jax_apply(jax_bag, mix, rng=_FixedOffsets(offsets), mesh=make_mesh(4, platform="cpu"),
                     input_transfer_dtype=None, **kw)
    _close(fanned, sequential, 1e-3)
    _close(fanned, want, 1e-3)


def test_heterogeneous_bag_shards_segments_instead(pairs):
    """Members of two configs do not fan out (as JAX's routing): each member's
    segments go over the devices, the result the sequential engine's."""
    _, small = pairs[0]
    _, exact = _pair(3, use_train_segment=False)
    bag = BagOfModels([small, exact])
    mix = _mix(1.5, seed=45)
    one = engine.device_apply_model(bag, mix, shifts=0)
    got = engine.device_apply_model(bag, mix, shifts=0, devices=["cpu"] * 2)
    _close(got, one, 1e-6)


def test_devices_and_auto_devices_on_the_cpu():
    assert sharded.default_platform() in ("cpu", "cuda")
    assert [str(d) for d in sharded.make_devices(3, "cpu")] == ["cpu"] * 3
    assert sharded.auto_devices("cpu") is None
    with pytest.raises(ValueError, match="unknown platform"):
        sharded.make_devices(2, "tpu")
    if not sharded.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            sharded.make_devices(2, "cuda")


def test_auto_devices_takes_every_card_of_one_process(monkeypatch):
    """One process on a machine that reports four cards (the CUDA queries
    stubbed) takes all four; a model on the CPU takes none."""
    monkeypatch.setattr(sharded.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sharded.torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in sharded.auto_devices("cuda:0")] == [f"cuda:{i}" for i in range(4)]
    assert sharded.auto_devices("cpu") is None


def test_auto_devices_is_none_on_the_ranks_of_a_group(tmp_path):
    """On two Gloo ranks of one group, with four cards reported, each rank
    gets None: it separates on its own card, not on every rank's."""
    ranks = W.run_ranks("auto_devices", tmp_path, world=2)
    assert all(bool(r["auto_is_none"]) for r in ranks)


def test_prestaged_refuses_several_devices(pairs):
    _, tm = pairs[0]
    mix = _mix(1.2, seed=46)
    staged = engine.stage_track(tm, mix, shifts=0)
    with pytest.raises(ValueError, match="several devices"):
        engine.device_apply_model(tm, mix, shifts=0, prestaged=staged, devices=["cpu"] * 2)


def test_two_rank_bag_fanout(tmp_path):
    """``tests/mp_infer_worker.py``'s case: a 4-member bag fanned out over two
    Gloo processes (two members each), stems all-reduced, against the
    one-process sequential engine; both ranks hold the same stems."""
    ranks = W.run_ranks("bag", tmp_path, world=2)
    bag, mix = W.bag_inputs()
    want0 = engine.device_apply_model(bag, mix, shifts=0)
    want1 = engine.device_apply_model(bag, mix, shifts=1, rng=random.Random(5))
    for got in ranks:
        _close(got["shifts0"], want0, 2e-5)
        _close(got["shifts1"], want1, 2e-5)
    assert np.array_equal(ranks[0]["shifts0"], ranks[1]["shifts0"])
