"""Tensor parallelism (demucs_tpu_torch.parallel.tp) on Gloo CPU processes
(``tests/torch_mp_worker.py``, which imports only the port), against the
JAX package's ``demucs_tpu/parallel/tp.py`` at ``tests/test_tp.py``'s small
HTDemucs (channels 16, depth 4, nfft 2048, 3 layers, 4 heads; every
LayerScale at 1.0, so the transformer counts):

- the spec table against ``transformer_tp_specs``, leaf for leaf;
- ``tp_forward`` on 2 and 4 ranks (heads split 2 and 1 a rank) against JAX's
  ``tp_forward`` on 4 virtual devices, atol 2e-5 rtol 1e-5 (``test_tp.py:47``);
- the dp x tp (2 x 2) step against the dp-only step, here the one-process
  step on the global batch of 4 (l1, lr 1e-3, clip 0.5): loss 1e-6
  relative as ``test_tp.py``, the global norm 1e-4 relative as
  ``test_torch_train.py`` (its squares summed in another order), the
  gathered weights within 1e-3 x the learning
  rate (Adam's first step divides each gradient by its own magnitude, so a
  gradient that is zero up to rounding moves by a share of the rate).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from jax.sharding import Mesh, PartitionSpec as P

from common import SOURCES, random_mix, small_htdemucs_kwargs

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.parallel.tp import tp_forward as jax_tp_forward
from demucs_tpu.parallel.tp import transformer_tp_specs as jax_specs
from demucs_tpu.zoo.torch_load import flatten_state
from demucs_tpu_torch.parallel import tp as tpar

import torch_mp_worker as W
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def weights():
    cfg = jht.HTDemucsConfig(sources=tuple(SOURCES), **small_htdemucs_kwargs())
    flat = {k: np.ones_like(v) if k.endswith(".scale") else np.asarray(v)
            for k, v in flatten_state(jht.init_htdemucs(cfg, seed=0)).items()}
    return cfg, flat


def _flat_specs(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_specs(v, path + (str(k),))
        else:
            yield ".".join(path + (str(k),)), v


def test_specs_match_jax_leaf_for_leaf(weights):
    from demucs_tpu.zoo.torch_load import nest_state

    cfg, flat = weights
    specs = jax_specs(nest_state(flat))
    want = {name: tuple(spec) for name, spec in _flat_specs(specs)}
    module = W.step_model(flat, json.loads(json.dumps(dataclasses.asdict(cfg)))).module
    got = tpar.transformer_tp_specs(n for n, _ in module.named_parameters())
    assert got == want
    assert sum(bool(s) for s in got.values()) == 6 * 2 * cfg.t_layers
    assert all(s == P() for n, s in _flat_specs(specs) if "crosstransformer" not in n)


@pytest.fixture(scope="module")
def tp_runs(weights, tmp_path_factory):
    cfg, flat = weights
    mix = random_mix((1, 2, cfg.training_length), seed=21)
    rng = np.random.default_rng(22)
    sources = (0.1 * rng.standard_normal((4, len(SOURCES), 2, cfg.training_length))
               ).astype(np.float32)
    runs = {}
    for world in (2, 4):
        folder = tmp_path_factory.mktemp(f"tp{world}")
        np.savez(folder / "in.npz", mix=mix, sources=sources,
                 **{f"w/{k}": v for k, v in flat.items()})
        (folder / "in.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        runs[world] = W.run_ranks("tp", folder, world=world)
    return mix, sources, runs


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax(weights, tp_runs, cpu_devices, world):
    from demucs_tpu.zoo.torch_load import nest_state

    cfg, flat = weights
    mix, _, runs = tp_runs
    model = JaxModel("htdemucs", cfg, nest_state(flat))
    want = jax_tp_forward(model, mix, Mesh(np.array(cpu_devices[:4]), ("tp",)))
    for got in runs[world]:
        np.testing.assert_allclose(got["forward"], want, atol=2e-5, rtol=1e-5)


def test_dp_tp_train_step_matches_dp_only(weights, tp_runs):
    cfg, flat = weights
    _, sources, runs = tp_runs
    cfg_kw = json.loads(json.dumps(dataclasses.asdict(cfg)))
    torch.set_num_threads(1)
    want = W.one_step(W.step_model(flat, cfg_kw), sources, lr=1e-3, clip_grad=0.5)
    for got in runs[4]:
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
        for key, value in want.items():
            if key.startswith("param/"):
                assert got[key].shape == value.shape, key
                assert np.abs(got[key] - value).max() <= 1e-6, key


def test_shard_refuses_heads_that_do_not_split(weights, monkeypatch):
    cfg, flat = weights
    module = W.step_model(flat, json.loads(json.dumps(dataclasses.asdict(cfg)))).module
    monkeypatch.setattr(tpar.dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(tpar.dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="do not split over 3"):
        tpar.shard_module(module)
