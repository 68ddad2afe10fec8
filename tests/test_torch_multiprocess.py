"""Data-parallel training of the port on two Gloo CPU processes
(``tests/torch_mp_worker.py``, which imports only the port), on
``tests/mp_worker.py``'s small HTDemucs (channels 8, nfft 1024, depth 4, 2
layers, 4 heads, 0.25 s at 8 kHz) and Demucs v2:

- a step on two ranks with a local batch of 2 each, against JAX's
  ``make_train_step`` on the global batch of 4 (l1), with
  ``test_torch_train.py``'s tolerances (loss and reco 1e-5 relative, the
  global norm 1e-4, each gradient 2e-3 x its peak plus 1e-9); on mse (whose
  loss sums over the batch) against the port's one-process step, 1e-5 x each
  gradient's peak;
- with ``t_dropout`` 0.1 and every augment (remix groups of 2), the
  two-rank step against the one-process step on the global batch at lr 1e-3:
  the same scores dropped and the same draws, so only the order of the
  gradient's sums differs (1e-5 x each gradient's peak; the weights 1e-3 x
  the learning rate: Adam's first step divides each gradient by its own
  magnitude, so a gradient that is zero up to rounding, a bias before a
  norm, moves by a share of the rate that its rounding decides);
- a Solver epoch of Demucs v2 with the augments off: the losses equal
  across ranks (bit for bit) and equal to the one-process epoch at the same
  global batch within 1e-5 relative (each step holds the same items, in
  another order); rank 0 alone writes.

Each rank runs within ``RANK_TIMEOUT_S`` (120 s).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.train.step import TrainConfig, make_train_step
from demucs_tpu.zoo.torch_load import flatten_state, nest_state

import torch_mp_worker as W
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def step_inputs():
    """JAX's seeded weights (every LayerScale at 1.0), a global batch of 4."""
    jcfg = jht.HTDemucsConfig(**W.SMALL_HTDEMUCS)
    flat = {k: np.ones_like(v) if k.endswith(".scale") else np.asarray(v)
            for k, v in flatten_state(jht.init_htdemucs(jcfg, seed=0)).items()}
    rng = np.random.default_rng(5)
    shape = (4, len(jcfg.sources), 2, jcfg.training_length)
    sources = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    sources_aug = (0.2 * rng.standard_normal(shape[:-1] + (shape[-1] + 400,))).astype(np.float32)
    return jcfg, flat, sources, sources_aug


@pytest.fixture(scope="module")
def step_ranks(step_inputs, tmp_path_factory):
    jcfg, flat, sources, sources_aug = step_inputs
    folder = tmp_path_factory.mktemp("step")
    np.savez(folder / "in.npz", sources=sources, sources_aug=sources_aug,
             **{f"w/{k}": v for k, v in flat.items()})
    (folder / "in.json").write_text(json.dumps(dataclasses.asdict(jcfg)))
    return W.run_ranks("step", folder, world=2)


def _cfg_kw(jcfg):
    return json.loads(json.dumps(dataclasses.asdict(jcfg)))


def test_two_rank_step_matches_jax_global_batch(step_inputs, step_ranks):
    jcfg, flat, sources, _ = step_inputs
    keeper = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    params = nest_state(flat)
    step = jax.jit(make_train_step(jht.forward, jcfg,
                                   TrainConfig(loss="l1", weights=(1.0, 2.0, 0.5, 1.0)), keeper))
    _, want_grads, metrics = step(params, keeper.init(params), jnp.asarray(sources),
                                  jax.random.PRNGKey(0))
    want_grads = flatten_state(want_grads)
    for got in step_ranks:
        assert _rel(got["l1/loss"], metrics["loss"]) < 1e-5
        assert _rel(got["l1/reco"], metrics["reco"]) < 1e-5
        assert _rel(got["l1/grad_norm"], metrics["grad_norm"]) < 1e-4
        grads = {k[len("l1/grad/"):]: v for k, v in got.items() if k.startswith("l1/grad/")}
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            want = np.asarray(want_grads[name])
            assert np.abs(g - want).max() <= 2e-3 * np.abs(want).max() + 1e-9, name
    for key in step_ranks[0]:  # every rank holds the same averaged gradients
        assert np.array_equal(step_ranks[0][key], step_ranks[1][key]), key


def test_two_rank_mse_step_sums_the_global_batch(step_inputs, step_ranks):
    jcfg, flat, sources, _ = step_inputs
    want = W.one_step(W.step_model(flat, _cfg_kw(jcfg)), sources, loss="mse")
    got = step_ranks[0]
    assert _rel(got["mse/loss"], want["loss"]) < 1e-5
    assert _rel(got["mse/reco"], want["reco"]) < 1e-5
    for key, value in want.items():
        if key.startswith("grad/"):
            assert np.abs(got[f"mse/{key}"] - value).max() <= \
                1e-5 * np.abs(value).max() + 1e-9, key


def test_two_rank_dropout_step_equals_one_process(step_inputs, step_ranks):
    """t_dropout 0.1 and the full augment pipeline: K3's dropout seed offset by
    ``rank * B_local * H * 0x27D4EB2F``, the blocks' masks and every augment
    drawn for the global batch, so the two ranks drop and draw what one
    process does on the global batch."""
    jcfg, flat, _, sources_aug = step_inputs
    want = W.one_step(W.step_model(flat, dict(_cfg_kw(jcfg), t_dropout=0.1)), sources_aug,
                      lr=1e-3, augment=W.step_augment(), seed=3, clip_grad=0.5)
    for got in step_ranks:
        assert _rel(got["dropout/loss"], want["loss"]) < 1e-5
        assert _rel(got["dropout/grad_norm"], want["grad_norm"]) < 1e-5
        for key, value in want.items():
            if key.startswith("grad/"):
                assert np.abs(got[f"dropout/{key}"] - value).max() <= \
                    1e-5 * np.abs(value).max() + 1e-9, key
            elif key.startswith("param/"):
                assert np.abs(got[f"dropout/{key}"] - value).max() <= 1e-6, key
    # the check sees the pattern: dropout moves the transformer's gradients by
    # far more than the 1e-5 above (another pattern on rank 1 would show)
    no_dropout = W.one_step(W.step_model(flat, _cfg_kw(jcfg)), sources_aug, lr=1e-3,
                            augment=W.step_augment(), seed=3, clip_grad=0.5)
    key = "grad/crosstransformer.layers.0.linear1.weight"
    assert _rel(want[key], no_dropout[key]) > 1e-2


def test_solver_epoch_two_ranks_equals_one_process(tmp_path):
    from demucs_tpu_torch.train import config
    from demucs_tpu_torch.train.train import get_solver

    W.write_musdb(tmp_path / "musdb")
    ranks = W.run_ranks("solver", tmp_path, world=2)
    assert ranks[0]["train_loss"] == ranks[1]["train_loss"]
    assert ranks[0]["valid_loss"] == ranks[1]["valid_loss"]
    assert [int(r["serialize"]) for r in ranks] == [1, 0]
    assert [int(r["history"]) for r in ranks] == [1, 0]
    xps = list((tmp_path / "outputs" / "xps").iterdir())
    assert len(xps) == 1 and (xps[0] / "checkpoint.pkl").is_file()
    assert len(json.loads((xps[0] / "history.json").read_text())) == 1

    overrides = W.solver_overrides(tmp_path)
    overrides[overrides.index(f"out_dir={tmp_path / 'outputs'}")] = f"out_dir={tmp_path / 'one'}"
    args = config.apply_overrides(config.TrainArgs(), config.parse_cli_overrides(overrides))
    solver = get_solver(args, device="cpu")
    torch.set_num_threads(1)
    solver.train()
    one = solver.history[-1]
    assert _rel(ranks[0]["train_loss"], one["train"]["loss"]) < 1e-5
    assert _rel(ranks[0]["valid_loss"], one["valid"]["loss"]) < 1e-5
    assert _rel(ranks[0]["nsdr"], one["valid"]["nsdr"]) < 1e-4
