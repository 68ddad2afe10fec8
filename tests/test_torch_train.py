"""The port's training stack (demucs_tpu_torch.train) on the CPU, against the
JAX package's (demucs_tpu.train) where the two can be given the same
inputs, else by its properties: one train step of a small HTDemucs (the
same flat weights, dropout 0, no augment) against ``make_train_step``;
the optimizer against optax over three steps on the same gradients; the
loss, the config, the EMA and the augments against JAX's; the
transformer's train-time draws; a short overfit; the Solver over two epochs
and a resume; the options the port once refused, each one epoch of the
entry point, and the one it still refuses (more than one process).

Tolerances (each with its reason):
- train step: loss and reco 1e-5 relative, the gradient's global norm
  1e-4 relative, each parameter's gradient 2e-3 x its peak plus 1e-9 (fp32
  through a deep network with normalizations, summed in another order by
  XLA:CPU and ATen; the smallest gradients come from differences of large
  terms, and a bias before a norm has a zero gradient, 1e-12 of noise);
- bf16 train step (``compute_dtype="bfloat16"`` or a bf16 stage, fp32
  masters on both sides): loss and reco 1e-3 relative, the global norm 1e-2
  relative, each gradient's gap to JAX at most twice JAX's own gap between
  its bf16 and fp32 steps for that tensor plus 2e-3 x the largest gradient's
  peak (bf16 rounds at every op, and XLA rounds at fewer places than the
  port's op-by-op bf16; the second term covers the biases before a norm,
  whose true gradient is zero);
- optimizer: 1e-6 absolute on the weights after three steps at lr 1e-3
  (fp32 Adam moments in both);
- loss, EMA, augments: 1e-6 relative or exact (the same few operations).
"""

import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models import transformer as jtr
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.train import augment as jaug
from demucs_tpu.train import config as jconfig
from demucs_tpu.train.ema import ModelEMA as JaxEMA
from demucs_tpu.train.solver import make_optimizer as jax_make_optimizer
from demucs_tpu.train.step import TrainConfig, make_train_step
from demucs_tpu.train.step import source_loss as jax_source_loss
from demucs_tpu.zoo.torch_load import flatten_state
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models import transformer as ttr
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.train import augment as taug
from demucs_tpu_torch.train import config as tconfig
from demucs_tpu_torch.train import ema as tema
from demucs_tpu_torch.train import step as tstep
from demucs_tpu_torch.zoo.convert import load_flat_state

from common import SOURCES
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = dict(sources=tuple(SOURCES), channels=8, depth=2, nfft=512, t_layers=2, t_heads=2,
             segment=0.5, samplerate=8000)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(**kw):
    """The JAX params (every LayerScale at 1.0, so the transformer counts) and
    the port's module holding the same weights, every one an fp32 master (a
    bf16 stage casts them on each forward, as JAX's ``stage_params``)."""
    jcfg = jht.HTDemucsConfig(**dict(SMALL, **kw))
    flat = {k: np.ones_like(v) if k.endswith(".scale") else np.asarray(v)
            for k, v in flatten_state(jht.init_htdemucs(jcfg, seed=0)).items()}
    from demucs_tpu.zoo.torch_load import nest_state

    module = tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg))).float()
    module = load_flat_state(module, flat)
    return jcfg, nest_state(flat), Model("htdemucs", module.cfg, module)


def _sources(cfg, batch=2, seed=5):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((batch, len(cfg.sources), 2, cfg.training_length))
            ).astype(np.float32)


def _grad_keeper():
    """An optax transformation that makes no update and keeps the gradients
    as its state: ``make_train_step``'s gradients, from one compiled step."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("loss", ["l1", "mse"])
def test_train_step_matches_jax(loss):
    jcfg, params, model = _pair()
    sources = _sources(jcfg)
    weights = (1.0, 2.0, 0.5, 1.0)
    keeper = _grad_keeper()
    step = jax.jit(make_train_step(jht.forward, jcfg, TrainConfig(loss=loss, weights=weights),
                                   keeper))
    _, want_grads, metrics = step(params, keeper.init(params), jnp.asarray(sources),
                                  jax.random.PRNGKey(0))
    want_grads = flatten_state(want_grads)
    args = tconfig.TrainArgs()
    args.optim.lr = 0.0
    optimizer = tstep.make_optimizer(args, model)
    model.module.train()
    got = tstep.train_step(model, optimizer, torch.from_numpy(sources), loss=loss,
                           weights=weights)
    assert _rel(got["loss"], metrics["loss"]) < 1e-5
    assert _rel(got["reco"], metrics["reco"]) < 1e-5
    assert _rel(got["grad_norm"], metrics["grad_norm"]) < 1e-4
    grads = {n: p.grad.numpy() for n, p in model.module.named_parameters()}
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        # a bias before a norm has a zero gradient, 1e-12 of noise on either side
        want = np.asarray(want_grads[n])
        assert np.abs(g - want).max() <= 2e-3 * np.abs(want).max() + 1e-9, n


def _jax_step_grads(jcfg, params, sources):
    keeper = _grad_keeper()
    step = jax.jit(make_train_step(jht.forward, jcfg, TrainConfig(loss="l1"), keeper))
    _, grads, metrics = step(params, keeper.init(params), jnp.asarray(sources),
                             jax.random.PRNGKey(0))
    return {k: np.asarray(v, np.float64) for k, v in flatten_state(grads).items()}, metrics


@pytest.mark.parametrize("precision", [dict(compute_dtype="bfloat16"),
                                       dict(bf16_stages=("transformer",))])
def test_bf16_train_step_matches_jax(precision):
    """One mixed-precision step against ``make_train_step`` on the same fp32
    masters: every gradient within the bound of the module docstring, and
    the port's parameters, gradients and Adam state all fp32 after it."""
    jcfg, params, model = _pair(**precision)
    sources = _sources(jcfg)
    want, metrics = _jax_step_grads(jcfg, params, sources)
    want32, _ = _jax_step_grads(dataclasses.replace(jcfg, compute_dtype="float32",
                                                    bf16_stages=()), params, sources)
    args = tconfig.TrainArgs()
    args.optim.lr = 0.0
    optimizer = tstep.make_optimizer(args, model)
    model.module.train()
    got = tstep.train_step(model, optimizer, torch.from_numpy(sources), loss="l1")
    assert _rel(got["loss"], metrics["loss"]) < 1e-3
    assert _rel(got["reco"], metrics["reco"]) < 1e-3
    assert _rel(got["grad_norm"], metrics["grad_norm"]) < 1e-2
    params_ = dict(model.module.named_parameters())
    assert set(params_) == set(want)
    largest = max(np.abs(w).max() for w in want.values())
    for n, p in params_.items():
        assert p.dtype == p.grad.dtype == torch.float32, n
        gap = np.abs(p.grad.double().numpy() - want[n]).max()
        assert gap <= 2 * np.abs(want[n] - want32[n]).max() + 2e-3 * largest, n
    state = [t for s in optimizer.state.values() for t in s.values() if t.dim() > 0]
    assert state and all(t.dtype == torch.float32 for t in state)


@pytest.mark.parametrize("kind,wd,clip,group", [
    ("adam", 0.0, 0.0, False), ("adam", 0.01, 0.0, False), ("adamw", 0.05, 0.0, False),
    ("adam", 0.0, 0.5, False), ("adamw", 0.01, 0.5, True)])
def test_optimizer_matches_optax(kind, wd, clip, group):
    extra = dict(t_lr=3e-3, t_weight_decay=0.1) if group else {}
    jcfg, params, model = _pair(**extra)
    jargs = jconfig.TrainArgs()
    targs = tconfig.TrainArgs()
    for a in (jargs, targs):
        a.optim.lr, a.optim.optim, a.optim.weight_decay, a.optim.clip_grad = 1e-3, kind, wd, clip
    opt = jax_make_optimizer(jargs, JaxModel("htdemucs", jcfg, params))
    state = opt.init(params)
    torch_opt = tstep.make_optimizer(targs, model)
    assert len(torch_opt.param_groups) == (2 if group else 1)
    rng = np.random.default_rng(0)
    names = [n for n, _ in model.module.named_parameters()]
    for _ in range(3):
        flat_g = {n: rng.standard_normal(np.shape(p)).astype(np.float32) * 0.1
                  for n, p in flatten_state(params).items()}
        from demucs_tpu.zoo.torch_load import nest_state

        updates, state = opt.update(nest_state(flat_g), state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.module.named_parameters():
            p.grad = torch.from_numpy(flat_g[n])
        tstep.clip_and_step(torch_opt, clip)
    want = flatten_state(params)
    got = dict(model.module.named_parameters())
    assert max(np.abs(got[n].detach().numpy() - np.asarray(want[n])).max() for n in names) < 1e-6


@pytest.mark.parametrize("kind", ["l1", "mse"])
def test_source_loss_matches_jax(kind):
    rng = np.random.default_rng(1)
    est, ref = (rng.standard_normal((3, 4, 2, 100)).astype(np.float32) for _ in range(2))
    w = (1.0, 0.5, 2.0, 1.0)
    loss, reco = tstep.source_loss(torch.from_numpy(est), torch.from_numpy(ref), kind, w)
    jloss, jreco = jax_source_loss(jnp.asarray(est), jnp.asarray(ref), kind, w)
    assert _rel(loss, jloss) < 1e-6 and _rel(reco, jreco) < 1e-6
    with pytest.raises(ValueError):
        tstep.source_loss(torch.from_numpy(est), torch.from_numpy(ref), "l3", w)


def test_trainargs_field_parity():
    def fields(cls_or_obj):
        return [(f.name, f.type if isinstance(f.type, str) else f.type.__name__)
                for f in dataclasses.fields(cls_or_obj)]

    def walk(j, t):
        assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
        for f in dataclasses.fields(j):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if dataclasses.is_dataclass(a):
                walk(a, b)
            else:
                assert a == b and type(a) is type(b), f.name

    walk(jconfig.TrainArgs(), tconfig.TrainArgs())
    assert set(tconfig.DSET_PRESETS) == set(jconfig.DSET_PRESETS)
    assert tconfig.DSET_PRESETS == jconfig.DSET_PRESETS


def test_overrides_and_signature_match_jax():
    tokens = ["epochs=3", "optim.lr=1e-4", "dset.wav=/data/x", "weights=[1, 2.5, 1, 1]",
              "continue_from='955717e8'", "dset.valid_samples=null", "augment.flip=false",
              "model_args={channels: 8, t_dropout: 0.1, multi_freqs: [0.5]}", "flag=debug",
              "dset=auto_mus", "ema.epoch=[0.9, 0.95]", "seed=-3", "test.overlap=.5"]
    want = jconfig.expand_presets(jconfig.parse_cli_overrides(tokens))
    got = tconfig.expand_presets(tconfig.parse_cli_overrides(tokens))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    jargs = jconfig.apply_overrides(jconfig.TrainArgs(), want)
    targs = tconfig.apply_overrides(tconfig.TrainArgs(), got)
    assert tconfig.xp_signature(targs) == jconfig.xp_signature(jargs)
    with pytest.raises(KeyError):
        tconfig.apply_overrides(tconfig.TrainArgs(), {"optim.lrr": 1.0})


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    mod = torch.nn.Linear(5, 3)
    mod.register_buffer("steps", torch.zeros(2, dtype=torch.int32))
    states = [{"weight": rng.standard_normal((3, 5)).astype(np.float32),
               "bias": rng.standard_normal(3).astype(np.float32),
               "steps": np.full(2, i, np.int32)} for i in range(4)]
    jema = JaxEMA({k: jnp.asarray(v) for k, v in states[0].items()}, decay=0.7)
    with torch.no_grad():
        for k, v in states[0].items():
            mod.state_dict()[k].copy_(torch.from_numpy(v))
    tema_ = tema.ModelEMA(mod, decay=0.7)
    for s in states[1:]:
        jema.update({k: jnp.asarray(v) for k, v in s.items()})
        with torch.no_grad():
            for k, v in s.items():
                mod.state_dict()[k].copy_(torch.from_numpy(v))
        tema_.update()
    assert tema_.count == pytest.approx(jema.count)
    for k in states[0]:
        assert _rel(tema_.state[k], jema.state[k]) < 1e-6
    live = {k: v.clone() for k, v in mod.state_dict().items()}
    with tema.swap(mod, tema_.state):
        torch.testing.assert_close(mod.weight.detach(), tema_.state["weight"])
    for k, v in mod.state_dict().items():
        torch.testing.assert_close(v, live[k], rtol=0, atol=0)


def test_augments_match_jax_draws():
    """Each augment applied to JAX's draws from a key gives JAX's output."""
    rng = np.random.default_rng(3)
    B, S, C, T = 4, 4, 2, 300
    wav = rng.standard_normal((B, S, C, T)).astype(np.float32)
    jw, tw = jnp.asarray(wav), torch.from_numpy(wav)
    key = jax.random.PRNGKey(7)
    for same in (False, True):
        offsets = jax.random.randint(key, (B, 1 if same else S, 1, 1), 0, 50)[:, :, 0, 0]
        want = jaug.shift_aug(key, jw, 50, same)
        got = taug.shift_with(tw, torch.from_numpy(np.array(offsets)), T - 50)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    left = jax.random.randint(key, (B, S, 1, 1), 0, 2)[..., 0, 0]
    np.testing.assert_array_equal(
        taug.flip_channels_with(tw, torch.from_numpy(np.asarray(left))).numpy(),
        np.asarray(jaug.flip_channels_aug(key, jw)))
    signs = jax.random.randint(key, (B, S, 1, 1), 0, 2)[..., 0, 0]
    np.testing.assert_array_equal(
        taug.flip_sign_with(tw, torch.from_numpy(np.asarray(signs))).numpy(),
        np.asarray(jaug.flip_sign_aug(key, jw)))
    k1, _ = jax.random.split(key)
    perm = jnp.argsort(jax.random.uniform(k1, (2, 2, S, 1, 1)), axis=1)[..., 0, 0]
    np.testing.assert_array_equal(
        taug.remix_with(tw, torch.from_numpy(np.asarray(perm)), 2).numpy(),
        np.asarray(jaug.remix_aug(key, jw, 1.0, 2)))
    scales = jax.random.uniform(k1, (B, S, 1, 1), minval=0.25, maxval=1.25)
    np.testing.assert_allclose((tw * torch.from_numpy(np.asarray(scales))).numpy(),
                               np.asarray(jaug.scale_aug(key, jw, 1.0, 0.25, 1.25)), rtol=1e-6)


def test_augment_pipeline_properties():
    rng = np.random.default_rng(4)
    wav = torch.from_numpy(rng.standard_normal((4, 4, 2, 500)).astype(np.float32))
    cfg = taug.AugmentConfig(shift=100, remix_group_size=2)
    aug = taug.make_augment(cfg, full=True)
    a = aug(wav, torch.Generator().manual_seed(1))
    b = aug(wav, torch.Generator().manual_seed(1))
    c = aug(wav, torch.Generator().manual_seed(2))
    assert a.shape == (4, 4, 2, 400)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # a shifted, flipped, signed, scaled stem is a window of some source of its group
    s = taug.shift_aug(wav, 100, True, torch.Generator().manual_seed(0))
    off = [o for o in range(100) if torch.equal(s[0, 0], wav[0, 0, :, o: o + 400])]
    assert len(off) == 1 and all(torch.equal(s[0, j], wav[0, j, :, off[0]: off[0] + 400])
                                 for j in range(4))
    r = taug.remix_aug(wav, 1.0, 2, torch.Generator().manual_seed(0))
    for g in range(2):
        for s_ in range(4):
            got = {r[2 * g + i, s_].sum().item() for i in range(2)}
            assert got == {wav[2 * g + i, s_].sum().item() for i in range(2)}
    with pytest.raises(ValueError, match="divisible"):
        taug.remix_aug(wav[:3], 1.0, 2, torch.Generator())
    assert torch.equal(taug.scale_aug(wav, 0.0, 0.5, 1.0, torch.Generator()), wav)


def test_cape_augment_matches_jax_draws():
    T, B, C = 50, 3, 16
    key = jax.random.PRNGKey(11)
    glob, loc, scale = 5000.0, 1.0, 1.4
    want = jtr.cape_embedding(T, C, B, mean_normalize=True, augment=True, rng=key,
                              max_global_shift=glob, max_local_shift=loc, max_scale=scale)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (1, B, 1), minval=-glob, maxval=glob),
             jax.random.uniform(k2, (T, B, 1), minval=-loc, maxval=loc),
             jax.random.uniform(k3, (1, B, 1), minval=-math.log(scale), maxval=math.log(scale)))
    got = ttr.cape_embedding_augmented(T, C, tuple(torch.from_numpy(np.asarray(d))
                                                   for d in draws))
    # phases reach 7e3 rad, where an fp32 ulp is 4.9e-4
    np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(want), 0, 1), atol=5e-4)
    d = ttr.cape_draws(T, B, (glob, loc, scale), torch.Generator().manual_seed(0))
    assert d[0].abs().max() <= glob and d[1].abs().max() <= loc
    assert d[2].abs().max() <= math.log(scale) and d[1].shape == (T, B, 1)


def test_transformer_train_mode_draws():
    """Train mode draws from the generator passed in: the same generator gives
    the same output, another seed another; eval mode draws nothing; a draw to
    make without a generator raises."""
    x = torch.randn(2, 3, 16, 4, generator=torch.Generator().manual_seed(0))
    for cfg in (dict(t_dropout=0.2), dict(t_sin_random_shift=30), dict(t_emb="cape")):
        _, _, model = _pair(**cfg)
        enc = model.module.crosstransformer.train()
        xs = torch.randn(2, enc.spec.dim, 4, 8, generator=torch.Generator().manual_seed(1))
        xt = torch.randn(2, enc.spec.dim, 40, generator=torch.Generator().manual_seed(2))
        a = enc(xs, xt, generator=torch.Generator().manual_seed(3))
        b = enc(xs, xt, generator=torch.Generator().manual_seed(3))
        c = enc(xs, xt, generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a[1], c[1])
        with pytest.raises(ValueError, match="generator"):
            enc(xs, xt)
        enc.eval()
        torch.testing.assert_close(enc(xs, xt), enc(xs, xt, generator=torch.Generator()),
                                   rtol=0, atol=0)
    del x


def test_overfit_loss_falls():
    cfg = tht.HTDemucsConfig(**SMALL)
    model = Model("htdemucs", cfg, tht.init_htdemucs(cfg, seed=0).train())
    args = tconfig.TrainArgs()
    args.optim.lr = 1e-2
    opt = tstep.make_optimizer(args, model)
    t = np.arange(cfg.training_length) / cfg.samplerate
    sources = np.stack([np.stack([0.3 * np.sin(2 * np.pi * f * t + p) for p in (0.0, 1.0)])
                        for f in (55.0, 110.0, 220.0, 440.0)])[None].astype(np.float32)
    sources = torch.from_numpy(sources)
    losses = [float(tstep.train_step(model, opt, sources, clip_grad=5.0)["loss"])
              for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) / 3, losses[::5]


def test_overfit_mixed_precision():
    """tests/test_overfit.py's mixed-precision case: bf16 compute inside the
    train step (fp32 masters, gradients and Adam state) still learns one
    batch, and everything the optimizer holds stays fp32."""
    cfg = tht.HTDemucsConfig(sources=tuple(SOURCES), channels=8, depth=4, nfft=2048,
                             t_layers=2, t_heads=4, segment=0.5, samplerate=8000,
                             compute_dtype="bfloat16")
    module = tht.init_htdemucs(cfg, seed=0, fp32_masters=True).train()
    model = Model("htdemucs", cfg, module)
    args = tconfig.TrainArgs()
    args.optim.lr = 3e-3
    opt = tstep.make_optimizer(args, model)
    t = np.arange(cfg.training_length) / cfg.samplerate
    sources = torch.from_numpy(np.stack([
        np.stack([0.3 * np.sin(2 * np.pi * f * t + p) for p in (0.0, 1.0)])
        for f in (55.0, 110.0, 220.0, 440.0)])[None].astype(np.float32))
    losses = [float(tstep.train_step(model, opt, sources, clip_grad=5.0)["loss"])
              for _ in range(60)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) / 3, losses[::10]
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(t.dtype == torch.float32 for s in opt.state.values() for t in s.values()
               if t.dim() > 0)


def _wav_folder(root, sr=8000, seconds=1.5):
    from demucs_tpu_torch.audio import write_wav

    for split, n in (("train", 2), ("valid", 1)):
        for i in range(n):
            d = root / split / f"track{i}"
            d.mkdir(parents=True)
            rng = np.random.default_rng(i + 10 * n)
            for s in SOURCES:
                write_wav(d / f"{s}.wav", (0.1 * rng.standard_normal(
                    (2, int(seconds * sr)))).astype(np.float32), sr)
    return root


def test_solver_two_epochs_then_resume(tmp_path):
    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.train.solver import Solver
    from demucs_tpu_torch.train.train import get_model, main

    root = _wav_folder(tmp_path / "wav")
    argv = [f"dset.wav={root}", "dset.use_musdb=false", "dset.segment=0.5", "dset.shift=0.25",
            "dset.samplerate=8000", f"dset.metadata={tmp_path / 'meta'}", "batch_size=4",
            "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 2, t_heads: 2, "
            "t_dropout: 0.1}", "epochs=2", "max_batches=1", "augment.repitch.proba=0",
            f"out_dir={tmp_path / 'out'}", "misc.num_workers=2", "ema.epoch=[0.9]",
            "save_every=1", "device=cpu"]
    main(argv)
    (folder,) = (tmp_path / "out" / "xps").iterdir()
    history = json.loads((folder / "history.json").read_text())
    assert len(history) == 2 and all(np.isfinite(h["train"]["loss"]) for h in history)
    assert (folder / "checkpoint_1.pkl").exists() and (folder / "best.dmx").exists()

    args = tconfig.apply_overrides(tconfig.TrainArgs(), tconfig.parse_cli_overrides(argv[:-1]))
    args.epochs = 3
    first = tconfig.apply_overrides(tconfig.TrainArgs(), tconfig.parse_cli_overrides(argv[:-1]))
    from demucs_tpu_torch.train.train import get_solver

    loaders = get_solver(first, device="cpu").loaders
    model = get_model(args, "cpu")
    solver = Solver(loaders, model, tstep.make_optimizer(args, model), args, folder)
    assert len(solver.history) == 2 and solver.optimizer.state  # resumed, moments too
    solver.train()
    resumed = json.loads((folder / "history.json").read_text())
    assert len(resumed) == 3 and resumed[:2] == history
    assert np.isfinite(resumed[2]["train"]["loss"])

    sep = Separator("best", repo=folder, device="cpu", shifts=0)
    mix = np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32) * 0.1
    _, stems = sep.separate_tensor(mix, 8000)
    assert set(stems) == set(SOURCES) and all(np.isfinite(s).all() for s in stems.values())


def test_solver_bf16_epoch_then_resume(tmp_path):
    """The entry point in bf16 mixed precision: one epoch, then a resume for a
    second; the checkpoint and best.dmx hold fp32 weights, and best.dmx
    serves through Separator in the compute_dtype it was trained with."""
    import pickle

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.train.train import main

    root = _wav_folder(tmp_path / "wav")
    argv = [f"dset.wav={root}", "dset.use_musdb=false", "dset.segment=0.5", "dset.shift=0.25",
            "dset.samplerate=8000", f"dset.metadata={tmp_path / 'meta'}", "batch_size=4",
            "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 2, t_heads: 2, "
            "t_dropout: 0.1, compute_dtype: bfloat16}", "epochs=1", "max_batches=1",
            "augment.repitch.proba=0", f"out_dir={tmp_path / 'out'}", "misc.num_workers=2",
            "device=cpu"]
    main(argv)
    (folder,) = (tmp_path / "out" / "xps").iterdir()
    with open(folder / "checkpoint.pkl", "rb") as f:
        package = pickle.load(f)
    assert all(v.dtype == np.float32 for v in package["state"].values()
               if np.issubdtype(v.dtype, np.floating))
    from demucs_tpu_torch.train.solver import Solver
    from demucs_tpu_torch.train.train import get_model, get_solver

    args = tconfig.apply_overrides(tconfig.TrainArgs(), tconfig.parse_cli_overrides(argv[:-1]))
    loaders = get_solver(args, device="cpu").loaders
    args.epochs = 2  # the same XP folder, one more epoch
    model = get_model(args, "cpu")
    solver = Solver(loaders, model, tstep.make_optimizer(args, model), args, folder)
    assert len(solver.history) == 1 and solver.optimizer.state  # resumed, moments too
    solver.train()
    history = json.loads((folder / "history.json").read_text())
    assert len(history) == 2 and all(np.isfinite(h["train"]["loss"]) for h in history)
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    from demucs_tpu_torch.zoo.native import load_native_model

    best = load_native_model(folder / "best.dmx", device="cpu")
    assert best.cfg.compute_dtype == "bfloat16"
    assert best.module.encoder[0].conv.weight.dtype == torch.bfloat16  # held in bf16 to serve
    sep = Separator("best", repo=folder, device="cpu", shifts=0)
    mix = np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32) * 0.1
    _, stems = sep.separate_tensor(mix, 8000)
    assert set(stems) == set(SOURCES) and all(np.isfinite(s).all() for s in stems.values())


@pytest.mark.parametrize("override,match", [
    (["svd.penalty=1.0", "svd.min_size=1e-3"], "svd"),
    (["quant.diffq=1e-4", "quant.min_size=1e-4"], "quant"),
    (["quant.qat=8", "quant.min_size=1e-4"], "quant"),
    ([], "repitch")])
def test_refused_options_raise(override, match, tmp_path):
    """The options the port once refused (each a case here since then) pass
    check_supported and train: one CPU step of ``python -m
    demucs_tpu_torch.train`` at the SMALL config with the reference's
    default augments (repitch at 0.2; every item repitched in a second
    epoch in the repitch case), a finite loss, and what each option logs."""
    from demucs_tpu_torch.train.train import check_supported, main

    root = _wav_folder(tmp_path / "wav")
    argv = [f"dset.wav={root}", "dset.use_musdb=false", "dset.segment=0.5", "dset.shift=0.25",
            "dset.samplerate=8000", f"dset.metadata={tmp_path / 'meta'}", "batch_size=4",
            "epochs=1", "max_batches=0", f"out_dir={tmp_path / 'out'}", "misc.num_workers=2",
            "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 2, t_heads: 2}"] + override
    check_supported(tconfig.apply_overrides(tconfig.TrainArgs(),
                                            tconfig.parse_cli_overrides(argv)))
    solver = main(argv + ["device=cpu"])
    train = solver.history[-1]["train"]
    assert np.isfinite(train["loss"])
    if match == "repitch":
        loader = solver.loaders["train"]
        assert type(loader.dataset).__name__ == "RepitchedWrapper"
        assert loader.dataset.proba == 0.2 == tconfig.TrainArgs().augment.repitch.proba
        loader.dataset.proba = 1.0
        loader.set_epoch(1)
        batch = next(iter(loader))
        assert batch.shape[-1] == int(0.88 * 0.5 * 8000) and np.isfinite(batch).all()
    else:  # the fired penalty, the quantized model's size in MB
        logged = {"svd": "penalty", "quant": "ms"}[match]
        assert np.isfinite(train[logged]) and train[logged] > 0


@pytest.mark.parametrize("override", [
    {"model_args": {"compute_dtype": "bfloat16"}},
    {"model_args": {"bf16_stages": ["transformer"]}}])
def test_bf16_training_is_accepted(override):
    """bf16 mixed precision trains (it was refused until K3's bf16 route had
    its dropout and backward): check_supported lets it through, and the
    entry point's model holds fp32 masters."""
    from demucs_tpu_torch.train.train import check_supported, get_model

    args = tconfig.apply_overrides(tconfig.TrainArgs(), {"augment.repitch.proba": 0.0})
    args = tconfig.apply_overrides(args, override)
    check_supported(args)
    args.model_args.update(channels=8, depth=2, nfft=512, t_layers=1, t_heads=2)
    args.dset.segment, args.dset.samplerate = 0.5, 8000
    model = get_model(args, "cpu")
    assert all(p.dtype == torch.float32 for p in model.module.parameters())


def test_more_than_one_process_is_refused(monkeypatch):
    from demucs_tpu_torch.train.train import check_supported

    args = tconfig.apply_overrides(tconfig.TrainArgs(), {"augment.repitch.proba": 0.0})
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one process"):
        check_supported(args)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_gives_the_same_gradients(compute_dtype):
    _, _, model = _pair(compute_dtype=compute_dtype)  # bf16: the casts are recomputed too
    sources = torch.from_numpy(_sources(model.cfg, batch=1))
    grads = []
    for remat in (False, True):
        m = copy.deepcopy(model.module).train()
        m.remat = remat
        loss, _ = tstep.forward_loss(Model("htdemucs", m.cfg, m), sources, "l1", (1,) * 4)
        loss.backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-8)
