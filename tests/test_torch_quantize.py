"""The port's quantization-aware training (demucs_tpu_torch.train.quantize, the
quantize side of demucs_tpu_torch.zoo.diffq, the Solver's DiffQ and QAT
paths) against the JAX package's (demucs_tpu.train.quantize,
demucs_tpu.zoo.diffq) on the same weights and, for DiffQ, the same noise
(JAX's draw injected); the solver smokes of tests/test_quantize.py:98,151.

Tolerances:
- ste_params, eval_params: 1e-6 absolute (the same few fp32 operations);
- model_size_mb and its gradient: 1e-6 relative;
- quantize_state: levels and bits equal, scales within 1e-7 (the same numpy
  arithmetic); decoded through both packages' dequantize_state: equal;
- a train step (small HTDemucs, l1, dropout 0): loss 1e-5 relative, each
  model gradient and each logit gradient within 2e-4 x its peak plus 1e-9
  (fp32 through the network, summed in another order by XLA:CPU and ATen;
  a bias before a norm has a zero gradient, 1e-12 of noise on either side).
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
from demucs_tpu.train import quantize as jq
from demucs_tpu.train.step import source_loss as jax_source_loss
from demucs_tpu.zoo import diffq as jdiffq
from demucs_tpu.zoo.torch_load import flatten_state, nest_state
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.train import config as tconfig
from demucs_tpu_torch.train import quantize as tq
from demucs_tpu_torch.train import step as tstep
from demucs_tpu_torch.zoo import diffq as tdiffq
from demucs_tpu_torch.zoo.convert import load_flat_state

from common import SOURCES
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_train import SMALL, _wav_folder

MIN_SIZE = 1e-4  # MB: the small model's convs and linears are quantized
DIFFQ = dict(mode="diffq", penalty=1e-2, min_size=MIN_SIZE, group_size=8)
QAT = dict(mode="qat", bits=5, min_size=MIN_SIZE, group_size=0)


def _pair(compute_dtype="float32"):
    jcfg = jht.HTDemucsConfig(**SMALL, compute_dtype=compute_dtype)
    flat = {k: np.ones_like(v) if k.endswith(".scale") else np.asarray(v)
            for k, v in flatten_state(jht.init_htdemucs(jcfg, seed=0)).items()}
    module = load_flat_state(tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg))).float(),
                             flat)
    return jcfg, nest_state(flat), Model("htdemucs", module.cfg, module)


def _logits(names, flat, spec, seed=1):
    """Seeded logits around 8 bits, one per group, the same in both packages."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in names:
        groups = flat[name].size // spec.group_size if spec.group_size else 1
        out[name] = (0.4 * rng.standard_normal(groups)).astype(np.float32)
    return out


def _jax_noise(key, logits, flat, spec):
    """The noise JAX's noisy_params draws for ``key``: one split per name, sorted."""
    names = sorted(logits)
    keys = jax.random.split(key, max(1, len(names)))
    return {n: torch.from_numpy(np.array(jax.random.normal(
        k, (flat[n].size // spec.group_size, spec.group_size), dtype=jnp.float32)))
        for k, n in zip(keys, names)}


def _peak_close(got, want, rtol=2e-4):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() <= rtol * np.abs(want).max() + 1e-9


def test_ste_and_eval_params_match_jax():
    _, params, model = _pair()
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    tparams = dict(model.module.named_parameters())
    for kw in (QAT, dict(QAT, bits=8), dict(QAT, group_size=8)):
        jspec, spec = jq.QuantSpec(**kw), tq.QuantSpec(**kw)
        names = tq.quantized_param_names("htdemucs", model.cfg, spec)
        want = flatten_state(jax.jit(lambda p: jq.ste_params(p, names, jspec))(params))
        got = tq.ste_params(tparams, names, spec)
        assert set(got) == set(names)
        for n in names:
            assert np.abs(got[n].detach().numpy() - np.asarray(want[n])).max() <= 1e-6, n
    jspec, spec = jq.QuantSpec(**DIFFQ), tq.QuantSpec(**DIFFQ)
    names = tq.quantized_param_names("htdemucs", model.cfg, spec)
    logits = _logits(names, flat, spec)
    logits = {n: v * 10 for n, v in logits.items()}  # from min_bits to max_bits
    want = flatten_state(jax.jit(lambda p, lg: jq.eval_params(p, lg, jspec))(
        params, {n: jnp.asarray(v) for n, v in logits.items()}))
    got = tq.eval_params(tparams, {n: torch.from_numpy(v) for n, v in logits.items()}, spec)
    for n in names:
        assert np.abs(got[n].detach().numpy() - np.asarray(want[n])).max() <= 1e-6, n


def test_ste_passes_the_gradient_straight_through():
    _, _, model = _pair()
    spec = tq.QuantSpec(**QAT)
    params = dict(model.module.named_parameters())
    names = tq.quantized_param_names("htdemucs", model.cfg, spec)
    sum(v.sum() for v in tq.ste_params(params, names, spec).values()).backward()
    for n in names:
        assert torch.equal(params[n].grad, torch.ones_like(params[n]))


def test_model_size_and_gradient_match_jax():
    _, params, model = _pair()
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    jspec, spec = jq.QuantSpec(**DIFFQ), tq.QuantSpec(**DIFFQ)
    names = tq.quantized_param_names("htdemucs", model.cfg, spec)
    logits = _logits(names, flat, spec)
    want, want_grad = jax.value_and_grad(lambda lg: jq.model_size_mb(lg, jspec))(
        {n: jnp.asarray(v) for n, v in logits.items()})
    tlogits = {n: torch.from_numpy(v).requires_grad_() for n, v in logits.items()}
    got = tq.model_size_mb(tlogits, spec)
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    for n in names:
        w = np.asarray(want_grad[n])
        assert np.abs(tlogits[n].grad.numpy() - w).max() <= 1e-6 * np.abs(w).max(), n
    # at 8 bits every quantized weight takes one byte
    init = tq.init_logits(dict(model.module.named_parameters()), names, spec)
    assert abs(float(tq.model_size_mb(init, spec)) - sum(flat[n].size for n in names) / 2**20) \
        <= 1e-9


@pytest.mark.parametrize("group_size,bits", [(8, 8), (8, 12), (0, 6), (16, 4)])
def test_quantize_state_matches_jax(group_size, bits):
    _, params, model = _pair()
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    kw = dict(min_size_mb=MIN_SIZE, group_size=group_size, bits=bits)
    want = jdiffq.quantize_state(flat, "htdemucs", model.cfg, **kw)
    got = tdiffq.quantize_state(flat, "htdemucs", model.cfg, **kw)
    assert len(got["quantized"]) == len(want["quantized"]) > 0
    for (gl, gs, gb), (wl, ws, wb) in zip(got["quantized"], want["quantized"]):
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl) and np.array_equal(gb, wb)
        assert np.abs(gs - ws).max() <= 1e-7
    assert all(np.array_equal(a, b) for a, b in zip(got["others"], want["others"]))
    assert got["meta"] == want["meta"]
    decoded = tdiffq.dequantize_state(got, "htdemucs", model.cfg)
    jdecoded = jdiffq.dequantize_state(got, "htdemucs", model.cfg)
    assert set(decoded) == set(flat)
    for n in decoded:
        np.testing.assert_array_equal(decoded[n], jdecoded[n])
    with pytest.raises(ValueError, match="group_size=2"):
        tdiffq.quantize_entry(flat["encoder.0.conv.weight"], 2, 8)


def test_quantized_param_names_full_width_match_jax():
    """At the released HTDemucs width (channels 48, nfft 4096, 5 layers),
    the port's walk gives JAX's names, at diffq's min_size and QAT's."""
    released = dict(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                    bottom_channels=512, samplerate=44100, segment=7.8)
    jcfg = jht.HTDemucsConfig(sources=tuple(SOURCES), **released)
    tcfg = tht.HTDemucsConfig(**dataclasses.asdict(jcfg))
    for kw in (dict(mode="diffq", min_size=0.2, group_size=8),
               dict(mode="qat", min_size=0.2, group_size=0, bits=8),
               dict(mode="diffq", min_size=0.01, group_size=8)):
        want = jq.quantized_param_names("htdemucs", jcfg, jq.QuantSpec(**kw))
        assert tq.quantized_param_names("htdemucs", tcfg, tq.QuantSpec(**kw)) == want
        assert len(want) > 10


@pytest.mark.parametrize("mode,compute_dtype", [("diffq", "float32"), ("qat", "float32"),
                                                ("diffq", "bfloat16")])
def test_train_step_matches_jax(mode, compute_dtype):
    """One train step with DiffQ's noise (JAX's draw injected) or QAT's STE:
    the loss with DiffQ's size term, every model gradient and every logit
    gradient against jax.value_and_grad of the JAX package's loss. In bf16
    (fp32 masters, every stage cast) the noise acts on the masters before
    the cast, as JAX's noisy_params runs before stage_params: held by its
    finite loss and gradients and by its gap to the fp32 step."""
    jcfg, params, model = _pair(compute_dtype)
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    kw = DIFFQ if mode == "diffq" else QAT
    jspec, spec = jq.QuantSpec(**kw), tq.QuantSpec(**kw)
    rng = np.random.default_rng(5)
    sources = (0.2 * rng.standard_normal((2, 4, 2, jcfg.training_length))).astype(np.float32)
    weights = (1.0, 2.0, 0.5, 1.0)
    quantizer = tq.Quantizer(spec, model)
    names = quantizer.names
    key = jax.random.PRNGKey(3)
    noise = None
    jlogits = None
    if mode == "diffq":
        logits = _logits(names, flat, spec)
        jlogits = {n: jnp.asarray(v) for n, v in logits.items()}
        with torch.no_grad():
            for n, v in logits.items():
                quantizer.logits[n].copy_(torch.from_numpy(v))
        noise = _jax_noise(key, logits, flat, spec)

    def full_loss(p, lg):
        q = (jq.noisy_params(p, lg, key, jspec) if mode == "diffq"
             else jq.ste_params(p, names, jspec))
        est = jht.forward(q, jnp.asarray(sources).sum(axis=1), jcfg, train=True,
                          rng=jax.random.PRNGKey(0))
        loss, _ = jax_source_loss(est, jnp.asarray(sources), "l1", jnp.asarray(weights))
        return loss + (jspec.penalty * jq.model_size_mb(lg, jspec) if mode == "diffq" else 0.0)

    want, (want_grads, want_lgrads) = jax.jit(jax.value_and_grad(full_loss, argnums=(0, 1)))(
        params, jlogits)
    want_grads = flatten_state(want_grads)
    args = tconfig.TrainArgs()
    args.optim.lr = 0.0
    optimizer = tstep.make_optimizer(args, model)
    model.module.train()
    got = tstep.train_step(model, optimizer, torch.from_numpy(sources), loss="l1",
                           weights=weights, quantizer=quantizer, quant_noise=noise)
    assert np.isfinite(float(got["loss"])) and float(got["ms"]) > 0
    if compute_dtype == "bfloat16":
        # bf16 rounds at every op (test_torch_train's bf16 tolerance: 1e-3 relative on the loss)
        assert abs(float(got["loss"]) - float(want)) <= 1e-3 * abs(float(want))
        assert all(torch.isfinite(p.grad).all() for p in model.module.parameters())
        assert all(torch.isfinite(v.grad).all() and v.grad.abs().max() > 0
                   for v in quantizer.logits.values())
        return
    assert abs(float(got["loss"]) - float(want)) <= 1e-5 * abs(float(want))
    for n, p in model.module.named_parameters():
        assert _peak_close(p.grad.numpy(), want_grads[n]), n
    if mode == "diffq":
        for n, v in quantizer.logits.items():
            assert _peak_close(v.grad.numpy(), want_lgrads[n]), n
        # the logits took one step of their own Adam at 1e-3, optax.adam's
        adam = optax.adam(1e-3)
        updates, _ = adam.update(want_lgrads, adam.init(jlogits))
        for n, v in quantizer.logits.items():
            assert _peak_close(v.detach().numpy() - logits[n], updates[n]), n
    else:
        assert float(got["ms"]) == pytest.approx(
            sum(flat[n].size for n in names) * 5 / 8 / 2**20, rel=1e-12)


def _solver_args(root, tmp_path, **over):
    argv = [f"dset.wav={root}", "dset.use_musdb=false", "dset.segment=0.5", "dset.shift=0.25",
            "dset.samplerate=8000", f"dset.metadata={tmp_path / 'meta'}", "batch_size=4",
            "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 1, t_heads: 2}",
            "epochs=1", "max_batches=1", "augment.repitch.proba=0",
            f"out_dir={tmp_path / 'out'}", "misc.num_workers=2", "quant.min_size=0.0001"]
    argv += [f"{k}={v}" for k, v in over.items()]
    return tconfig.apply_overrides(tconfig.TrainArgs(), tconfig.parse_cli_overrides(argv))


def test_diffq_solver_smoke(tmp_path):
    """DiffQ through the Solver: the logits train, ms is logged, a resume
    restores the logits and their Adam, and the quantized export decodes
    near the trained weights, loads as a .dmx and separates."""
    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.train.train import get_solver
    from demucs_tpu_torch.zoo.native import load_native_model, save_model

    root = _wav_folder(tmp_path / "wav")
    args = _solver_args(root, tmp_path, **{"quant.diffq": 1e-4, "quant.group_size": 8})
    solver = get_solver(args, device="cpu")
    init = {k: v.detach().clone() for k, v in solver.quantizer.logits.items()}
    solver.train()
    m = solver.history[-1]["train"]
    assert np.isfinite(m["loss"]) and m["ms"] > 0
    assert any(not torch.equal(solver.quantizer.logits[k], init[k]) for k in init)

    resumed = get_solver(args, device="cpu")
    assert len(resumed.history) == 1
    for k in init:
        assert torch.equal(resumed.quantizer.logits[k], solver.quantizer.logits[k])
    assert resumed.quantizer.optimizer.state_dict()["state"].keys() == \
        solver.quantizer.optimizer.state_dict()["state"].keys() != set()

    qstate = solver.quantized_state()
    flat = tdiffq.dequantize_state(qstate, solver.model.kind, solver.model.cfg)
    want = {n: p.detach().numpy() for n, p in solver.model.module.named_parameters()}
    assert set(flat) == set(want)
    name = max(flat, key=lambda n: flat[n].size)
    snr = 20 * np.log10(np.linalg.norm(want[name])
                        / (np.linalg.norm(flat[name] - want[name]) + 1e-12))
    assert snr > 30, (name, snr)
    folder = tmp_path / "zoo"
    folder.mkdir()
    save_model(solver.model, folder / "q.dmx", quantized_state=qstate)
    loaded = load_native_model(folder / "q.dmx", device="cpu")
    got = dict(loaded.module.named_parameters())
    np.testing.assert_allclose(got[name].detach().numpy(), flat[name], atol=1e-6)
    meta = json.loads(__import__("zipfile").ZipFile(folder / "q.dmx").read("meta.json"))
    assert meta["quantized"]["meta"]["klass"] == "DiffQuantizer"
    sep = Separator("q", repo=folder, device="cpu", shifts=0)
    mix = np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32) * 0.1
    _, stems = sep.separate_tensor(mix, 8000)
    assert set(stems) == set(SOURCES) and all(np.isfinite(s).all() for s in stems.values())


def test_qat_solver_smoke(tmp_path):
    """QAT (6 bits) through the Solver on Demucs v2: finite train and valid
    losses, validation on the quantized weights, and the UniformQuantizer
    export."""
    from demucs_tpu_torch.train.train import get_solver

    root = _wav_folder(tmp_path / "wav")
    args = _solver_args(root, tmp_path, **{
        "quant.qat": 6, "model": "demucs", "model_args": "{channels: 4, depth: 2, "
        "resample: false, dconv_mode: 0, lstm_layers: 0}", "ema.batch": "[]", "ema.epoch": "[]"})
    solver = get_solver(args, device="cpu")
    assert solver.quantizer.logits is None and solver.quantizer.names
    solver.train()
    assert np.isfinite(solver.history[-1]["train"]["loss"])
    assert np.isfinite(solver.history[-1]["valid"]["loss"])
    qstate = solver.quantized_state()
    assert qstate["meta"] == {"klass": "UniformQuantizer",
                              "init_kwargs": {"min_size": 0.0001, "bits": 6}}
    flat = tdiffq.dequantize_state(qstate, "demucs", solver.model.cfg)
    for n in solver.quantizer.names:
        assert len(np.unique(flat[n])) <= 2 ** 6
