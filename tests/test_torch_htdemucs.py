"""Port's HTDemucs (demucs_tpu_torch.models.htdemucs) against demucs_tpu, with
the JAX package's weights carried across by load_flat_state.

Random weights start every LayerScale at its init (1e-4 in the transformer),
which hides the transformer's branches below the tolerance, and every norm at
weight 1 and bias 0, which makes a norm left out hard to see. So the
comparisons with the JAX forward set every LayerScale to 1.0 on both sides
(``_unit_scales``) and draw every GroupNorm and LayerNorm weight and bias at
random (``_random_norms``), and one test shows that a fault planted in the
port's transformer then fails the comparison. The golden case keeps the
weights its committed output was made with.

Tolerance: 2e-4 x peak of the output, the bound of tests/test_golden.py. Both
sides compute in fp32 on the CPU, but convolutions, products and reductions
sum in another order (XLA:CPU against oneDNN/ATen) through a deep network
with normalizations, so agreement is to a few fp32 ulps of the peak times
the depth, not bitwise. The released-width case uses every released width
(channels 48, nfft 4096, bottom_channels 512, 5 transformer layers, 8 heads,
dconv_mode 3) and shortens only the segment, to 1.0 s, to keep the CPU run
short.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.zoo.torch_load import flatten_state, nest_state
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models import transformer as ttr
from demucs_tpu_torch.zoo.convert import load_flat_state

sys.path.insert(0, str(Path(__file__).parent))
from test_golden import GOLDEN_DIR, SOURCES, _mix  # noqa: E402
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)

RELEASED = dict(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                bottom_channels=512, samplerate=44100)
RTOL = 2e-4  # x peak of the output


def _golden_cfg():
    return jht.HTDemucsConfig(sources=SOURCES, channels=16, depth=4, nfft=2048,
                              t_layers=3, t_heads=4, segment=0.5, samplerate=8000)


def _port_model(jcfg, params):
    tcfg = tht.HTDemucsConfig(**dataclasses.asdict(jcfg))
    flat = {k: np.asarray(v) for k, v in flatten_state(params).items()}
    return load_flat_state(tht.HTDemucs(tcfg), flat).eval()


def _unit_scales(params):
    """Every LayerScale (transformer gamma_1/gamma_2 and DConv) at 1.0."""
    flat = flatten_state(params)
    return nest_state({k: np.ones_like(v) if k.endswith(".scale") else v
                       for k, v in flat.items()})


def _random_norms(params, jcfg, seed=0):
    """Every GroupNorm and LayerNorm weight 1 + 0.3 N(0, 1), bias 0.3 N(0, 1),
    drawn with numpy in the order of the sorted parameter names."""
    model = tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg)))
    norms = {f"{name}.{p}" for name, mod in model.named_modules()
             if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) for p in ("weight", "bias")}
    rng = np.random.default_rng(seed)
    flat = dict(flatten_state(params))
    for k in sorted(norms):
        noise = 0.3 * rng.standard_normal(np.shape(flat[k]))
        flat[k] = (noise + (k.endswith(".weight"))).astype(np.float32)
    return nest_state(flat)


def _test_params(jcfg, seed):
    return _random_norms(_unit_scales(jht.init_htdemucs(jcfg, seed=seed)), jcfg)


def _rel_err(got, want) -> float:
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_forward(params, mix, cfg):
    return jax.jit(jht.forward, static_argnames=("cfg",))(params, jnp.asarray(mix), cfg)


def _forward(model, mix):
    with torch.inference_mode():
        return model(torch.from_numpy(mix)).numpy()


def test_golden_htdemucs():
    jcfg = _golden_cfg()
    model = _port_model(jcfg, jht.init_htdemucs(jcfg, seed=7))
    want = np.load(GOLDEN_DIR / "htdemucs.npz")["out"]
    got = _forward(model, _mix(jcfg.training_length))
    assert _rel_err(got, want) < RTOL


@pytest.fixture(scope="module")
def released():
    """The released widths at a 1.0 s segment (unit LayerScales, random norms),
    a mix, and the JAX forward's output for it."""
    jcfg = jht.HTDemucsConfig(sources=SOURCES, segment=1.0, **RELEASED)
    params = _test_params(jcfg, 3)
    mix = (np.random.default_rng(0).standard_normal((1, 2, 44100)) * 0.1).astype(np.float32)
    return jcfg, params, mix, np.asarray(_jax_forward(params, mix, jcfg))


def test_released_widths_match_jax_forward(released):
    jcfg, params, mix, want = released
    got = _forward(_port_model(jcfg, params), mix)
    assert got.shape == (1, 4, 2, 44100)
    assert _rel_err(got, want) < RTOL


def test_shorter_input_is_padded_to_the_training_segment():
    jcfg = _golden_cfg()
    params = _test_params(jcfg, 7)
    mix = _mix(3000)
    want = np.asarray(_jax_forward(params, mix, jcfg))
    got = _forward(_port_model(jcfg, params), mix)
    assert got.shape == (1, 4, 2, 3000)
    assert _rel_err(got, want) < RTOL


@pytest.mark.parametrize("fault", ["attention_zeros", "keys_values_swapped",
                                   "feed_forward_zeros", "norm_left_out"])
def test_planted_transformer_fault_fails_the_comparison(fault, monkeypatch, released):
    """With unit LayerScales and random norms the comparison sees every
    transformer layer, and a norm left out. At the released widths: in the
    golden config's small transformer a left-out norm3 moves the output by
    less than 10x the tolerance."""
    jcfg, params, mix, want = released
    model = _port_model(jcfg, params)
    assert _rel_err(_forward(model, mix), want) < RTOL
    mha = ttr.flash_mha
    if fault == "attention_zeros":
        monkeypatch.setattr(ttr, "flash_mha",
                            lambda q, k, v, heads, mask=None: torch.zeros_like(q))
    elif fault == "keys_values_swapped":
        monkeypatch.setattr(ttr, "flash_mha",
                            lambda q, k, v, heads, mask=None: mha(q, v, k, heads, mask=mask))
    elif fault == "norm_left_out":  # the cross layers' norm3 returns its input
        norm3 = {id(layer.norm3) for layer in model.modules() if isinstance(layer, ttr.CrossLayer)}
        assert norm3
        layer_norm = ttr._layer_norm
        monkeypatch.setattr(ttr, "_layer_norm",
                            lambda norm, x: x if id(norm) in norm3 else layer_norm(norm, x))
    else:
        monkeypatch.setattr(ttr._Layer, "_ff", lambda self, x, generator: torch.zeros_like(x))
    assert _rel_err(_forward(model, mix), want) > 10 * RTOL


@pytest.mark.parametrize("variant", [
    dict(t_emb="scaled", t_cross_first=True),
    dict(t_norm_first=False, t_layer_scale=False, t_gelu=False),
    dict(t_norm_in=False, t_norm_in_group=True, bottom_channels=32, dconv_mode=1),
])
def test_transformer_variants_match_jax(variant):
    """The transformer options the port supports besides the released ones."""
    jcfg = dataclasses.replace(_golden_cfg(), **variant)
    params = _test_params(jcfg, 11)
    mix = _mix(jcfg.training_length)
    want = np.asarray(_jax_forward(params, mix, jcfg))
    got = _forward(_port_model(jcfg, params), mix)
    assert _rel_err(got, want) < RTOL


def test_config_fields_and_defaults_equal_jax():
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert fields(tht.HTDemucsConfig) == fields(jht.HTDemucsConfig)
    cfg = tht.HTDemucsConfig(segment=7.8)
    assert (cfg.hop_length, cfg.training_length) == (1024, 343980)


def test_state_dict_names_match_jax_params():
    jcfg = jht.HTDemucsConfig(sources=SOURCES, segment=1.0, **RELEASED)
    model = tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg)))
    names = set(model.state_dict())
    flat = flatten_state(jht.init_htdemucs(jcfg, seed=0))
    assert names == set(flat)
    for name in ("encoder.0.dconv.layers.1.3.weight", "crosstransformer.layers_t.2.gamma_1.scale",
                 "channel_upsampler_t.weight", "decoder.3.dconv.layers.0.6.scale",
                 "crosstransformer.layers.1.cross_attn.in_proj_weight",
                 "crosstransformer.layers.1.norm_out.weight", "freq_emb.embedding.weight"):
        assert name in names
        assert tuple(model.state_dict()[name].shape) == tuple(np.shape(flat[name]))


def test_load_flat_state_is_strict():
    jcfg = _golden_cfg()
    flat = {k: np.asarray(v) for k, v in flatten_state(jht.init_htdemucs(jcfg, seed=7)).items()}
    model = tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg)))
    half = {k: v.astype(np.float16) for k, v in flat.items()}
    load_flat_state(model, half)  # fp16 promotes to fp32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    missing = dict(flat)
    missing.pop("encoder.0.conv.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flat_state(model, missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flat_state(model, dict(flat, extra=np.zeros(1, np.float32)))


def test_unported_options_raise():
    """Every option builds (tests/test_torch_transformer_variants.py holds
    each against JAX) and trains, the SVD penalty too; an option the JAX
    package has not raises."""
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.train import check_supported

    for kw in (dict(cac=False), dict(t_emb="cape"), dict(t_sparse_self_attn=True),
               dict(multi_freqs=(0.5,)), dict(t_dropout=0.1),
               dict(t_sparse_self_attn=True, t_auto_sparsity=True),
               dict(compute_dtype="bfloat16"), dict(matmul_precision="highest")):
        tht.HTDemucs(tht.HTDemucsConfig(sources=SOURCES, channels=8, nfft=512,
                                        segment=0.5, samplerate=8000, **kw))
    args = TrainArgs(model_args={"compute_dtype": "bfloat16"})
    args.augment.repitch.proba = 0.0
    check_supported(args)
    args.svd.penalty = 1.0
    check_supported(args)  # the SVD penalty trains
    with pytest.raises(ValueError, match="unknown transformer embedding"):
        tht.HTDemucs(tht.HTDemucsConfig(sources=SOURCES, channels=8, nfft=512, segment=0.5,
                                        samplerate=8000, t_emb="rotary"))


def test_random_init_is_seeded():
    cfg = tht.HTDemucsConfig(sources=SOURCES, channels=8, nfft=2048, t_layers=1, t_heads=2,
                             segment=0.5, samplerate=8000)
    a = tht.init_htdemucs(cfg, seed=1).state_dict()
    b = tht.init_htdemucs(cfg, seed=1).state_dict()
    c = tht.init_htdemucs(cfg, seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.conv.weight"], c["encoder.0.conv.weight"])
    out = tht.init_htdemucs(cfg, seed=1).eval()(torch.from_numpy(_mix(4000)))
    assert out.shape == (1, 4, 2, 4000) and torch.isfinite(out).all()
