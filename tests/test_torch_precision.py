"""The port's precision policies (demucs_tpu_torch.models.htdemucs:
compute_dtype, bf16_stages, matmul_precision, precision_stages, and
precision_scope for all three families) against demucs_tpu on the CPU.

- bf16 stages: the port's HTDemucs and JAX's ``jht.forward`` (called op by
  op, without jit: jit fuses elementwise chains and skips their bf16
  roundings, which no op-by-op program repeats), same config and weights. The
  signal-to-error ratio of port against JAX must exceed each one's SER
  against its own fp32 forward by MARGIN_DB: the port rounds where JAX
  does (the ops' own tests: test_torch_attention.py's bf16 cases and the
  norms here), so the two bf16 forwards are closer to each other than either
  is to fp32.
- ``"mixed"``, every matmul precision string and ``precision_stages`` are
  bit-equal to fp32 on the CPU for every family, as JAX's are
  (tests/test_bf16.py::test_mixed_policy_cpu_equals_fp32).
- Unknown names raise ``ValueError`` with JAX's messages; the card refuses
  JAX's dot-algorithm names, listing what it takes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.models import demucs as jd
from demucs_tpu.models import hdemucs as jh
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.ops import nn as jnn
from demucs_tpu.zoo.torch_load import flatten_state, nest_state
from demucs_tpu_torch.inference import engine
from demucs_tpu_torch.models import demucs as td
from demucs_tpu_torch.models import hdemucs as th
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models.registry import Model, reconfigured
from demucs_tpu_torch.ops import nn as tnn
from demucs_tpu_torch.zoo.convert import load_flat_state

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SOURCES = ("drums", "bass", "other", "vocals")
MARGIN_DB = 3.0
PRECISIONS = (None, "highest", "float32", "high", "tensorfloat32", "default", "bfloat16")


def _ser(ref, out):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - out) ** 2), 1e-30))


@pytest.fixture(scope="module")
def ht_pair():
    """A small HTDemucs (bottom channels, 2 transformer layers of head dim 32),
    every LayerScale at 1.0 so that each branch counts, on both sides."""
    jcfg = jht.HTDemucsConfig(sources=SOURCES, channels=16, depth=4, nfft=2048, t_layers=2,
                              t_heads=2, segment=0.5, samplerate=8000, bottom_channels=64)
    flat = {k: (np.ones_like(v) if k.endswith(".scale") else np.asarray(v))
            for k, v in flatten_state(jht.init_htdemucs(jcfg, seed=3)).items()}
    tcfg = tht.HTDemucsConfig(**dataclasses.asdict(jcfg))
    module = load_flat_state(tht.HTDemucs(tcfg), flat).eval()
    mix = (np.random.default_rng(0).standard_normal((1, 2, 4000)) * 0.1).astype(np.float32)
    params = nest_state(flat)
    with torch.inference_mode():
        port32 = module(torch.from_numpy(mix)).numpy()
    return jcfg, params, Model("htdemucs", tcfg, module), mix, port32


@pytest.mark.parametrize("delta", [
    dict(compute_dtype="bfloat16"),
    dict(bf16_stages=("transformer",)),
    dict(bf16_stages=("encoder", "tencoder")),
    dict(bf16_stages=("decoder", "tdecoder")),
    dict(compute_dtype="bfloat16", precision_stages=(("encoder", "highest"),)),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_bf16_policies_match_jax(ht_pair, delta):
    jcfg, params, model, mix, port32 = ht_pair
    jax32 = np.asarray(jht.forward(params, jnp.asarray(mix), jcfg))
    want = np.asarray(jht.forward(params, jnp.asarray(mix), dataclasses.replace(jcfg, **delta)))
    policy = reconfigured(model, **delta)
    with torch.inference_mode():
        got = policy.module(torch.from_numpy(mix))
    assert got.dtype == torch.float32 and got.shape == mix.shape[:1] + (4,) + mix.shape[1:]
    got = got.numpy()
    to_jax, jax_to_32, port_to_32 = _ser(want, got), _ser(jax32, want), _ser(port32, got)
    assert to_jax > max(jax_to_32, port_to_32) + MARGIN_DB, (to_jax, jax_to_32, port_to_32)
    assert port_to_32 > 20  # still the same separation


def test_bf16_stage_parameters_held_in_bf16(ht_pair):
    _, _, model, _, _ = ht_pair
    policy = reconfigured(model, bf16_stages=("transformer", "decoder"))
    for stage in tht._STAGES:
        dtypes = {p.dtype for m in policy.module.stage_modules(stage) for p in m.parameters()}
        want = torch.bfloat16 if stage in ("transformer", "decoder") else torch.float32
        assert dtypes == {want}, stage
    # the original keeps its fp32 weights, and the policy's are those rounded once
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    for name, p in policy.module.named_parameters():
        assert torch.equal(p, model.module.get_parameter(name).to(p.dtype)), name
    assert policy.cfg.bf16_stages == ("transformer", "decoder") and policy.device == model.device


def _family(kind):
    if kind == "htdemucs":
        cfg = tht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                                 t_heads=2, segment=0.5, samplerate=8000)
        return Model(kind, cfg, tht.init_htdemucs(cfg, 1, layer_scale=1.0,
                                                  random_norms=True).eval())
    if kind == "hdemucs":
        cfg = th.HDemucsConfig(sources=SOURCES, channels=8, nfft=1024, samplerate=8000,
                               segment=0.5)
        return Model(kind, cfg, th.init_hdemucs(cfg, 1, layer_scale=1.0,
                                                random_norms=True).eval())
    cfg = td.DemucsConfig(sources=SOURCES, channels=8, depth=4, samplerate=8000, segment=0.5,
                          dconv_lstm=3, dconv_attn=3)
    return Model(kind, cfg, td.init_demucs(cfg, 1, layer_scale=1.0, random_norms=True).eval())


@pytest.fixture(scope="module", params=["htdemucs", "hdemucs", "demucs"])
def family(request):
    model = _family(request.param)
    mix = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((1, 2, 3000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        return model, mix, model.module(mix)


@pytest.mark.parametrize("precision", PRECISIONS[1:])
def test_every_precision_string_is_fp32_on_cpu(family, precision):
    model, mix, want = family
    with torch.inference_mode():
        got = reconfigured(model, matmul_precision=precision).module(mix)
    assert torch.equal(got, want)


@pytest.mark.parametrize("delta", [
    dict(compute_dtype="mixed"),
    dict(precision_stages=tuple((s, "bfloat16") for s in tht._STAGES)),
    dict(compute_dtype="mixed", precision_stages=(("transformer", "highest"),)),
], ids=["mixed", "precision_stages", "mixed-precision_stages"])
def test_mixed_and_precision_stages_are_fp32_on_cpu(delta):
    """HTDemucs's other knobs: compute_dtype and precision_stages."""
    model = _family("htdemucs")
    mix = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((1, 2, 3000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        want = model.module(mix)
        assert torch.equal(reconfigured(model, **delta).module(mix), want)


@pytest.mark.parametrize("delta,match", [
    (dict(bf16_stages=("bogus",)), "bf16_stages"),
    (dict(compute_dtype="float8"), "compute_dtype"),
    (dict(precision_stages=(("bogus", "highest"),)), "precision_stages"),
])
def test_unknown_names_raise_as_jax(ht_pair, delta, match):
    jcfg, params, model, mix, _ = ht_pair
    with pytest.raises(ValueError, match=match) as jax_err:
        jht.forward(params, jnp.asarray(mix), dataclasses.replace(jcfg, **delta))
    with pytest.raises(ValueError, match=match) as port_err:
        reconfigured(model, **delta)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kind", ["htdemucs", "hdemucs", "demucs"])
@pytest.mark.parametrize("name", ["BF16_BF16_F32_X3", "TF32_TF32_F32", "fastest"])
def test_card_refuses_names_it_has_no_counterpart_for(kind, name):
    cfgs = {"htdemucs": tht.HTDemucsConfig, "hdemucs": th.HDemucsConfig,
            "demucs": td.DemucsConfig}
    modules = {"htdemucs": tht.HTDemucs, "hdemucs": th.HDemucs, "demucs": td.Demucs}
    with pytest.raises(ValueError, match="'tensorfloat32'.*dot-algorithm"):
        modules[kind](cfgs[kind](channels=8, depth=4, matmul_precision=name))
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        with tht.precision_scope(name):
            pass


def test_jax_families_take_the_same_strings():
    """The strings the port accepts are the ones JAX's configs document, field
    for field (the dot-algorithm names aside)."""
    for jcls, tcls in ((jht.HTDemucsConfig, tht.HTDemucsConfig),
                       (jh.HDemucsConfig, th.HDemucsConfig), (jd.DemucsConfig, td.DemucsConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert jf["matmul_precision"] is tf["matmul_precision"] is None
    assert set(tht.PRECISIONS) == {None, "highest", "float32", "high", "tensorfloat32",
                                   "default", "bfloat16"}


@pytest.mark.parametrize("precision,flags", [
    (None, (False, False, False)), ("highest", (False, False, False)),
    ("tensorfloat32", (True, True, False)), ("high", (True, True, False)),
    ("bfloat16", (True, True, True)), ("default", (True, True, True))])
def test_precision_scope_flags(precision, flags):
    """(cuDNN TF32, cuBLAS TF32, bf16 operands) inside the scope, restored after."""
    def read():
        return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                tnn._BF16_OPERANDS)

    before = read()
    with tht.precision_scope(precision):
        assert read() == flags
        with tht.precision_scope(None):  # the DSP inside a bf16 scope
            assert read() == (False, False, False)
        assert read() == flags
    assert read() == before


def test_bf16_operands_leave_cpu_tensors_alone():
    x = torch.randn(2, 3, 50, generator=torch.Generator().manual_seed(0))
    w = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(1))
    with tht.precision_scope("bfloat16"):
        got = tnn.conv1d(x, w)
    assert torch.equal(got, torch.nn.functional.conv1d(x, w))


@pytest.mark.parametrize("op", ["group_norm", "layer_norm", "gelu", "glu", "conv1d", "linear"])
def test_bf16_ops_round_where_jax_does(op):
    """On the same bf16 inputs each op gives JAX's (op by op) bf16 values; at
    most a rare element one bf16 step off (fp32 sums in another order)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 40)).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
    b = (0.3 * rng.standard_normal(16)).astype(np.float32)
    cw = (0.2 * rng.standard_normal((16, 16, 3))).astype(np.float32)
    lw = (0.2 * rng.standard_normal((16, 40))).astype(np.float32)
    j = {n: jnp.asarray(a, jnp.bfloat16) for n, a in dict(x=x, w=w, b=b, cw=cw, lw=lw).items()}
    t = {n: torch.from_numpy(a).bfloat16() for n, a in dict(x=x, w=w, b=b, cw=cw, lw=lw).items()}
    calls = {
        "group_norm": (lambda m, a: m.group_norm(a["x"], 4, a["w"], a["b"])),
        "layer_norm": (lambda m, a: m.layer_norm(a["x"].reshape(-1, 16, 40)[..., :16], a["w"],
                                                 a["b"])),
        "gelu": (lambda m, a: m.gelu(a["x"])),
        "glu": (lambda m, a: m.glu(a["x"], axis=1)),
        "conv1d": (lambda m, a: m.conv1d(a["x"], a["cw"], a["b"], padding=1)),
        "linear": (lambda m, a: m.linear(a["x"], a["lw"], a["b"])),
    }
    want = np.asarray(calls[op](jnn, j).astype(jnp.float32))
    got = calls[op](tnn, t)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got != want) <= 1e-3
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_reconfigured_model_never_replays_another_policys_graph(monkeypatch):
    """GraphCache keys on the module and checks its parameters and config:
    a model re-configured to another policy (a new module) and a module whose
    config changes in place are each captured anew, never replayed from a
    graph captured under the old policy. The capture is stubbed (CUDA graphs
    need the card): each stub records the policy its forward ran under."""
    captured = []

    class StubGraph:
        def __init__(self, module, shape, device, pool):
            self.module = __import__("weakref").ref(module)
            self.state = engine._graph_state(module)
            self.launches = {k.__name__: 0 for k in engine.KERNELS}
            self.policy = (module.cfg.compute_dtype, module.cfg.matmul_precision)
            self.capture_s = self.warmup_s = 0.0
            captured.append(self.policy)

        def __call__(self, batch):
            return self.policy

    monkeypatch.setattr(engine, "BatchGraph", StubGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    graphs = engine.GraphCache()
    base = _family("htdemucs")
    batch = torch.zeros(2, 2, 4000)
    assert graphs.forward(base.module, batch) == ("float32", None)
    assert graphs.forward(base.module, batch) == ("float32", None)  # replayed
    for delta, want in ((dict(compute_dtype="bfloat16"), ("bfloat16", None)),
                        (dict(matmul_precision="tensorfloat32"), ("float32", "tensorfloat32"))):
        policy = reconfigured(base, **delta)
        assert graphs.forward(policy.module, batch) == want
    base.module.cfg = dataclasses.replace(base.cfg, matmul_precision="highest")
    assert graphs.forward(base.module, batch) == ("float32", "highest")
    assert captured == [("float32", None), ("bfloat16", None), ("float32", "tensorfloat32"),
                        ("float32", "highest")]
    assert graphs.replays == 5
