"""The port's export of the HTDemucs core (demucs_tpu_torch/export) against
its eager model and the JAX package's export tools, on the CPU at the small
config of tests/common.py.

- the exported, saved and reloaded core against the port's eager
  ``forward_core`` (1e-6 x peak: the same ops on the same weights) and
  against JAX's ``forward_core`` with the same weights (2e-4 x peak, the
  golden bound); K3 is ``k3_per_forward`` nodes of the registered op and the
  graph holds no softmax;
- ``torch.library.opcheck`` of the op on CPU tensors;
- the runtime (``export/run.py``) against the port's ``apply_model`` and
  against JAX's ``tools/run_stablehlo.py`` on JAX's own artifact (5e-4 abs,
  the bound of tests/test_stablehlo_roundtrip.py), and its CLI on a WAV
  with the weights of a ``.dmx``;
- the meta against ``tools/export_tflite.py``'s keys and JAX's input shapes;
- ``export/release.py`` on one-epoch XPs of the port's trainer, plain and
  DiffQ, read by JAX's ``load_native_model``;
- ``save_with_checksum``'s name against JAX's on the same bytes;
- the refused precisions.
"""

import ast
import collections
import dataclasses
import hashlib
import json
import sys
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JModel
from demucs_tpu.zoo import native as jnative
from demucs_tpu.zoo.torch_load import nest_state
from demucs_tpu_torch.export import core as tcore
from demucs_tpu_torch.export import release as trelease
from demucs_tpu_torch.export import run as trun
from demucs_tpu_torch.kernels import attention as tattn
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.ops.spec import cac_pack, demucs_spec
from demucs_tpu_torch.zoo import native as tnative

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(REPO / "tools"))
from common import SOURCES, random_mix, small_htdemucs_kwargs  # noqa: E402
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_htdemucs import _port_model, _rel_err, _test_params  # noqa: E402

EAGER_RTOL = 1e-6  # x peak: the exported program against the eager core
JAX_RTOL = 2e-4  # x peak: against the JAX package (tests/test_golden.py's bound)
RUNTIME_ATOL = 5e-4  # the runtime's stems (tests/test_stablehlo_roundtrip.py's bound)


def _cfg(**extra):
    return jht.HTDemucsConfig(sources=tuple(SOURCES), **dict(small_htdemucs_kwargs(), **extra))


def _k3_nodes(program) -> int:
    return sum(n.target is torch.ops.demucs_tpu_torch.flash_mha.default
               for n in program.graph.nodes)


def _ops(program) -> collections.Counter:
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """JAX params (unit LayerScales, random norms), the port's model on them,
    and the port's artifact of it, saved and loaded on the CPU."""
    jcfg = _cfg()
    params = _test_params(jcfg, 5)
    model = _port_model(jcfg, params)
    out = tmp_path_factory.mktemp("core") / "core.pt2"
    shapes = tcore.export_core(model, out)
    return jcfg, params, model, out, shapes, tcore.load_core(out, "cpu")


def _core_inputs(cfg, seed=0):
    mix = torch.from_numpy(random_mix((1, 2, cfg.training_length), seed=seed))
    return cac_pack(demucs_spec(mix, cfg.nfft)), mix


def test_exported_core_matches_eager_and_jax(small):
    jcfg, params, model, _, _, core = small
    mag, mix = _core_inputs(jcfg)
    got = [t.numpy() for t in core(mag, mix)]
    with torch.inference_mode():
        eager = [t.numpy() for t in model.forward_core(mag, mix)]
    want = jax.jit(jht.forward_core, static_argnames=("cfg",))(
        params, jnp.asarray(mag.numpy()), jnp.asarray(mix.numpy()), jcfg)
    for g, e, w in zip(got, eager, want):
        assert _rel_err(g, e) <= EAGER_RTOL
        assert _rel_err(g, np.asarray(w)) < JAX_RTOL


@pytest.mark.parametrize("variant", [{}, dict(t_sparse_self_attn=True, t_sparse_cross_attn=True,
                                              t_sparse_attn_window=2, t_global_window=1)],
                         ids=["dense", "static_sparse"])
def test_graph_holds_k3_and_no_softmax(small, variant, tmp_path):
    """Every attention is one node of the registered op (2 x t_layers =
    k3_per_forward at this config), the static sparse mask its argument; no
    softmax is left in the graph."""
    jcfg, _, _, _, _, core = small
    program = core.program
    if variant:
        cfg = _cfg(**variant)
        model = _port_model(cfg, _test_params(cfg, 6))
        program = tcore.export_program(model)
        mag, mix = _core_inputs(cfg, seed=1)
        with torch.inference_mode():
            want = model.forward_core(mag, mix)
            got = program.module()(mag, mix)
        for g, w in zip(got, want):
            assert _rel_err(g.numpy(), w.numpy()) <= EAGER_RTOL
        masks = [n.args[4] for n in program.graph.nodes
                 if n.target is torch.ops.demucs_tpu_torch.flash_mha.default]
        assert all(m is not None for m in masks)
    assert _k3_nodes(program) == 2 * jcfg.t_layers == 6
    assert not [op for op in _ops(program) if "softmax" in op]


@pytest.mark.parametrize("masked", [False, True])
def test_op_opcheck_cpu(masked):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 64)).astype(np.float32))
               for n in (40, 70, 70))
    mask = torch.from_numpy(rng.random((40, 70)) < 0.7) if masked else None
    torch.library.opcheck(torch.ops.demucs_tpu_torch.flash_mha.default, (q, k, v, 2, mask))
    want = tattn.flash_mha_plain(q, k, v, 2, mask=mask)
    assert torch.equal(torch.ops.demucs_tpu_torch.flash_mha(q, k, v, 2, mask), want)


def test_separate_with_core_matches_apply_model_and_jax(small, tmp_path):
    """Past two training segments (a short tail chunk): the runtime against
    the port's host apply_model and against JAX's runtime on JAX's artifact."""
    from export_stablehlo import export_core as jax_export_core
    from run_stablehlo import load_core as jax_load_core
    from run_stablehlo import separate_with_core as jax_separate

    from demucs_tpu_torch.inference.apply import apply_model

    jcfg, params, model, _, _, core = small
    T = int(2.6 * jcfg.training_length)
    mix = random_mix((1, 2, T), seed=3)
    got = trun.separate_with_core(core, model.cfg, mix)
    want = apply_model(Model("htdemucs", model.cfg, model), mix, shifts=0, split=True,
                       overlap=0.25, engine="host")
    assert got.shape == want.shape == (1, 4, 2, T)
    np.testing.assert_allclose(got, want, atol=RUNTIME_ATOL, rtol=0)
    artifact = tmp_path / "core.stablehlo"
    jax_export_core(params, jcfg, artifact)
    jax_got = jax_separate(jax_load_core(artifact), params, jcfg, mix)
    np.testing.assert_allclose(got, jax_got, atol=RUNTIME_ATOL, rtol=0)


def test_run_cli_with_dmx_weights(small, tmp_path):
    """WAV in, stems out, the core from the artifact and the weights from a
    .dmx of other weights: the stems are the .dmx model's."""
    from demucs_tpu_torch.audio import read_audio, save_audio
    from demucs_tpu_torch.inference.apply import apply_model

    jcfg, _, _, artifact, _, _ = small
    module = _port_model(jcfg, _test_params(jcfg, 8))
    other = Model("htdemucs", module.cfg, module)
    dmx = tnative.save_model(other, tmp_path / "other.dmx", half=False)
    sr = jcfg.samplerate
    track = tmp_path / "track.wav"
    save_audio(random_mix((2, int(1.4 * sr)), seed=7, scale=0.05), track, sr,
               bits_per_sample=32, as_float=True, clip="none")
    out = tmp_path / "sep"
    trun.main(["--core", str(artifact), "--dmx", str(dmx), "-o", str(out), "-d", "cpu",
               "--float32", "--clip", "none", str(track)])
    decoded, _ = read_audio(track, samplerate=sr, channels=2)
    ref = decoded.mean(axis=0)
    mean, std = ref.mean(), ref.std() + 1e-8
    want = apply_model(other, ((decoded - mean) / std)[None], shifts=0, split=True,
                       overlap=0.25, engine="host") * std + mean
    for k, name in enumerate(SOURCES):
        stem, _ = read_audio(out / f"track_{name}.wav", samplerate=sr, channels=2)
        np.testing.assert_allclose(stem, want[0, k], atol=RUNTIME_ATOL, rtol=0)


def test_run_cli_needs_the_card_unless_asked(small, monkeypatch, tmp_path):
    _, _, _, artifact, _, _ = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--core", str(artifact), "--dmx", str(tmp_path / "x.dmx"),
                   str(tmp_path / "t.wav")])


def _tflite_meta_keys():
    """The keys of the ``meta`` dict literal in tools/export_tflite.py."""
    tree = ast.parse((REPO / "tools" / "export_tflite.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "meta" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no meta dict in tools/export_tflite.py")


def test_meta_matches_the_tflite_contract(small):
    """The keys of export_tflite.py's meta plus matmul_precision,
    compute_dtype and format, with the values it writes for this config and
    the input shapes JAX's export_stablehlo traces."""
    from demucs_tpu.ops.spec import cac_pack as jcac_pack
    from demucs_tpu.ops.spec import demucs_spec as jdemucs_spec

    jcfg, _, _, artifact, shapes, core = small
    meta = json.loads(tcore.meta_path(artifact).read_text())
    assert meta == core.meta
    assert list(meta) == _tflite_meta_keys() + ["matmul_precision", "compute_dtype", "format"]
    L = jcfg.training_length
    jmix = jnp.zeros((1, jcfg.audio_channels, L), jnp.float32)
    jmag = jcac_pack(jdemucs_spec(jmix, jcfg.nfft))
    assert meta == {
        "samplerate": jcfg.samplerate, "audio_channels": jcfg.audio_channels,
        "sources": list(jcfg.sources), "nfft": jcfg.nfft, "hop_length": jcfg.hop_length,
        "cac": jcfg.cac, "segment": jcfg.segment, "training_length": L,
        "inputs": {"mag": list(jmag.shape), "mix": list(jmix.shape)},
        "artifact": artifact.name, "matmul_precision": None, "compute_dtype": "float32",
        "format": "torch.export"}
    assert shapes == (tuple(jmag.shape), tuple(jmix.shape))


def _one_epoch_xp(root: Path, *override) -> Path:
    """One CPU epoch of python -m demucs_tpu_torch.train at a small width."""
    from test_torch_train import _wav_folder

    from demucs_tpu_torch.train.train import main

    wav = _wav_folder(root / "wav")
    main([f"dset.wav={wav}", "dset.use_musdb=false", "dset.segment=0.5", "dset.shift=0.25",
          "dset.samplerate=8000", f"dset.metadata={root / 'meta'}", "batch_size=4",
          "epochs=1", "max_batches=1", "augment.repitch.proba=0", f"out_dir={root / 'out'}",
          "misc.num_workers=0",
          "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 2, t_heads: 2}",
          *override, "device=cpu"])
    (folder,) = (root / "out" / "xps").iterdir()
    return folder


@pytest.mark.parametrize("override", [(), ("quant.diffq=1e-4", "quant.min_size=1e-4")],
                         ids=["plain", "diffq"])
def test_release_export_read_by_jax(override, tmp_path):
    """release.py on a one-epoch XP: the 8-hex sha256 name, the segment
    pinned to the trained one, and JAX's load_native_model computing the
    port's stems from it."""
    from demucs_tpu_torch.zoo.native import load_native_model

    folder = _one_epoch_xp(tmp_path, *override)
    out = tmp_path / "release"
    trelease.main([folder.name, "--out", str(out), "--outdir", str(folder.parent.parent)])
    (path,) = out.iterdir()
    content = path.read_bytes()
    assert path.name == f"{folder.name}-{hashlib.sha256(content).hexdigest()[:8]}.dmx"
    jmodel = jnative.load_native_model(path)
    tmodel = load_native_model(path, device="cpu")
    assert tmodel.cfg.segment == jmodel.cfg.segment == 0.5
    with zipfile.ZipFile(path) as zf:
        assert ("quantized" in json.loads(zf.read("meta.json"))) == bool(override)
    mix = random_mix((1, 2, tmodel.cfg.training_length), seed=4)
    with torch.inference_mode():
        got = tmodel.module(torch.from_numpy(mix)).numpy()
    want = jax.jit(jht.forward, static_argnames=("cfg",))(jmodel.params, jnp.asarray(mix),
                                                          jmodel.cfg)
    assert _rel_err(got, np.asarray(want)) < JAX_RTOL


def test_save_with_checksum_name_matches_jax(small, monkeypatch, tmp_path):
    """The same model, its parameters in the same order, saved by both
    packages at one clock reading: the same bytes and the same name."""
    jcfg, _, model, _, _, _ = small
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # the zip entries' timestamps
    flat = {n: t.numpy() for n, t in model.state_dict().items()}
    port = tnative.save_with_checksum(Model("htdemucs", model.cfg, model), tmp_path / "m.dmx",
                                      training_args={"epochs": 1})
    (tmp_path / "jax").mkdir()
    ref = jnative.save_with_checksum(JModel("htdemucs", jcfg, nest_state(flat)),
                                     tmp_path / "jax" / "m.dmx", training_args={"epochs": 1})
    assert port.read_bytes() == ref.read_bytes()
    assert port.name == ref.name
    assert port.name == f"m-{hashlib.sha256(port.read_bytes()).hexdigest()[:8]}.dmx"


@pytest.mark.parametrize("change", [dict(matmul_precision="default"),
                                    dict(matmul_precision="bfloat16"),
                                    dict(precision_stages=(("decoder", "tensorfloat32"),))])
def test_export_refuses_precisions_the_graph_cannot_hold(change):
    cfg = tht.HTDemucsConfig(**dataclasses.asdict(_cfg()))
    model = tht.HTDemucs(dataclasses.replace(cfg, **change)).eval()
    with pytest.raises(ValueError, match="precision"):
        tcore.export_program(model)


def test_export_records_tensorfloat32_for_the_runtime(tmp_path):
    cfg = tht.HTDemucsConfig(**dataclasses.asdict(_cfg(matmul_precision="tensorfloat32")))
    tcore.export_core(tht.HTDemucs(cfg).eval(), tmp_path / "c.pt2")
    core = tcore.load_core(tmp_path / "c.pt2", "cpu")
    assert core.meta["matmul_precision"] == "tensorfloat32"


def test_export_cli_from_a_repo_with_a_preset(small, tmp_path):
    """python -m demucs_tpu_torch.export.core -n SIG --repo DIR --preset
    balanced -d cpu: the zoo's weights in the program, the preset's
    precision in the meta."""
    jcfg, _, model, _, _, _ = small
    repo = tmp_path / "repo"
    repo.mkdir()
    tnative.save_model(Model("htdemucs", model.cfg, model), repo / "abcd1234.dmx", half=False)
    out = tmp_path / "cli.pt2"
    tcore.main(["-n", "abcd1234", "--repo", str(repo), "--out", str(out), "--preset",
                "balanced", "-d", "cpu"])
    core = tcore.load_core(out, "cpu")
    assert core.meta["matmul_precision"] == "tensorfloat32"
    state = model.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in core.program.state_dict.items())
