"""Port's zoo (demucs_tpu_torch.zoo) against demucs_tpu.zoo, on the CPU, with
checkpoints written here in the reference's formats: ``.th`` packages
(``torch.save`` of ``{klass, args, kwargs, state}`` with a stub
``demucs.<family>.<Class>`` class, fp16 or diffq state), float and quantized
``.dmx`` archives written by the JAX package, and bag ``.yaml`` files.

What is held: the port's ``.th`` reader returns what JAX's ``read_th``
returns and neither runs code from the file; the config mapping, the Demucs
v2 rename shim, the diffq parameter order and ``dequantize_state`` equal
JAX's; every loader gives the JAX loader's weights, bit for bit (fp16
promoted to fp32); local repos check checksums; the remote repo reads a
cache it finds filled (nothing is fetched); ``demucs_unittest``'s forward
equals JAX's within 2e-4 x peak.
"""

import dataclasses
import fractions
import hashlib
import io
import pickle
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import demucs as jd
from demucs_tpu.models import hdemucs as jh
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import BagOfModels as JaxBag
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.zoo import diffq as jdiffq
from demucs_tpu.zoo import native as jnative
from demucs_tpu.zoo import pretrained as jpretrained
from demucs_tpu.zoo import torch_load as jload
from demucs_tpu.zoo.thpickle import ClassStub as JaxClassStub
from demucs_tpu.zoo.thpickle import read_th as jax_read_th
from demucs_tpu_torch.models.registry import FAMILIES, BagOfModels, Model
from demucs_tpu_torch.zoo import convert, diffq, native, pretrained, repo, thpickle

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_hdemucs import RTOL, rel_err

SOURCES = ("drums", "bass", "other", "vocals")
CLASSES = {"htdemucs": ("demucs.htdemucs", "HTDemucs"), "hdemucs": ("demucs.hdemucs", "HDemucs"),
           "demucs": ("demucs.demucs", "Demucs")}
SMALL = {
    "htdemucs": dict(channels=8, depth=4, nfft=2048, t_layers=2, t_heads=2, segment=0.5,
                     samplerate=8000),
    "hdemucs": dict(channels=8, nfft=1024, segment=0.5, samplerate=8000, dconv_lstm=3,
                    dconv_attn=3),
    "demucs": dict(channels=8, depth=4, segment=0.5, samplerate=8000, lstm_layers=2,
                   dconv_lstm=3, dconv_attn=3),
}
JAX_INIT = {"htdemucs": jht.init_htdemucs, "hdemucs": jh.init_hdemucs, "demucs": jd.init_demucs}
JAX_CFG = {"htdemucs": jht.HTDemucsConfig, "hdemucs": jh.HDemucsConfig,
           "demucs": jd.DemucsConfig}


def _jax_flat(kind, seed=0, **kw):
    cfg = JAX_CFG[kind](sources=SOURCES, **dict(SMALL[kind], **kw))
    return cfg, {k: np.array(v) for k, v in jload.flatten_state(JAX_INIT[kind](cfg, seed)).items()}


def write_th(folder, sig, kind, kwargs, state, args=()):
    """``<folder>/<sig>-<sha256[:8]>.th`` in the reference's format, the class
    pickled by name from a stub module (removed again afterwards)."""
    module_name, class_name = CLASSES[kind]
    mod = types.ModuleType(module_name)
    klass = type(class_name, (), {"__module__": module_name})
    setattr(mod, class_name, klass)
    added = [name for name in ("demucs", module_name) if name not in sys.modules]
    sys.modules.setdefault("demucs", types.ModuleType("demucs"))
    sys.modules[module_name] = mod
    try:
        buf = io.BytesIO()
        torch.save({"klass": klass, "args": args, "kwargs": kwargs, "state": state,
                    "training_args": {"epochs": 1}}, buf)
    finally:
        for name in added:
            sys.modules.pop(name, None)
    data = buf.getvalue()
    path = folder / f"{sig}-{hashlib.sha256(data).hexdigest()[:8]}.th"
    path.write_bytes(data)
    return path


def _half_state(flat):
    return {k: torch.from_numpy(v).half() for k, v in flat.items()}


def _kwargs(cfg):
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "sources"}
    kw["segment"] = fractions.Fraction(kw["segment"]).limit_denominator(100)
    return kw


def _assert_weights(model, flat):
    state = model.module.state_dict()
    assert set(state) == set(flat)
    for name, value in flat.items():
        assert state[name].dtype == torch.float32, name
        assert np.array_equal(state[name].numpy(), np.asarray(value, np.float32)), name


def test_th_reader_returns_what_jax_reads(tmp_path):
    cfg, flat = _jax_flat("hdemucs")
    state = _half_state(flat)
    state["a_bfloat16"] = torch.linspace(-3, 3, 7).bfloat16()
    path = write_th(tmp_path, "abcd0123", "hdemucs", _kwargs(cfg), state, args=(list(SOURCES),))
    got, want = thpickle.read_th(path), jax_read_th(path)
    assert isinstance(got["klass"], thpickle.ClassStub)
    assert isinstance(want["klass"], JaxClassStub)
    assert (got["klass"].__module__, got["klass"].__name__) == ("demucs.hdemucs", "HDemucs")
    assert got["args"] == want["args"] and got["kwargs"] == want["kwargs"]
    assert got["training_args"] == want["training_args"]
    assert set(got["state"]) == set(want["state"])
    for name, value in want["state"].items():
        if name == "a_bfloat16":  # numpy has no bfloat16: the port widens it
            assert np.array_equal(got["state"][name], np.asarray(value, np.float32))
            continue
        assert got["state"][name].dtype == value.dtype == np.float16
        assert np.array_equal(got["state"][name], value)


def test_th_readers_run_no_code(tmp_path):
    marker = tmp_path / "ran"

    class Evil:
        def __reduce__(self):
            import os

            return os.mkdir, (str(marker),)

    path = tmp_path / "evil.th"
    torch.save({"klass": Evil(), "state": {}}, path)
    for read in (thpickle.read_th, jax_read_th):
        with pytest.raises(pickle.UnpicklingError, match="allowlist"):
            read(path)
    assert not marker.exists()
    with pytest.raises(pickle.UnpicklingError, match="not a torch zip"):
        legacy = tmp_path / "legacy.th"
        legacy.write_bytes(b"\x80\x02}q\x00.")
        thpickle.read_th(legacy)


@pytest.mark.parametrize("klass,args,kwargs", [
    ("HDemucs", (list(SOURCES),), dict(channels=48, hybrid_old=True, cac=False,
                                      segment=fractions.Fraction(44), unknown=3)),
    ("WDemucs", (), dict(sources=list(SOURCES), nfft=2048, multi_freqs=[0.25, 0.5])),
    ("Demucs", (list(SOURCES), 2, 64), dict(lstm_layers=2, segment=10, resample=False)),
    ("HTDemucs", (), dict(sources=list(SOURCES), segment=fractions.Fraction(39, 5),
                          bottom_channels=512, t_layers=5)),
])
def test_config_mapping_equals_jax(klass, args, kwargs):
    cfg, kind = convert.config_from_torch_kwargs(klass, args, kwargs)
    jcfg, jkind = jload.config_from_torch_kwargs(klass, args, kwargs)
    assert kind == jkind and type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="Unknown model class"):
        convert.config_from_torch_kwargs("Transformer", (), {})


def test_demucs_v2_rename_shim_equals_jax():
    state = {"encoder.0.2.weight": 1, "encoder.0.2.bias": 2, "decoder.1.2.weight": 3,
             "decoder.1.3.weight": 4, "encoder.3.0.weight": 5}
    assert convert._demucs_v2_rename_shim(state, 4) == jload._demucs_v2_rename_shim(state, 4)
    assert "encoder.0.3.weight" in convert._demucs_v2_rename_shim(state, 4)


@pytest.mark.parametrize("kind,extra", [
    ("hdemucs", {}), ("hdemucs", dict(dconv_lstm=9, dconv_attn=9)),
    ("hdemucs", dict(multi_freqs=(0.25,), dconv_mode=3)),
    ("demucs", {}), ("demucs", dict(lstm_layers=0, dconv_lstm=9)),
    ("htdemucs", {}), ("htdemucs", dict(t_emb="scaled", bottom_channels=16)),
])
def test_param_order_equals_jax(kind, extra):
    jcfg = JAX_CFG[kind](sources=SOURCES, **dict(SMALL[kind], **extra))
    cfg = FAMILIES[kind][0](**dataclasses.asdict(jcfg))
    assert diffq.param_order(kind, cfg) == jdiffq.param_order(kind, jcfg)


def _quantized(kind):
    jcfg, flat = _jax_flat(kind, seed=4)
    state = jdiffq.quantize_state(flat, kind, jcfg, min_size_mb=0.002, group_size=8, bits=6)
    assert len(state["quantized"]) > 3 and len(state["others"]) > 3
    return jcfg, state


@pytest.mark.parametrize("kind", ["hdemucs", "demucs", "htdemucs"])
def test_dequantize_state_equals_jax(kind):
    jcfg, state = _quantized(kind)
    cfg = FAMILIES[kind][0](**dataclasses.asdict(jcfg))
    got = diffq.dequantize_state(state, kind, cfg)
    want = jdiffq.dequantize_state(state, kind, jcfg)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    state = dict(state, others=state["others"][:-1])
    with pytest.raises(ValueError, match="line up"):
        diffq.dequantize_state(state, kind, cfg)


@pytest.mark.parametrize("kind", ["hdemucs", "demucs", "htdemucs"])
def test_th_files_load_like_jax(kind, tmp_path):
    """A float16 package and a diffq-quantized one (tensors as torch saves
    them) load with the JAX loader's weights."""
    jcfg, flat = _jax_flat(kind, seed=6)
    float_path = write_th(tmp_path, "f" * 8, kind, _kwargs(jcfg), _half_state(flat),
                          args=(list(SOURCES),))
    _, state = _quantized(kind)
    state = dict(state, quantized=[tuple(torch.from_numpy(np.asarray(a)) for a in entry)
                                   for entry in state["quantized"]],
                 others=[torch.from_numpy(o) for o in state["others"]])
    quant_path = write_th(tmp_path, "q" * 8, kind, _kwargs(jcfg), state, args=(list(SOURCES),))
    for path in (float_path, quant_path):
        model = convert.load_th_model(path)
        jcfg2, jkind, jparams = jload.load_th_model(path)
        assert model.kind == jkind == kind
        assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jcfg2)
        _assert_weights(model, jload.flatten_state(jparams))


def test_demucs_v2_legacy_names_load(tmp_path):
    jcfg, flat = _jax_flat("demucs", rewrite=True, dconv_mode=0)
    def old_name(name):  # the rewrite conv at Sequential index 2
        parts = name.split(".")
        if len(parts) == 4 and parts[2] == "3":
            parts[2] = "2"
        return ".".join(parts)

    legacy = {old_name(k): v for k, v in flat.items()}
    assert legacy != flat
    path = write_th(tmp_path, "0" * 8, "demucs", _kwargs(jcfg), _half_state(legacy))
    _assert_weights(convert.load_th_model(path), jload.flatten_state(jload.load_th_model(path)[2]))


@pytest.mark.parametrize("kind", ["hdemucs", "demucs", "htdemucs"])
def test_quantized_dmx_written_by_jax_loads(kind, tmp_path):
    jcfg, state = _quantized(kind)
    jmodel = JaxModel(kind, jcfg, JAX_INIT[kind](jcfg, 0))
    path = tmp_path / "q.dmx"
    path.write_bytes(jnative.serialize_model(jmodel, quantized_state=state))
    model = native.load_native_model(path, device="cpu")
    want = jnative.load_native_model(path)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(want.cfg)
    _assert_weights(model, jload.flatten_state(want.params))


def _bag_folder(tmp_path):
    """Two .th and one .dmx model, checksummed names, and two bag files."""
    sigs = []
    for i, kind in enumerate(("demucs", "hdemucs")):
        jcfg, flat = _jax_flat(kind, seed=10 + i)
        write_th(tmp_path, f"{kind[:2]}{i:06d}", kind, _kwargs(jcfg), _half_state(flat),
                 args=(list(SOURCES),))
        sigs.append(f"{kind[:2]}{i:06d}")
    jcfg, _ = _jax_flat("hdemucs")
    content = jnative.serialize_model(JaxModel("hdemucs", jcfg, jh.init_hdemucs(jcfg, 12)))
    (tmp_path / f"dmx00002-{hashlib.sha256(content).hexdigest()[:8]}.dmx").write_bytes(content)
    sigs.append("dmx00002")
    (tmp_path / "mixed.yaml").write_text(
        f"models: ['{sigs[0]}', '{sigs[1]}', '{sigs[2]}']\n"
        "weights: [\n  [1., 1., 0., 0.],\n  [0., 1., 1., 1.],\n  [1., 0., 1., 1.],\n]\n"
        "segment: 2\n")
    (tmp_path / "single.yaml").write_text(f"models:\n- {sigs[2]}\n")
    return sigs


def test_local_repo_and_bags_load_like_jax(tmp_path):
    sigs = _bag_folder(tmp_path)
    listed = pretrained.list_models(tmp_path)
    assert set(listed["single"]) == set(sigs) and set(listed["bag"]) == {"mixed", "single"}
    bag = pretrained.get_model("mixed", tmp_path, device="cpu")
    jbag = jpretrained.get_model("mixed", tmp_path)
    assert isinstance(bag, BagOfModels) and isinstance(jbag, JaxBag)
    assert bag.weights == jbag.weights
    assert [m.kind for m in bag.models] == ["demucs", "hdemucs", "hdemucs"]
    assert [m.segment for m in bag.models] == [m.segment for m in jbag.models] == [2.0] * 3
    assert bag.max_allowed_segment == jbag.max_allowed_segment == float("inf")
    for model, jmodel in zip(bag.models, jbag.models):
        _assert_weights(model, jload.flatten_state(jmodel.params))
    single = pretrained.get_model(sigs[0], tmp_path, device="cpu")
    assert isinstance(single, Model) and single.kind == "demucs"
    # a file whose sha256 does not start with its name's hex is refused
    bad = next(tmp_path.glob(f"{sigs[1]}-*.th"))
    bad.write_bytes(bad.read_bytes() + b"\0")
    with pytest.raises(repo.ModelLoadingError, match="Invalid checksum"):
        pretrained.get_model(sigs[1], tmp_path, device="cpu")
    with pytest.raises(repo.ModelLoadingError, match="neither"):
        pretrained.get_model("nothing", tmp_path, device="cpu")
    with pytest.raises(repo.ModelLoadingError, match="directory"):
        pretrained.get_model("mixed", tmp_path / "absent", device="cpu")


def test_bag_segment_raises_all_but_htdemucs():
    cfgs = {"htdemucs": dict(SMALL["htdemucs"], segment=3.0), "hdemucs": SMALL["hdemucs"]}
    models = [Model(kind, FAMILIES[kind][0](sources=SOURCES, **kw),
                    FAMILIES[kind][1](FAMILIES[kind][0](sources=SOURCES, **kw)))
              for kind, kw in cfgs.items()]
    bag = BagOfModels(models, segment=5.0)
    assert [m.segment for m in bag.models] == [3.0, 5.0]
    assert bag.models[1].module.cfg.segment == 5.0
    assert bag.max_allowed_segment == 3.0
    assert BagOfModels(models, segment=1.0).models[1].segment == 5.0  # never lowered


def test_remote_repo_reads_a_filled_cache(tmp_path):
    jcfg, flat = _jax_flat("hdemucs", seed=3)
    src = write_th(tmp_path, "cafe0123", "hdemucs", _kwargs(jcfg), _half_state(flat),
                   args=(list(SOURCES),))
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / src.name).write_bytes(src.read_bytes())
    url = "https://example.invalid/demucs/" + src.name  # never fetched: the file is cached
    remote = repo.RemoteRepo({"cafe0123": url}, cache_dir=cache)
    bags = repo.BagOnlyRepo(None, remote, {"one": {"models": ["cafe0123"], "segment": 3}})
    any_repo = repo.AnyModelRepo(remote, bags)
    assert any_repo.has_model("cafe0123") and any_repo.has_model("one")
    _assert_weights(any_repo.get_model("cafe0123"),
                    {k: v.astype(np.float16) for k, v in flat.items()})
    assert any_repo.get_model("one").models[0].segment == 3.0
    with pytest.raises(repo.ModelLoadingError, match="signature"):
        remote.get_model("missing0")
    (cache / src.name).write_bytes(src.read_bytes()[:-1])
    with pytest.raises(repo.ModelLoadingError, match="Invalid checksum"):
        remote.get_model("cafe0123")
    assert set(repo.REMOTE_BAGS) == set(jpretrained.BagOnlyRepo(None, None).list_model())
    assert repo.REMOTE_BAGS == jpretrained.BagOnlyRepo(None, None).list_model()
    assert repo.REMOTE_FILES == jpretrained.RemoteRepo().list_model()


def test_bag_files_read_without_yaml(tmp_path):
    """The port's bag reader gives PyYAML's answer on the released bags'
    layouts (flow and block sequences, comments, a trailing comma)."""
    yaml = pytest.importorskip("yaml")
    texts = [
        "models: ['0d19c1c6', '7ecf8ec1']\nweights: [\n  [1., 1., 0., 0.],\n"
        "  [0., 1., 0., 0.],\n]\nsegment: 44\n",
        "# a bag\nmodels:\n- 955717e8\n- \"9a6b4851\"\nsegment: 7.8  # seconds\n",
    ]
    for name, bag in repo.REMOTE_BAGS.items():
        texts.append(yaml.safe_dump(bag, default_flow_style=False))
        texts.append(yaml.safe_dump(bag, default_flow_style=None))
    for i, text in enumerate(texts):
        path = tmp_path / f"b{i}.yaml"
        path.write_text(text)
        assert repo.read_bag_file(path) == yaml.safe_load(text), text
    (tmp_path / "bad.yaml").write_text("models: [a, b]\nsources: [x]\n")
    with pytest.raises(ValueError, match="bad.yaml"):
        repo.read_bag_file(tmp_path / "bad.yaml")


def test_demucs_unittest_equals_jax():
    model = pretrained.get_model("demucs_unittest", device="cpu")
    jmodel = jpretrained.get_model("demucs_unittest")
    assert model.kind == jmodel.kind == "hdemucs"
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    _assert_weights(model, jload.flatten_state(jmodel.params))
    mix = (np.random.default_rng(1).standard_normal((1, 2, 20000)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        got = model.module(torch.from_numpy(mix)).numpy()
    want = np.asarray(jax.jit(jh.forward, static_argnames=("cfg",))(
        jmodel.params, jnp.asarray(mix), jmodel.cfg))
    assert rel_err(got, want) < RTOL


def test_dmx_archive_layout_is_shared(tmp_path):
    """A float .dmx of each new kind written by the port loads in JAX and back."""
    for kind in ("hdemucs", "demucs"):
        jcfg, flat = _jax_flat(kind, seed=8)
        model = convert.model_from_flat(kind, FAMILIES[kind][0](**dataclasses.asdict(jcfg)),
                                        flat)
        path = native.save_model(model, tmp_path / f"{kind}.dmx", half=False)
        with zipfile.ZipFile(path) as zf:
            assert sorted(zf.namelist()) == ["meta.json", "params.npz"]
        _assert_weights(native.load_native_model(path, device="cpu"), flat)
        jmodel = jnative.load_native_model(path)
        assert jmodel.kind == kind
        want = jload.flatten_state(jmodel.params)
        assert all(np.array_equal(np.asarray(want[k]), flat[k]) for k in flat)


def test_cli_separates_a_bag_at_another_rate(tmp_path, capsys):
    """``-n <bag> --repo DIR`` on a 12 kHz WAV: resampled to the models' 8 kHz,
    four stems, those of Separator on the same file; ``--list-models``."""
    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.audio import read_wav, write_wav
    from demucs_tpu_torch.separate import main

    models = tmp_path / "models"
    models.mkdir()
    _bag_folder(models)
    track = tmp_path / "song.wav"
    wav = (np.random.default_rng(2).standard_normal((2, 9000)) * 0.1).astype(np.float32)
    write_wav(track, wav, 12000, as_float=True)
    main([str(track), "-n", "mixed", "--repo", str(models), "-o", str(tmp_path / "out"),
          "-d", "cpu", "--shifts", "0", "--float32"])
    _, want = Separator("mixed", repo=models, device="cpu", shifts=0).separate_audio_file(track)
    for name in SOURCES:
        got, sr = read_wav(tmp_path / "out" / "mixed" / "song" / f"{name}.wav")
        assert sr == 8000 and got.shape == want[name].shape == (2, 6000)
        ref = want[name] / max(1.01 * np.abs(want[name]).max(), 1)  # rescale clip mode
        assert np.abs(got - ref).max() <= 1e-6
    main(["--list-models", "--repo", str(models)])
    printed = capsys.readouterr().out
    assert "mixed" in printed and "de000000" in printed
