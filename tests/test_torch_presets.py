"""The serving presets (demucs_tpu_torch.presets) and the CLI flags of this
slice (--preset, --shift-offsets, -v, --clip-mode, -j) against demucs_tpu's,
and Separator's precision and pinned-shift keywords.

The presets' contents and the explicit-wire rule equal JAX's; only the
contract text differs (the card's policies in words, no TPU figures).
Separator results are held to 1e-5 x peak, the engines' bound.
"""

import random
import wave

import numpy as np
import pytest
import torch

from demucs_tpu import presets as jpresets
from demucs_tpu.api import Separator as JaxSeparator
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.separate import get_parser as jax_parser
from demucs_tpu.zoo.native import save_model as jax_save_model
from demucs_tpu_torch import presets, separate
from demucs_tpu_torch.api import LoadModelError, Separator, _apply_precision
from demucs_tpu_torch.audio import read_wav

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SOURCES = ("drums", "bass", "other", "vocals")
SR = 8000
WIRES = (None, "auto", "float32", "float16", "int16", "int8")


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    root = tmp_path_factory.mktemp("repo")
    cfg = jht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                             t_heads=2, segment=0.5, samplerate=SR, use_train_segment=False)
    jax_save_model(JaxModel("htdemucs", cfg, jht.init_htdemucs(cfg, seed=5)), root / "tiny.dmx")
    return root


@pytest.mark.parametrize("preset", ["default", None, "fast", "balanced", "quality"])
@pytest.mark.parametrize("wire", WIRES)
def test_resolve_preset_equals_jax(preset, wire):
    got = presets.resolve_preset(preset, wire)
    want = jpresets.resolve_preset(preset, wire)
    assert got[:3] == want[:3]
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert f"preset {preset}:" in got[3] and f"stems wire: {got[2]}" in got[3]
        assert ("explicit --wire override" in got[3]) == (wire not in (None, "auto"))
        assert "dB" not in got[3] and "MXU" not in got[3]  # no TPU figures
    assert presets.resolve_fast_preset(preset, wire) == (got[0], got[2], got[3])


def test_preset_table_equals_jax():
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    for name, entry in presets.PRESETS.items():
        assert entry[:3] == jpresets.PRESETS[name][:3]
    with pytest.raises(ValueError, match="unknown preset"):
        presets.resolve_preset("turbo", None)
    with pytest.raises(ValueError, match="unknown preset"):
        jpresets.resolve_preset("turbo", None)


@pytest.mark.parametrize("flag,values", [
    ("verbose", ["-v"]), ("clip_mode", ["--clip-mode", "clamp"]), ("jobs", ["-j", "3"]),
    ("preset", ["--preset", "balanced"]), ("shift_offsets", ["--shift-offsets", "5,9"])])
def test_new_flags_parse_as_jax(flag, values):
    """Defaults and parsed values of this slice's flags equal JAX's parser's."""
    port, jax = separate.get_parser(), jax_parser()
    assert getattr(port.parse_args(["t.wav"]), flag) == getattr(jax.parse_args(["t.wav"]), flag)
    assert (getattr(port.parse_args(["t.wav", *values]), flag)
            == getattr(jax.parse_args(["t.wav", *values]), flag))
    for action in ("clip_mode", "preset"):
        port_choices = next(a.choices for a in port._actions if a.dest == action)
        assert port_choices == next(a.choices for a in jax._actions if a.dest == action)


@pytest.mark.parametrize("argv,want", [
    ([], dict(compute_dtype=None, matmul_precision=None, transfer_dtype="int16",
              shift_offsets=None, jobs=0, progress=False)),
    (["--preset", "fast"], dict(compute_dtype="bfloat16", matmul_precision=None,
                                transfer_dtype="int8")),
    (["--preset", "balanced", "--float32"], dict(matmul_precision="tensorfloat32",
                                                 transfer_dtype="float16")),
    (["--preset", "quality"], dict(matmul_precision="highest", transfer_dtype=None)),
    (["--preset", "fast", "--wire", "float16"], dict(compute_dtype="bfloat16",
                                                     transfer_dtype="float16")),
    (["--shift-offsets", "2500,8000", "-j", "2", "-v"], dict(shift_offsets=(2500, 8000),
                                                             jobs=2, progress=True)),
])
def test_cli_flags_reach_separator(monkeypatch, capsys, argv, want):
    seen = {}

    class Recorder:
        def __init__(self, **kwargs):
            seen.update(kwargs)
            raise LoadModelError("recorded")

    monkeypatch.setattr(separate, "Separator", Recorder)
    with pytest.raises(SystemExit):
        separate.main(["t.wav", "-n", "tiny", "-d", "cpu", *argv])
    assert {k: seen[k] for k in want} == want
    out = capsys.readouterr().out
    assert ("preset " in out) == ("--preset" in argv and "default" not in argv)


def _write_pcm16(path, wav):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(wav, -1, 1) * (2**15 - 1)).astype("<i2").T.tobytes())


@pytest.mark.parametrize("mode", ["rescale", "clamp", "none"])
def test_cli_clip_mode_reaches_the_stems(repo, tmp_path, monkeypatch, mode):
    track = tmp_path / "song.wav"
    _write_pcm16(track, (np.random.default_rng(1).standard_normal((2, 5000)) * 0.3))
    clips = []
    real = separate.save_audio

    def recorded(wav, path, **kwargs):
        clips.append(kwargs["clip"])
        return real(wav * 40.0, path, **kwargs)  # loud enough to clip

    monkeypatch.setattr(separate, "save_audio", recorded)
    separate.main([str(track), "--repo", str(repo), "-n", "tiny", "-o", str(tmp_path / "out"),
                   "-d", "cpu", "--shifts", "0", "--clip-mode", mode, "--float32"])
    assert clips == [mode] * 4
    peak = max(np.abs(read_wav(tmp_path / "out" / "tiny" / "song" / f"{s}.wav")[0]).max()
               for s in SOURCES)
    assert (peak <= 1.0) == (mode != "none")


def test_separator_shift_offsets_and_prewarm_match_jax(repo):
    wav = (np.random.default_rng(2).standard_normal((2, 9000)) * 0.2).astype(np.float32)
    offsets = (1200, 300)
    sep = Separator("tiny", repo=repo, device="cpu", shifts=2, batch_size=2,
                    shift_offsets=offsets)
    jsep = JaxSeparator("tiny", repo=repo, device="cpu", engine="host", shifts=2,
                        batch_size=2, shift_offsets=offsets)
    random.seed(1)  # unused: the offsets are pinned
    _, first = sep.separate_tensor(wav, SR)
    random.seed(2)
    _, again = sep.separate_tensor(wav, SR)
    _, want = jsep.separate_tensor(wav, SR)
    peak = max(np.abs(v).max() for v in want.values())
    for name in SOURCES:
        assert np.array_equal(first[name], again[name])
        assert np.abs(first[name] - want[name]).max() < 1e-5 * peak
    report = sep.prewarm([0.8, 0.4])
    jreport = jsep.prewarm([0.8, 0.4])
    assert ([{k: v for k, v in e.items() if k != "warm_time_s"} for e in report]
            == [{k: v for k, v in e.items() if k != "warm_time_s"} for e in jreport])
    sep.update_parameter(shift_offsets=None)
    assert sep._shift_offsets is None


def test_separator_precision_keywords(repo):
    """compute_dtype and matmul_precision re-configure the loaded model, as
    JAX's Separator does; the CPU computes the matmul strings in fp32."""
    wav = (np.random.default_rng(3).standard_normal((2, 6000)) * 0.2).astype(np.float32)
    base = Separator("tiny", repo=repo, device="cpu", shifts=0, batch_size=2)
    fast = Separator("tiny", repo=repo, device="cpu", shifts=0, batch_size=2,
                     compute_dtype="bfloat16")
    quality = Separator("tiny", repo=repo, device="cpu", shifts=0, batch_size=2,
                        matmul_precision="highest")
    assert fast.model.cfg.compute_dtype == "bfloat16"
    assert {p.dtype for p in fast.model.module.encoder.parameters()} == {torch.bfloat16}
    assert quality.model.cfg.matmul_precision == "highest"
    _, want = base.separate_tensor(wav, SR)
    _, exact = quality.separate_tensor(wav, SR)
    _, bf16 = fast.separate_tensor(wav, SR)
    for name in SOURCES:
        assert np.array_equal(exact[name], want[name])
        ser = 10 * np.log10(np.sum(want[name] ** 2) / np.sum((want[name] - bf16[name]) ** 2))
        assert ser > 20


def test_apply_precision_warns_where_a_family_lacks_the_knob():
    from demucs_tpu_torch.models import demucs as td
    from demucs_tpu_torch.models.registry import BagOfModels, Model

    cfg = td.DemucsConfig(sources=SOURCES, channels=8, depth=4, samplerate=SR, segment=0.5)
    member = Model("demucs", cfg, td.Demucs(cfg).eval())
    bag = BagOfModels([member, member])
    with pytest.warns(UserWarning, match="only HTDemucs has the bf16-storage knob"):
        out = _apply_precision(bag, "bfloat16", "tensorfloat32")
    assert [m.cfg.matmul_precision for m in out.models] == ["tensorfloat32"] * 2
    assert member.cfg.matmul_precision is None  # the loaded model is left as it was
    assert _apply_precision(member, None, None) is member


def test_bf16_policy_model_saves_and_loads(tmp_path):
    """A model re-configured to bf16 stages saves as a .dmx (its bf16
    parameters widened to fp32 exactly) and loads back to the same policy and
    the same weights."""
    from demucs_tpu_torch.models import htdemucs as tht
    from demucs_tpu_torch.models.registry import Model, reconfigured
    from demucs_tpu_torch.zoo import native

    cfg = tht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                             t_heads=2, segment=0.5, samplerate=SR)
    fast = reconfigured(Model("htdemucs", cfg, tht.init_htdemucs(cfg, 3).eval()),
                        compute_dtype="bfloat16")
    path = native.save_model(fast, tmp_path / "fast.dmx", half=False)
    again = native.load_native_model(path, device="cpu")
    assert again.cfg.compute_dtype == "bfloat16"
    for name, p in fast.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[name], p), name
