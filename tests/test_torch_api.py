"""Port's Separator and CLI against the JAX package's Separator(engine="host"),
on a .dmx written by demucs_tpu.zoo.native.save_model, on the CPU.

Tolerance: 1e-5 x peak for the separated stems (the forward's fp32
deviation through the host engine); the CLI's 16-bit WAV stems are compared
with the Separator's output at the PCM16 step (2 / 2**15).
"""

import dataclasses
import random
import wave

import numpy as np
import pytest
import torch

from demucs_tpu.api import Separator as JaxSeparator
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.zoo.native import save_model as jax_save_model
from demucs_tpu_torch.api import LoadAudioError, LoadModelError, Separator
from demucs_tpu_torch.audio import read_wav
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.separate import main
from demucs_tpu_torch.zoo import native, pretrained

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SOURCES = ("drums", "bass", "other", "vocals")
SR = 8000


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    root = tmp_path_factory.mktemp("repo")
    cfg = jht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                             t_heads=2, segment=0.5, samplerate=SR)
    jax_save_model(JaxModel("htdemucs", cfg, jht.init_htdemucs(cfg, seed=5)),
                   root / "tiny.dmx")
    return root


def _wav(seconds=1.2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, int(seconds * SR))) * 0.2).astype(np.float32)


def test_separator_matches_jax(repo):
    wav = _wav()
    jsep = JaxSeparator("tiny", repo=repo, device="cpu", engine="host", shifts=1,
                        batch_size=2)
    sep = Separator("tiny", repo=repo, device="cpu", shifts=1, batch_size=2)
    random.seed(1234)  # both draw their shift from the module-level random
    jorig, jstems = jsep.separate_tensor(wav, SR)
    random.seed(1234)
    orig, stems = sep.separate_tensor(wav, SR)
    np.testing.assert_allclose(orig, jorig, atol=1e-6)
    assert list(stems) == list(jstems) == list(SOURCES)
    peak = max(np.abs(v).max() for v in jstems.values())
    for name in SOURCES:
        assert stems[name].shape == wav.shape
        assert np.abs(stems[name] - jstems[name]).max() < 1e-5 * peak


def _write_pcm16(path, wav):
    pcm = (np.clip(wav, -1, 1) * (2**15 - 1)).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.T.tobytes())


def test_cli_writes_four_stems(repo, tmp_path):
    track = tmp_path / "song.wav"
    _write_pcm16(track, _wav(seed=1))
    out = tmp_path / "out"
    random.seed(7)
    main([str(track), "--repo", str(repo), "-n", "tiny", "-o", str(out), "-d", "cpu",
          "--batch-size", "2"])
    random.seed(7)
    _, want = Separator("tiny", repo=repo, device="cpu", batch_size=2).separate_audio_file(
        track)
    for name in SOURCES:
        got, sr = read_wav(out / "tiny" / "song" / f"{name}.wav")
        assert sr == SR and got.shape == want[name].shape
        ref = want[name] / max(1.01 * np.abs(want[name]).max(), 1)  # rescale clip mode
        assert np.abs(got - ref).max() <= 2.0 / 2**15


def test_cli_two_stems(repo, tmp_path):
    track = tmp_path / "song.wav"
    _write_pcm16(track, _wav(0.6, seed=2))
    main([str(track), "--repo", str(repo), "-n", "tiny", "-o", str(tmp_path), "-d", "cpu",
          "--two-stems", "vocals", "--float32", "--shifts", "0"])
    written = sorted(p.name for p in (tmp_path / "tiny" / "song").iterdir())
    assert written == ["no_vocals.wav", "vocals.wav"]


def test_port_dmx_roundtrip_and_loading_errors(repo, tmp_path, monkeypatch):
    model = pretrained.get_model("tiny", repo, device="cpu")
    assert isinstance(model, Model) and model.kind == "htdemucs"
    path = native.save_model(model, tmp_path / "copy.dmx", half=False)
    again = native.load_native_model(path, device="cpu")
    assert dataclasses.asdict(again.cfg) == dataclasses.asdict(model.cfg)
    for k, v in model.module.state_dict().items():
        assert np.array_equal(again.module.state_dict()[k].numpy(), v.numpy())
    with pytest.raises(LoadModelError):
        Separator("missing", repo=repo, device="cpu")
    # the card is the default: without one, asking for it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Separator("tiny", repo=repo)


def test_separator_engine_keywords(repo):
    """engine="device" runs the device engine on the CPU too; its keywords go
    through, and update_parameter changes them."""
    wav = _wav(seed=3)
    sep = Separator("tiny", repo=repo, device="cpu", shifts=0, batch_size=2)
    _, host = sep.separate_tensor(wav, SR)  # "auto" on the CPU: the host engine
    sep.update_parameter(engine="device")
    _, dev = sep.separate_tensor(wav, SR)
    peak = max(np.abs(v).max() for v in host.values())
    for name in SOURCES:
        assert np.abs(dev[name] - host[name]).max() < 1e-5 * peak
    sep.update_parameter(transfer_dtype="int16", tail_mode="uniform")
    _, wire = sep.separate_tensor(wav, SR)
    for name in SOURCES:  # the int16 wire rounds to half a step of each channel's peak
        step = np.abs(dev[name]).max(axis=-1, keepdims=True) / 32766.0
        assert (np.abs(wire[name] - dev[name]) <= 0.5 * step + 1e-5 * peak).all()
    sep.update_parameter(length_bucket_seconds=0.5)  # 1.2 s padded to 1.5 s, cropped back
    _, bucketed = sep.separate_tensor(wav, SR)
    assert all(bucketed[name].shape == wav.shape for name in SOURCES)
    with pytest.raises(ValueError, match="tail_mode"):
        Separator("tiny", repo=repo, device="cpu", engine="device",
                  tail_mode="ragged").separate_tensor(wav, SR)


def test_separate_audio_files_matches_single_files(repo, tmp_path):
    paths = []
    for i, seconds in enumerate((1.2, 0.7)):
        paths.append(tmp_path / f"t{i}.wav")
        _write_pcm16(paths[-1], _wav(seconds, seed=20 + i))
    for engine in ("host", "device"):
        sep = Separator("tiny", repo=repo, device="cpu", shifts=1, batch_size=2,
                        engine=engine)
        random.seed(5)
        got = list(sep.separate_audio_files(paths))
        random.seed(5)
        for (file, origin, stems), path in zip(got, paths):
            want_origin, want = sep.separate_audio_file(path)
            assert file == path and np.array_equal(origin, want_origin)
            assert all(np.array_equal(stems[k], want[k]) for k in SOURCES)
        assert len(got) == 2
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file")
    done = []
    with pytest.raises(LoadAudioError):
        for file, _, _ in sep.separate_audio_files([paths[0], bad, paths[1]]):
            done.append(file)
    assert done == [paths[0]]  # what was queued before the bad file comes out first
    sep.update_parameter(callback=print)
    with pytest.raises(ValueError, match="callback"):
        list(sep.separate_audio_files(paths))


@pytest.mark.parametrize("flags,wire", [
    (["--engine", "device", "--wire", "float32"], None),
    (["--engine", "device"], "int16"),  # auto: int16 for 16-bit PCM output
    (["--engine", "device", "--float32", "--tail-mode", "uniform", "--length-bucket",
      "0.5"], "float16")])  # auto: float16 otherwise
def test_cli_engine_flags(repo, tmp_path, flags, wire):
    track = tmp_path / "song.wav"
    _write_pcm16(track, _wav(seed=4))
    main([str(track), "--repo", str(repo), "-n", "tiny", "-o", str(tmp_path / "out"),
          "-d", "cpu", "--shifts", "0", "--batch-size", "2", *flags])
    extra = (dict(length_bucket_seconds=0.5, tail_mode="uniform")
             if "--length-bucket" in flags else {})
    _, want = Separator("tiny", repo=repo, device="cpu", shifts=0, batch_size=2,
                        engine="device", transfer_dtype=wire, **extra).separate_audio_file(track)
    for name in SOURCES:
        got, _ = read_wav(tmp_path / "out" / "tiny" / "song" / f"{name}.wav")
        ref = want[name] / max(1.01 * np.abs(want[name]).max(), 1)  # rescale clip mode
        step = 1e-6 if "--float32" in flags else 2.0 / 2**15
        assert np.abs(got - ref).max() <= step
