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
from demucs_tpu_torch.api import LoadModelError, Separator
from demucs_tpu_torch.audio import read_wav
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.separate import main
from demucs_tpu_torch.zoo import native

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
    model = native.get_model("tiny", repo, device="cpu")
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
