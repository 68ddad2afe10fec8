"""The port's HTTP server (demucs_tpu_torch/serve.py) on the CPU: the JAX
package's tests/test_serve.py cases, held against the port's Separator and
the JAX package's SeparationService on a tiny HTDemucs (.dmx written by the
JAX package), with mixtures made from a seed with numpy.

Tolerances: a float32 WAV response equals ``Separator.separate_tensor`` on
the decoded body bit for bit (the same engine and forwards); against the
JAX service, 1e-5 x peak (the forward's fp32 deviation between the
packages, as in test_torch_api.py). Codec responses are checked for their
files and shapes.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

from demucs_tpu import audio as jaudio
from demucs_tpu import serve as jserve
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.models.registry import Model as JaxModel
from demucs_tpu.zoo.native import save_model as jax_save_model
from demucs_tpu_torch import audio, avio, mp3io, serve
from demucs_tpu_torch.api import Separator

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

SOURCES = ("drums", "bass", "other", "vocals")
SR = 8000


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    root = tmp_path_factory.mktemp("repo")
    cfg = jht.HTDemucsConfig(sources=SOURCES, channels=8, depth=4, nfft=2048, t_layers=2,
                             t_heads=2, segment=0.5, samplerate=SR)
    jax_save_model(JaxModel("htdemucs", cfg, jht.init_htdemucs(cfg, seed=5)), root / "tiny.dmx")
    return root


@pytest.fixture(scope="module")
def service(repo):
    return serve.SeparationService(model="tiny", repo=repo, device="cpu", shifts=0,
                                   batch_size=2)


def _mix(seconds, seed):
    return (np.random.default_rng(seed).standard_normal((2, int(seconds * SR))) * 0.05
            ).astype(np.float32)


def _wav_bytes(wav, tmp_path, name="in.wav"):
    path = tmp_path / name
    audio.save_audio(wav, path, SR, bits_per_sample=32, as_float=True, clip="none")
    return path.read_bytes()


def _unzip(blob, tmp_path):
    """{entry name: (decoded samples, samplerate)} of a response."""
    out = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for name in zf.namelist():
            path = tmp_path / f"out_{name}"
            path.write_bytes(zf.read(name))
            out[name] = audio.read_audio(path)
    return out


def test_service_matches_separator_and_jax(service, repo, tmp_path):
    wav = _mix(1.3, seed=11)
    payload = _wav_bytes(wav, tmp_path)
    got = _unzip(service.separate_bytes(payload, float32=True, clip="none"), tmp_path)
    decoded, _ = audio.read_audio(tmp_path / "in.wav", samplerate=SR, channels=2)
    _, want = service.separator.separate_tensor(decoded)
    assert sorted(got) == sorted(f"{s}.wav" for s in SOURCES)
    for source in SOURCES:
        np.testing.assert_array_equal(got[f"{source}.wav"][0], want[source])
    assert set(service.last_timing) == {"decode_s", "separate_s", "encode_s"}

    jservice = jserve.SeparationService(model="tiny", repo=repo, shifts=0, engine="host",
                                        batch_size=2)
    ref = _unzip(jservice.separate_bytes(payload, float32=True, clip="none"), tmp_path)
    peak = max(np.abs(v[0]).max() for v in ref.values())
    for name, (stem, _) in ref.items():
        assert np.abs(got[name][0] - stem).max() < 1e-5 * peak


def test_per_request_overrides_do_not_leak(service, tmp_path):
    sep = service.separator
    payload = _wav_bytes(_mix(1.1, seed=13), tmp_path)

    def stems(blob):  # the payloads, not the zip bytes (entries carry mtimes)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            return {n: zf.read(n) for n in sorted(zf.namelist())}

    before = stems(service.separate_bytes(payload, float32=True, clip="none"))
    settings = (sep._shifts, sep._overlap)
    service.separate_bytes(payload, shifts=1, overlap=0.5, float32=True, clip="none")
    assert (sep._shifts, sep._overlap) == settings
    assert stems(service.separate_bytes(payload, float32=True, clip="none")) == before


def test_two_stems_and_validation(service, tmp_path):
    payload = _wav_bytes(_mix(1.0, seed=12), tmp_path)
    blob = service.separate_bytes(payload, stem="vocals", float32=True, clip="none")
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert sorted(zf.namelist()) == ["no_vocals.wav", "vocals.wav"]
    with pytest.raises(ValueError, match="unknown stem"):
        service.separate_bytes(payload, stem="karaoke")
    with pytest.raises(ValueError, match="unknown format"):
        service.separate_bytes(payload, fmt="ogg")
    with pytest.raises(ValueError, match="mp3_preset"):
        service.separate_bytes(payload, fmt="mp3", mp3_preset=9)


def test_http_round_trip(service, tmp_path):
    server = serve.make_server(service, "127.0.0.1", 0)  # port 0: a free one
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(query, data):
        return urllib.request.urlopen(urllib.request.Request(
            f"{base}/separate{query}", data=data, method="POST"), timeout=60)

    def status(query, data):
        with pytest.raises(urllib.error.HTTPError) as err:
            post(query, data)
        return err.value.code

    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
        assert health == {"status": "ok", "model": "tiny", "samplerate": SR,
                          "sources": list(SOURCES)}
        models = json.loads(urllib.request.urlopen(f"{base}/models", timeout=60).read())
        assert "htdemucs" in models["models"]
        payload = _wav_bytes(_mix(1.0, seed=13), tmp_path)
        resp = post("?shifts=0&float32=1&clip=none", payload)
        assert resp.headers["Content-Type"] == "application/zip"
        with zipfile.ZipFile(io.BytesIO(resp.read())) as zf:
            assert len(zf.namelist()) == 4
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=60)
        assert err.value.code == 404
        assert status("", b"") == 400  # empty body
        assert status("?stem=karaoke", payload) == 400
        # a WAV and a FLAC body cut short: error statuses, and the server goes
        # on answering
        assert status("", payload[:40]) >= 400
        flac = tmp_path / "in.flac"
        audio.save_audio(_mix(1.0, seed=14), flac, SR)
        assert status("", flac.read_bytes()[:200]) >= 400
        assert post("?float32=1", payload).status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_output_formats(service, tmp_path):
    payload = _wav_bytes(_mix(1.0, seed=21), tmp_path)
    formats = ["flac"] + (["mp3"] if mp3io.lame_available() and mp3io.mpg123_available()
                          else [])
    for fmt in formats:
        got = _unzip(service.separate_bytes(payload, clip="none", fmt=fmt, bitrate=64,
                                            mp3_preset=7, int24=True), tmp_path)
        assert sorted(got) == sorted(f"{s}.{fmt}" for s in SOURCES)
        for stem, sr in got.values():
            assert sr == SR and stem.shape == (2, SR)


def test_compressed_bodies(service, tmp_path):
    wav = _mix(1.0, seed=23)
    bodies = {}
    flac = tmp_path / "in.flac"
    audio.save_audio(wav, flac, SR, clip="none")
    bodies["flac"] = flac.read_bytes()
    if mp3io.lame_available() and mp3io.mpg123_available():
        bodies["mp3"] = mp3io.encode_mp3(wav, SR, 64)
    for kind, body in bodies.items():
        assert serve.sniff_suffix(body) == f".{kind}"
        got = _unzip(service.separate_bytes(body, clip="none"), tmp_path)
        assert sorted(got) == sorted(f"{s}.wav" for s in SOURCES), kind


def test_adts_body_is_not_taken_for_mp3(service, repo, tmp_path, monkeypatch):
    """ADTS AAC starts with the MPEG frame sync (FF F1) and layer bits 00. The
    JAX sniff routes it to libmpg123, which fails; the port's goes to the
    libavcodec shim, which reads it."""
    if not avio.available():
        pytest.skip("the libavcodec shim cannot be built here")
    monkeypatch.setattr(audio, "ffmpeg_available", lambda: False)
    path = tmp_path / "in.aac"
    avio.encode(path, _mix(1.0, seed=24), SR, "aac", 64000)
    body = path.read_bytes()
    assert body[0] == 0xFF and body[1] & 0xF6 == 0xF0  # ADTS: sync, layer 00
    assert serve.sniff_suffix(body) == ".audio"
    got = _unzip(service.separate_bytes(body, clip="none"), tmp_path)
    assert sorted(got) == sorted(f"{s}.wav" for s in SOURCES)
    if mp3io.mpg123_available():
        jservice = jserve.SeparationService(model="tiny", repo=repo, shifts=0, engine="host")
        monkeypatch.setattr(jaudio, "ffmpeg_available", lambda: False)
        with pytest.raises(RuntimeError, match="mpg123"):
            jservice.separate_bytes(body, clip="none")


def test_fast_preset(repo):
    svc = serve.SeparationService(model="tiny", repo=repo, device="cpu", shifts=0,
                                  compute_dtype="bfloat16")
    assert svc.separator.model.cfg.compute_dtype == "bfloat16"


def test_main_prewarm_flags(repo, monkeypatch):
    """``--shift-offsets ... --prewarm ...`` with ``-d cpu`` pins the offsets on
    the Separator and prewarms each duration before the server binds."""
    calls = {}

    class FakeServer:
        def serve_forever(self):
            calls["served"] = True
            raise KeyboardInterrupt  # unwind main() after "binding"

    def fake_make_server(service, host, port):
        calls["service"] = service
        return FakeServer()

    def spy_prewarm(self, durations, verbose=False):
        calls["durations"] = list(durations)
        calls["offsets"] = self._shift_offsets
        return [{"tails_warmed": True} for _ in durations]

    monkeypatch.setattr(serve, "make_server", fake_make_server)
    monkeypatch.setattr(Separator, "prewarm", spy_prewarm)
    with pytest.raises(KeyboardInterrupt):
        serve.main(["-n", "tiny", "--repo", str(repo), "-d", "cpu", "--shifts", "1",
                    "--shift-offsets", "120,360", "--prewarm", "0.8,1.6"])
    assert calls["durations"] == [0.8, 1.6]
    assert calls["offsets"] == (120, 360)
    sep = calls["service"].separator
    assert sep._shift_offsets == (120, 360) and sep.model.device.type == "cpu"
    assert calls["served"] is True
