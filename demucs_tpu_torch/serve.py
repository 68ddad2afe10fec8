"""HTTP separation server (port of ``demucs_tpu/serve.py``), standard library only.

The model loads once at start-up and every request runs through the same
engine as the CLI: on the card the device-resident engine, whose full
windows replay CUDA graphs captured on the first request of each shape (or
before traffic, with ``--prewarm``).

    python -m demucs_tpu_torch.serve -n htdemucs --port 8355 [-d cuda|cpu]
    curl -s -X POST --data-binary @track.mp3 \\
        "http://127.0.0.1:8355/separate?shifts=0&float32=1" -o stems.zip

Endpoints:
    GET  /healthz   -> {"status": "ok", model, samplerate, sources}
    GET  /models    -> {"models": [...]}, the listing of ``api.list_models``
    POST /separate  -> a zip of one audio file per stem. Body: an audio file
                       (WAV, FLAC and mp3 by their magic bytes; anything else
                       through the libavcodec shim or ffmpeg). Query: shifts,
                       overlap, stem (two-stems mode), float32=1, int24=1,
                       clip=rescale|clamp|tanh|none, format=wav|flac|mp3 (the
                       CLI's --flac/--mp3), bitrate=320, mp3_preset=2..7.

Requests run one at a time on the device (a lock); a request's ``shifts``
and ``overlap`` apply to it alone. Run one server process per card.
"""

from __future__ import annotations

import argparse
import io
import json
import tempfile
import threading
import time
import typing as tp
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from demucs_tpu_torch import mp3io
from demucs_tpu_torch.api import Separator, list_models
from demucs_tpu_torch.audio import ffmpeg_available, read_audio, save_audio
from demucs_tpu_torch.presets import resolve_preset

__all__ = ["SeparationService", "make_server", "main", "sniff_suffix"]


def sniff_suffix(payload: bytes) -> str:
    """The suffix ``read_audio`` routes a request body by, from its magic bytes:
    RIFF -> .wav, fLaC -> .flac, an ID3 tag or an MPEG audio frame sync with a
    layer (layer bits not 00) -> .mp3, else .audio (the libavcodec shim or
    ffmpeg, which read the content). ADTS AAC shares the frame sync but has
    layer bits 00, so it is not taken for mp3."""
    if payload[:4] == b"RIFF":
        return ".wav"
    if payload[:4] == b"fLaC":
        return ".flac"
    if payload[:3] == b"ID3" or (len(payload) > 1 and payload[0] == 0xFF
                                 and (payload[1] & 0xE0) == 0xE0
                                 and (payload[1] & 0x06) != 0):
        return ".mp3"
    return ".audio"


class SeparationService:
    """Owns one Separator and serializes access to its device."""

    def __init__(self, model: str = "htdemucs", repo: tp.Optional[Path] = None,
                 **separator_kwargs):
        self.separator = Separator(model=model, repo=repo, progress=False, **separator_kwargs)
        self.model_name = model
        self._lock = threading.Lock()
        # seconds of the last request: body decode, separation, encode and zip
        self.last_timing: tp.Dict[str, float] = {}

    def info(self) -> dict:
        sep = self.separator
        return {"status": "ok", "model": self.model_name, "samplerate": sep.samplerate,
                "sources": list(sep.model.sources)}

    def separate_bytes(self, payload: bytes, *, shifts: tp.Optional[int] = None,
                       overlap: tp.Optional[float] = None, stem: tp.Optional[str] = None,
                       float32: bool = False, int24: bool = False, clip: str = "rescale",
                       fmt: str = "wav", bitrate: int = 320, mp3_preset: int = 2) -> bytes:
        """Audio file bytes -> a zip of stem files (two stems with ``stem``).

        ``fmt`` is the CLI's output format: wav (default), flac, or mp3 at
        ``bitrate`` kb/s with the LAME quality ``mp3_preset`` (2 best .. 7
        fastest). A bad argument raises ``ValueError``."""
        sep = self.separator
        if stem is not None and stem not in sep.model.sources:
            raise ValueError(f"unknown stem {stem!r}; available: {list(sep.model.sources)}")
        if fmt not in ("wav", "flac", "mp3"):
            raise ValueError(f"unknown format {fmt!r}; use wav/flac/mp3")
        if fmt == "mp3":
            if not (mp3io.lame_available() or ffmpeg_available()):
                raise ValueError("mp3 output needs libmp3lame or ffmpeg on the server")
            if not 2 <= mp3_preset <= 7:
                raise ValueError(f"mp3_preset must be 2..7, got {mp3_preset}")
        timing = {}
        with tempfile.TemporaryDirectory() as td:
            start = time.perf_counter()
            src = Path(td) / f"input{sniff_suffix(payload)}"
            src.write_bytes(payload)
            wav, _sr = read_audio(src, samplerate=sep.samplerate,
                                  channels=sep.model.audio_channels)
            timing["decode_s"] = time.perf_counter() - start
            with self._lock:
                # a request's overrides apply to it alone: the server's own
                # values are restored afterwards
                overrides = {k: v for k, v in (("shifts", shifts), ("overlap", overlap))
                             if v is not None}
                restore = {k: getattr(sep, f"_{k}") for k in overrides}
                start = time.perf_counter()
                try:
                    if overrides:
                        sep.update_parameter(**overrides)
                    _origin, stems = sep.separate_tensor(wav)
                finally:
                    if restore:
                        sep.update_parameter(**restore)
                timing["separate_s"] = time.perf_counter() - start

            start = time.perf_counter()
            if stem is not None:
                # two-stems mode (separate.py:194-202): the complement is the
                # sum of every other source
                rest = sum(v for k, v in stems.items() if k != stem)
                stems = {stem: stems[stem], f"no_{stem}": rest}
            # wav: float32 means IEEE float; flac and mp3 follow the CLI
            # (24 bits with int24, else 16)
            bits = (32 if float32 else 24 if int24 else 16) if fmt == "wav" else (
                24 if int24 else 16)
            kwargs = dict(clip=clip, bits_per_sample=bits, as_float=float32 and fmt == "wav",
                          bitrate=bitrate, preset=mp3_preset)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                for name, audio in stems.items():
                    dest = Path(td) / f"{name}.{fmt}"
                    save_audio(np.asarray(audio), dest, sep.samplerate, **kwargs)
                    zf.write(dest, f"{name}.{fmt}")
            timing["encode_s"] = time.perf_counter() - start
        self.last_timing = timing
        return buf.getvalue()


def make_server(service: SeparationService, host: str = "127.0.0.1",
                port: int = 8355) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                return self._json(200, service.info())
            if path == "/models":
                listing = list_models()
                return self._json(200, {"models": sorted(set(listing["single"])
                                                         | set(listing["bag"]))})
            return self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/separate":
                return self._json(404, {"error": f"unknown path {url.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return self._json(400, {"error": "bad Content-Length"})
            if length <= 0:
                return self._json(400, {"error": "empty body"})
            payload = self.rfile.read(length)
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                blob = service.separate_bytes(
                    payload,
                    shifts=int(q["shifts"]) if "shifts" in q else None,
                    overlap=float(q["overlap"]) if "overlap" in q else None,
                    stem=q.get("stem"),
                    float32=q.get("float32") in ("1", "true"),
                    int24=q.get("int24") in ("1", "true"),
                    clip=q.get("clip", "rescale"),
                    fmt=q.get("format", "wav"),
                    bitrate=int(q["bitrate"]) if "bitrate" in q else 320,
                    mp3_preset=int(q["mp3_preset"]) if "mp3_preset" in q else 2)
            except ValueError as err:
                return self._json(400, {"error": str(err)})
            except Exception as err:  # noqa: BLE001 — the server outlives a bad body
                return self._json(500, {"error": f"{type(err).__name__}: {err}"})
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    return ThreadingHTTPServer((host, port), Handler)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "demucs_tpu_torch.serve", description="Stem separation server (one process per card)")
    parser.add_argument("-n", "--name", default="htdemucs")
    parser.add_argument("--repo", type=Path, default=None)
    parser.add_argument("-d", "--device", default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8355)
    parser.add_argument("--shifts", type=int, default=1)
    parser.add_argument("--overlap", type=float, default=0.25)
    parser.add_argument("--segment", type=float, default=None)
    parser.add_argument("--engine", default="auto", choices=["auto", "host", "device"])
    parser.add_argument("--wire", default=None,
                        choices=[None, "float32", "float16", "int16", "int8"],
                        help="Format of the stems' copy from the device engine "
                        "(default: float32, bit-exact).")
    parser.add_argument("--preset", default="default",
                        choices=["default", "fast", "balanced", "quality"],
                        help="Precision policy and stems wire (presets.py): fast = bf16 "
                        "storage in HTDemucs's core stages + int8 wire; balanced = TF32 "
                        "tensor cores; quality = full fp32 + the bit-exact wire; an "
                        "explicit --wire wins.")
    parser.add_argument("--warmup-seconds", type=float, default=None,
                        help="Separate a silent track of this length before accepting "
                        "requests (captures its graphs).")
    parser.add_argument("--tail-mode", default="exact", choices=["exact", "uniform"],
                        help="Ragged tail chunks of HDemucs and Demucs v2 (the CLI's "
                        "--tail-mode).")
    parser.add_argument("--shift-offsets", default=None,
                        help="Comma-separated pinned shift offsets (samples), consumed in "
                        "order instead of random draws: a bounded set of tail shapes that "
                        "--prewarm can run.")
    parser.add_argument("--prewarm", default=None,
                        help="Comma-separated track lengths (seconds) to run before "
                        "accepting requests; with --shift-offsets every tail shape too "
                        "(supersedes --warmup-seconds).")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    compute_dtype, matmul_precision, wire, banner = resolve_preset(args.preset, args.wire)
    if banner:
        print(banner, flush=True)
    shift_offsets = (tuple(int(x) for x in args.shift_offsets.split(","))
                     if args.shift_offsets else None)
    service = SeparationService(
        model=args.name, repo=args.repo, device=args.device, shifts=args.shifts,
        overlap=args.overlap, segment=args.segment, engine=args.engine,
        transfer_dtype=None if wire == "float32" else wire, compute_dtype=compute_dtype,
        matmul_precision=matmul_precision, shift_offsets=shift_offsets,
        tail_mode=args.tail_mode)
    sep = service.separator
    if args.prewarm:
        report = sep.prewarm([float(x) for x in args.prewarm.split(",")], verbose=True)
        if not all(r["tails_warmed"] for r in report):
            print("prewarm: WARNING — random shifts on an exact-tail model leave the tail "
                  "shapes cold; pin --shift-offsets, use --tail-mode uniform, or serve "
                  "shifts=0", flush=True)
    elif args.warmup_seconds:
        silent = np.zeros((sep.model.audio_channels, int(args.warmup_seconds * sep.samplerate)),
                          np.float32)
        sep.separate_tensor(silent)
        print(f"warmup done ({args.warmup_seconds:.0f}s track)", flush=True)
    server = make_server(service, args.host, args.port)
    print(f"serving {args.name} on http://{args.host}:{args.port} "
          f"(sources: {', '.join(sep.model.sources)})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
