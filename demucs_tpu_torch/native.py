"""Host C++ libraries of the port, built with g++ at first use and bound with ctypes.

:func:`load` compiles ``csrc/<name>.cpp`` into ``build/cpp/`` at the root
of the checkout (ignored by git), named by a hash of the source and the
flags, so an edited source never loads a stale library; the library is
written to a temporary file and renamed into place, so processes that build
at once (test workers) never load a partial file. A failed build raises
with g++'s output; nothing falls back.

``csrc/codec.cpp`` holds the FLAC codec's sequential loops (the counterpart
of the FLAC part of ``native/wavio.cpp``): :func:`crc8`, :func:`crc16`,
:func:`rice_decode` and :func:`lpc_restore`. Each has a pure-Python twin
(``*_plain``), which only the tests use. ``csrc/avio.cpp`` (the libavcodec
shim) is loaded by ``avio.py`` through :func:`load` with its link flags.

``csrc/wavio.cpp`` is the training loader's WAV reader (the window and
prefetch parts of the JAX package's ``wavio.cpp``): :func:`wav_info`,
:func:`read_wav_window` (a frame window decoded and channel-converted in
C++, without the interpreter's lock; its plain twin is ``audio.read_wav``
with ``audio.convert_audio_channels``) and :class:`NativePrefetcher`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["load", "crc8", "crc16", "rice_decode", "lpc_restore", "crc8_plain",
           "crc16_plain", "rice_decode_plain", "lpc_restore_plain", "wav_info",
           "read_wav_window", "NativePrefetcher"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOADED: tp.Dict[str, ctypes.CDLL] = {}


def library_path(name: str, link: tp.Sequence[str] = ()) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join((*CXX_FLAGS, *link)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, link: tp.Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cpp`` unless it is built; return the library's path."""
    path = library_path(name, link)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(CSRC / f"{name}.cpp"), *link, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not run for {name}.cpp: {err}") from err
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cpp (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: readers never see a partial file
    return path


def load(name: str, link: tp.Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, link)))
        _LOADED[name] = lib
    return lib


@functools.cache
def _codec() -> ctypes.CDLL:
    lib = load("codec")
    lib.flac_crc8.restype = ctypes.c_uint32
    lib.flac_crc8.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.flac_crc16.restype = ctypes.c_uint32
    lib.flac_crc16.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.flac_rice_decode.restype = ctypes.c_int64
    lib.flac_rice_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.flac_lpc_restore.restype = None
    lib.flac_lpc_restore.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64]
    return lib


@functools.cache
def _wavio() -> ctypes.CDLL:
    lib = load("wavio", ("-pthread",))
    lib.wavio_info.restype = ctypes.c_int64
    lib.wavio_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.wavio_read.restype = ctypes.c_int64
    lib.wavio_read.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_float)]
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
    lib.prefetch_add_job.restype = None
    lib.prefetch_add_job.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                                     ctypes.c_double]
    lib.prefetch_start.restype = None
    lib.prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.prefetch_get.restype = ctypes.c_int64
    lib.prefetch_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.prefetch_destroy.restype = None
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    return lib


_WAV_ERRORS = {-1: "cannot open", -2: "not a RIFF/WAVE file with fmt and data chunks",
               -3: "short read", -4: "unsupported sample format",
               -5: "fewer channels than requested and not mono"}


def _wav_error(path, code: int) -> ValueError:
    return ValueError(f"{path}: {_WAV_ERRORS.get(code, f'error {code}')}")


# ---------------------------------------------------------------- the C++ loops

def crc8(data: bytes) -> int:
    """FLAC frame-header CRC-8 (polynomial 0x07, initial 0, MSB first)."""
    return _codec().flac_crc8(data, len(data))


def crc16(data: bytes) -> int:
    """FLAC frame CRC-16 (polynomial 0x8005, initial 0, MSB first)."""
    return _codec().flac_crc16(data, len(data))


def rice_decode(data: bytes, bitpos: int, count: int, k: int) -> tp.Tuple[np.ndarray, int]:
    """``count`` zigzag-decoded Rice residuals of parameter ``k`` from the
    MSB-first bit offset ``bitpos`` of ``data`` -> (int64 residuals, new bit
    offset). Raises ``ValueError`` when the codes run past the data."""
    out = np.empty(count, np.int64)
    newpos = _codec().flac_rice_decode(data, len(data), bitpos, count, k,
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if newpos < 0:
        raise ValueError("rice stream overrun (truncated frame)")
    return out, int(newpos)


def lpc_restore(coefs: np.ndarray, shift: int, x: np.ndarray) -> None:
    """FLAC's integer LPC in place on int64 ``x``: ``x[:order]`` are the warm-up
    samples, ``x[order:]`` the residuals, which become the samples."""
    if x.dtype != np.int64 or not x.flags.c_contiguous:
        raise ValueError("lpc_restore needs a contiguous int64 array")
    c = np.ascontiguousarray(coefs, np.int32)
    _codec().flac_lpc_restore(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(c),
                              shift, x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(x))


def wav_info(path) -> dict:
    """``{"samplerate", "channels", "frames", "bits", "format"}`` of a WAV file."""
    out = (ctypes.c_int64 * 5)()
    code = _wavio().wavio_info(str(path).encode(), out)
    if code != 0:
        raise _wav_error(path, code)
    return {"samplerate": int(out[0]), "channels": int(out[1]), "frames": int(out[2]),
            "bits": int(out[3]), "format": int(out[4])}


def read_wav_window(path, frame_offset: int, num_frames: int, channels: int,
                    out: tp.Optional[np.ndarray] = None) -> np.ndarray:
    """Frames ``[frame_offset, frame_offset + num_frames)`` of a WAV file as
    float32 ``(channels, num_frames)``, converted to ``channels`` as
    ``audio.convert_audio_channels`` does and zero past the end of the file;
    written into ``out`` when it is given (a C-contiguous float32 array of
    that shape: one stem of an example, with no copy after)."""
    if frame_offset < 0 or num_frames < 0 or channels < 1:
        raise ValueError(f"bad window: offset {frame_offset}, frames {num_frames}, "
                         f"channels {channels}")
    if out is None:
        out = np.empty((channels, num_frames), dtype=np.float32)
    elif (out.shape != (channels, num_frames) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 {(channels, num_frames)}, got "
                         f"{out.dtype} {out.shape}")
    code = _wavio().wavio_read(str(path).encode(), frame_offset, num_frames, channels,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if code < 0:
        raise _wav_error(path, code)
    return out


class NativePrefetcher:
    """Examples decoded on C++ threads: each job (one WAV file per stem, a
    frame offset, the track's mean and std) becomes a float32 ``(sources,
    channels, frames)`` example, normalized and zero past the files' end.
    ``add_job`` every job, ``start``, then ``get(i)`` in any order; ``close``
    (or a ``with`` block) joins the threads."""

    def __init__(self, channels: int, frames: int, sources: int, num_threads: int = 4):
        self._lib = _wavio()
        self.channels, self.frames, self.sources = channels, frames, sources
        self.num_threads = num_threads
        self._handle = self._lib.prefetch_create(channels, frames, sources)
        self._files: tp.List[list] = []
        self._started = False

    def add_job(self, files: tp.Sequence[tp.Union[str, Path]], offset: int, mean: float = 0.0,
                std: float = 1.0) -> int:
        if self._started:
            raise RuntimeError("add_job after start")
        if len(files) != self.sources:
            raise ValueError(f"{len(files)} files for {self.sources} sources")
        self._files.append([str(f) for f in files])
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in self._files[-1]])
        self._lib.prefetch_add_job(self._handle, arr, len(files), offset, mean, std)
        return len(self._files) - 1

    def start(self) -> None:
        self._lib.prefetch_start(self._handle, self.num_threads)
        self._started = True

    def get(self, i: int) -> np.ndarray:
        if not self._started:
            raise RuntimeError("get before start")
        out = np.empty((self.sources, self.channels, self.frames), np.float32)
        code = self._lib.prefetch_get(self._handle, i,
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if code == 1:
            raise IndexError(i)
        if code < 0:
            raise _wav_error(self._files[i], code)
        return out

    def __len__(self) -> int:
        return len(self._files)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


# ---------------------------------------------------------------- plain twins

def crc8_plain(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07 if crc & 0x80 else crc << 1) & 0xFF
    return crc


def crc16_plain(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def rice_decode_plain(data: bytes, bitpos: int, count: int, k: int
                      ) -> tp.Tuple[np.ndarray, int]:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    out = np.empty(count, np.int64)
    for i in range(count):
        q = 0
        while bitpos < len(bits) and not bits[bitpos]:
            bitpos += 1
            q += 1
        if bitpos + 1 + k > len(bits):
            raise ValueError("rice stream overrun (truncated frame)")
        bitpos += 1  # the terminating 1 bit
        low = 0
        for b in bits[bitpos:bitpos + k]:
            low = (low << 1) | int(b)
        bitpos += k
        u = (q << k) | low
        out[i] = (u >> 1) ^ -(u & 1)
    return out, bitpos


def lpc_restore_plain(coefs: np.ndarray, shift: int, x: np.ndarray) -> None:
    order = len(coefs)
    for i in range(order, len(x)):
        pred = sum(int(c) * int(x[i - 1 - j]) for j, c in enumerate(coefs))
        x[i] += pred >> shift
