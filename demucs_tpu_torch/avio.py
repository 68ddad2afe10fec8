"""ctypes binding of the libavformat/libavcodec shim ``csrc/avio.cpp``
(port of ``demucs_tpu/avio.py``).

Where the ffmpeg binary is absent but its libraries are present, the shim
decodes any format libavcodec knows (ogg, m4a, multi-stream .mp4, ...) in
process for ``read_audio`` and ``AudioFile``, and encodes test inputs; it is
also the independent oracle the tests hold the port's FLAC and mp3 codecs
against. The shim is built with g++ against the system's headers at first
use (``native.load``); :func:`available` is False when the headers or the
libraries are absent, and :func:`unavailable_reason` says why.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np

from demucs_tpu_torch import native

__all__ = ["available", "unavailable_reason", "decode_file", "read_pcm", "probe",
           "encode_flac", "encode", "encode_multi"]

_LINK = ("-lavformat", "-lavcodec", "-lavutil")


@functools.cache
def _load() -> tp.Tuple[tp.Optional[ctypes.CDLL], str]:
    """(the bound library, "") or (None, why it could not be built or loaded)."""
    try:
        lib = native.load("avio", _LINK)
    except (RuntimeError, OSError) as err:
        return None, str(err)
    lib.avio_decode_stream.restype = ctypes.c_int
    lib.avio_decode_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int]
    lib.avio_probe.restype = ctypes.c_int
    lib.avio_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
    lib.avio_encode_flac.restype = ctypes.c_int
    lib.avio_encode_flac.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.avio_encode.restype = ctypes.c_int
    lib.avio_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_int]
    lib.avio_encode_multi.restype = ctypes.c_int
    lib.avio_encode_multi.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
    lib.avio_free.restype = None
    lib.avio_free.argtypes = [ctypes.c_void_p]
    return lib, ""


def _get_lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"avio (libavcodec shim) is unavailable: {why}")
    return lib


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str:
    """Why the shim is unavailable ("" when it is available)."""
    return _load()[1]


def decode_file(path, stream: int = -1) -> tp.Tuple[np.ndarray, int, int, int]:
    """Decode a libavcodec-supported audio file (``stream``: 0-based ordinal
    among the file's AUDIO streams, -1 = libavformat's best pick).

    Returns ``(samples, samplerate, bits, container)`` where ``samples`` is
    ``(C, T)``: int32 with VERBATIM decoder values for integer codecs
    (exactness for cross-validation), float32 for float codecs (e.g. mp3).
    Integer decoders left-justify raw samples in their container
    (``container`` = 8/16/32), e.g. 24-bit FLAC arrives as values << 8.
    """
    lib = _get_lib()
    out = ctypes.c_void_p()
    frames = ctypes.c_longlong()
    channels = ctypes.c_int()
    samplerate = ctypes.c_int()
    fmt = ctypes.c_int()
    bits = ctypes.c_int()
    container = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.avio_decode_stream(str(path).encode(), int(stream),
                                ctypes.byref(out),
                                ctypes.byref(frames), ctypes.byref(channels),
                                ctypes.byref(samplerate), ctypes.byref(fmt),
                                ctypes.byref(bits), ctypes.byref(container),
                                err, len(err))
    if rc != 0:
        raise RuntimeError(f"avio_decode({path}): {err.value.decode()}")
    try:
        n = frames.value * channels.value
        raw = ctypes.cast(out, ctypes.POINTER(ctypes.c_int32 * n)).contents
        arr = np.frombuffer(
            bytearray(raw), dtype=np.float32 if fmt.value else np.int32)
    finally:
        lib.avio_free(out)
    return (arr.reshape(frames.value, channels.value).T.copy(),
            samplerate.value, bits.value, container.value)


def read_pcm(path, stream: int = -1) -> tp.Tuple[np.ndarray, int]:
    """Decode to normalized float32 ``(C, T)`` in [-1, 1] + samplerate —
    the ``read_audio`` fallback contract."""
    arr, sr, _bits, container = decode_file(path, stream)
    if arr.dtype == np.float32:
        return arr, sr
    return (arr.astype(np.float32) / float(1 << (container - 1))), sr


def probe(path) -> tp.Tuple[tp.List[dict], float]:
    """Container metadata without decoding: a list of per-audio-stream dicts
    ``{channels, samplerate, frames}`` (frames 0 if the container doesn't
    say) plus the container duration in seconds (-1 if unknown)."""
    lib = _get_lib()
    max_streams = 64
    meta = (ctypes.c_longlong * (3 * max_streams))()
    dur = ctypes.c_double(-1.0)
    err = ctypes.create_string_buffer(256)
    n = lib.avio_probe(str(path).encode(), meta, max_streams,
                       ctypes.byref(dur), err, len(err))
    if n < 0:
        raise RuntimeError(f"avio_probe({path}): {err.value.decode()}")
    streams = [{"channels": int(meta[3 * k]),
                "samplerate": int(meta[3 * k + 1]),
                "frames": int(meta[3 * k + 2])}
               for k in range(min(n, max_streams))]
    return streams, float(dur.value)


def encode_flac(path, pcm: np.ndarray, samplerate: int,
                bits_per_sample: int = 16, compression_level: int = 5) -> None:
    """Encode int PCM ``(C, T)`` (16- or 24-bit values in int32) to FLAC via
    libavcodec — the external encoder oracle for flacio's decoder."""
    lib = _get_lib()
    pcm = np.asarray(pcm)
    if pcm.ndim != 2:
        raise ValueError(f"expected a 2-d array, got {pcm.shape}")
    channels, frames = pcm.shape
    inter = np.ascontiguousarray(pcm.T.astype(np.int32))
    err = ctypes.create_string_buffer(256)
    rc = lib.avio_encode_flac(
        str(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frames, channels, int(samplerate), int(bits_per_sample),
        int(compression_level), err, len(err))
    if rc != 0:
        raise RuntimeError(f"avio_encode_flac({path}): {err.value.decode()}")


def encode(path, wav: np.ndarray, samplerate: int, codec: str,
           bitrate: int = 0) -> None:
    """Encode normalized float32 ``(C, T)`` with any named libavcodec
    encoder (muxer from the file extension): synthesizes ogg/m4a/... inputs
    for testing read_audio's any-format fallback. ``bitrate`` 0 = encoder
    default."""
    lib = _get_lib()
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim != 2:
        raise ValueError(f"expected a 2-d array, got {wav.shape}")
    channels, frames = wav.shape
    inter = np.ascontiguousarray(wav.T)
    err = ctypes.create_string_buffer(256)
    rc = lib.avio_encode(
        str(path).encode(), codec.encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, int(samplerate), int(bitrate), err, len(err))
    if rc != 0:
        raise RuntimeError(f"avio_encode({path}, {codec}): {err.value.decode()}")


def encode_multi(path, wavs: np.ndarray, samplerate: int, codec: str,
                 bitrate: int = 0) -> None:
    """Encode ``(S, C, T)`` float32 as S parallel audio streams in one
    container (e.g. 5 alac streams in .mp4 — the reference's .stem.mp4
    shape), each stream addressable via ``decode_file(path, stream=k)`` or
    ``AudioFile.read(streams=...)``."""
    lib = _get_lib()
    wavs = np.asarray(wavs, dtype=np.float32)
    if wavs.ndim != 3:
        raise ValueError(f"expected a 3-d array, got {wavs.shape}")
    nstreams, channels, frames = wavs.shape
    inter = np.ascontiguousarray(wavs.transpose(0, 2, 1))
    err = ctypes.create_string_buffer(256)
    rc = lib.avio_encode_multi(
        str(path).encode(), codec.encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nstreams, frames, channels, int(samplerate), int(bitrate),
        err, len(err))
    if rc != 0:
        raise RuntimeError(
            f"avio_encode_multi({path}, {codec}): {err.value.decode()}")
