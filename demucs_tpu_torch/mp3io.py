"""mp3 codec (port of ``demucs_tpu/mp3io.py``): ctypes bindings to libmp3lame
(encode) and libmpg123 (decode).

The reference guarantees ``--mp3`` works everywhere by shipping ``lameenc``
— a thin binding over libmp3lame (``demucs/audio.py:199-215``). We bind the
same library directly with ctypes, so mp3 encode needs no ffmpeg binary and
no subprocess; decode binds libmpg123, giving first-party mp3 *read* support
the reference only gets through the ffmpeg CLI (``demucs/audio.py:28-140``).
Both degrade gracefully (``lame_available()`` / ``mpg123_available()``) when
the shared libraries are absent; ``audio.py`` then falls back to ffmpeg.

Encode semantics mirror ``encode_mp3``: float input is clamped and scaled by
``2**15 - 1`` to int16 (``demucs/audio.py:176-180``), CBR at ``bitrate``
kb/s, LAME quality knob = ``quality`` (2 best .. 7 fastest). One deliberate
improvement over lameenc: after flush we patch the LAME/Xing Info frame at
the stream head (``lame_get_lametag_frame``), so decoders recover the exact
original length (gapless trim of the encoder delay + padding).
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp
from pathlib import Path

import numpy as np

__all__ = [
    "lame_available",
    "mpg123_available",
    "encode_mp3",
    "write_mp3",
    "read_mp3",
]

_LAME_NAMES = ("libmp3lame.so.0", "libmp3lame.so", "libmp3lame.dylib")
_MPG123_NAMES = ("libmpg123.so.0", "libmpg123.so", "libmpg123.dylib")

# libmpg123 constants (mpg123.h; stable public ABI)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ADD_FLAGS = 2  # enum mpg123_parms
_MPG123_QUIET = 0x20
_MPG123_FORCE_FLOAT = 0x400
_MPG123_ENC_SIGNED_16 = 0x0D0
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ENC_FLOAT_64 = 0x400


def _load(names: tp.Sequence[str]) -> tp.Optional[ctypes.CDLL]:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


@functools.cache
def _get_lame() -> tp.Optional[ctypes.CDLL]:
    lib = _load(_LAME_NAMES)
    if lib is None:
        return None
    try:
        lib.lame_init.restype = ctypes.c_void_p
        lib.lame_init.argtypes = []
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_brate", "lame_set_quality",
                   "lame_set_bWriteVbrTag"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.restype = ctypes.c_int
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer_interleaved.restype = ctypes.c_int
        lib.lame_encode_buffer_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_short), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.lame_encode_buffer.restype = ctypes.c_int
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
            ctypes.POINTER(ctypes.c_short),
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.lame_get_lametag_frame.restype = ctypes.c_size_t
        lib.lame_get_lametag_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_size_t]
        lib.lame_close.restype = ctypes.c_int
        lib.lame_close.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return None
    return lib


@functools.cache
def _get_mpg123() -> tp.Optional[ctypes.CDLL]:
    lib = _load(_MPG123_NAMES)
    if lib is None:
        return None
    try:
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_init.argtypes = []
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_param.restype = ctypes.c_int
        lib.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_long, ctypes.c_double]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.restype = ctypes.c_int
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.restype = ctypes.c_int
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.restype = ctypes.c_int
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_plain_strerror.restype = ctypes.c_char_p
        lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    except AttributeError:
        return None
    lib.mpg123_init()  # no-op on modern libmpg123, required on older ones
    return lib


def lame_available() -> bool:
    return _get_lame() is not None


def mpg123_available() -> bool:
    return _get_mpg123() is not None


def encode_mp3(wav: np.ndarray, samplerate: int = 44100, bitrate: int = 320,
               quality: int = 2) -> bytes:
    """Encode float32/int16 ``(C, T)`` PCM to an mp3 byte stream (CBR).

    Matches the reference ``encode_mp3`` contract (``demucs/audio.py:199``):
    ``bitrate`` in kb/s, ``quality`` 2 (best) .. 7 (fastest). Raises
    ``RuntimeError`` when libmp3lame is unavailable.
    """
    lib = _get_lame()
    if lib is None:
        raise RuntimeError(
            "libmp3lame is not available; install LAME or ffmpeg for mp3 output")
    wav = np.asarray(wav)
    if wav.ndim != 2:
        raise ValueError(f"encode_mp3 expects (channels, samples), got {wav.shape}")
    channels, length = wav.shape
    if channels not in (1, 2):
        raise ValueError(f"mp3 supports 1 or 2 channels, got {channels}")
    if not 2 <= int(quality) <= 7:
        raise ValueError(f"mp3 quality preset must be in 2..7, got {quality}")
    if np.issubdtype(wav.dtype, np.floating):
        # Reference i16_pcm: clamp then scale by 2**15 - 1, truncating
        # (demucs/audio.py:176-180).
        pcm = (np.clip(wav, -1, 1) * (2**15 - 1)).astype(np.int16)
    elif wav.dtype == np.int16:
        pcm = wav
    else:
        raise ValueError(f"expected float or int16 PCM, got {wav.dtype}")

    lgf = lib.lame_init()
    if not lgf:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(lgf, int(samplerate))
        lib.lame_set_num_channels(lgf, channels)
        lib.lame_set_brate(lgf, int(bitrate))
        lib.lame_set_quality(lgf, int(quality))
        lib.lame_set_bWriteVbrTag(lgf, 1)
        if lib.lame_init_params(lgf) < 0:
            raise RuntimeError(
                f"lame_init_params rejected samplerate={samplerate} "
                f"channels={channels} bitrate={bitrate}")

        chunks: tp.List[bytes] = []
        short_p = ctypes.POINTER(ctypes.c_short)
        step = 1 << 16  # frames per encode call
        for start in range(0, length, step):
            block = np.ascontiguousarray(pcm[:, start:start + step].T)
            nframes = block.shape[0]
            outlen = int(1.25 * nframes * channels) + 7200
            out = (ctypes.c_ubyte * outlen)()
            if channels == 2:
                n = lib.lame_encode_buffer_interleaved(
                    lgf, block.ctypes.data_as(short_p), nframes, out, outlen)
            else:
                mono = block.ctypes.data_as(short_p)
                n = lib.lame_encode_buffer(lgf, mono, mono, nframes, out, outlen)
            if n < 0:
                raise RuntimeError(f"lame_encode_buffer failed ({n})")
            chunks.append(bytes(out[:n]))
        out = (ctypes.c_ubyte * 7200)()
        n = lib.lame_encode_flush(lgf, out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_flush failed ({n})")
        chunks.append(bytes(out[:n]))
        data = bytearray(b"".join(chunks))

        # Finalize the Xing/Info frame LAME emitted at the stream head so
        # decoders can trim the codec delay/padding (exact-length decode).
        tag = (ctypes.c_ubyte * 4096)()
        tag_len = lib.lame_get_lametag_frame(lgf, tag, len(tag))
        if 0 < tag_len <= len(tag) and tag_len <= len(data):
            data[:tag_len] = bytes(tag[:tag_len])
        return bytes(data)
    finally:
        lib.lame_close(lgf)


def write_mp3(path, wav: np.ndarray, samplerate: int, bitrate: int = 320,
              quality: int = 2) -> None:
    data = encode_mp3(wav, samplerate, bitrate, quality)
    Path(path).write_bytes(data)


def read_mp3(path) -> tp.Tuple[np.ndarray, int]:
    """Decode an mp3 file -> (float32 ``(C, T)``, samplerate) via libmpg123.

    Gapless: honors the LAME Info tag (mpg123 default), so files written by
    ``write_mp3`` decode to exactly the original length.
    """
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError(
            "libmpg123 is not available; install mpg123 or ffmpeg to read mp3")
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        lib.mpg123_param(handle, _MPG123_ADD_FLAGS,
                         _MPG123_QUIET | _MPG123_FORCE_FLOAT, 0.0)
        rc = lib.mpg123_open(handle, str(path).encode())
        if rc != _MPG123_OK:
            raise RuntimeError(
                f"mpg123_open({path}) failed: "
                f"{lib.mpg123_plain_strerror(rc).decode()}")
        try:
            rate = ctypes.c_long(0)
            channels = ctypes.c_int(0)
            encoding = ctypes.c_int(0)
            rc = lib.mpg123_getformat(handle, ctypes.byref(rate),
                                      ctypes.byref(channels),
                                      ctypes.byref(encoding))
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_getformat failed ({rc})")
            # Pin the negotiated format so a mid-stream change errors instead
            # of silently switching sample layout.
            lib.mpg123_format_none(handle)
            lib.mpg123_format(handle, rate.value, channels.value,
                              encoding.value)
            raw = bytearray()
            buf = ctypes.create_string_buffer(1 << 18)
            done = ctypes.c_size_t(0)
            while True:
                rc = lib.mpg123_read(handle, buf, len(buf),
                                     ctypes.byref(done))
                if done.value:
                    raw += buf.raw[:done.value]
                if rc == _MPG123_DONE:
                    break
                if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                    raise RuntimeError(
                        f"mpg123_read failed: "
                        f"{lib.mpg123_plain_strerror(rc).decode()}")
        finally:
            lib.mpg123_close(handle)
    finally:
        lib.mpg123_delete(handle)

    enc = encoding.value
    if enc == _MPG123_ENC_FLOAT_32:
        arr = np.frombuffer(bytes(raw), dtype=np.float32)
    elif enc == _MPG123_ENC_FLOAT_64:
        arr = np.frombuffer(bytes(raw), dtype=np.float64).astype(np.float32)
    elif enc == _MPG123_ENC_SIGNED_16:
        arr = np.frombuffer(bytes(raw), dtype=np.int16).astype(np.float32)
        arr = arr / 32768.0
    else:
        raise RuntimeError(f"unexpected mpg123 output encoding 0x{enc:x}")
    return arr.reshape(-1, channels.value).T.copy(), int(rate.value)
