"""WAV input and output in numpy (port of the WAV part of ``demucs_tpu/audio.py``).

Reads and writes RIFF/WAVE files (PCM 16/24/32-bit and IEEE float32), with
the channel conversion, resampling (``ops/resample.py``) and clipping
strategies of the reference's ``demucs/audio.py``. The FLAC, mp3 and
libavcodec codecs come with later slices of the port.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch.ops.resample import resample_frac

__all__ = ["read_wav", "write_wav", "read_audio", "save_audio", "resample", "convert_audio",
           "convert_audio_channels", "prevent_clip"]


def _parse_wav_header(path) -> tp.Tuple[tuple, int, int]:
    """Return (fmt tuple, data byte offset, data byte size)."""
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data_off = data_size = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                rest = f.read(chunk_size + (chunk_size & 1) - 16)
                if fmt[0] == 0xFFFE and len(rest) >= 24:
                    # WAVE_FORMAT_EXTENSIBLE: the real format code is the first
                    # two bytes of the SubFormat GUID (after cbSize, validBits
                    # and channelMask)
                    sub = struct.unpack_from("<H", rest, 8)[0]
                    fmt = (sub,) + fmt[1:]
            elif chunk_id == b"data":
                data_off = f.tell()
                data_size = chunk_size
                f.seek(chunk_size + (chunk_size & 1), 1)
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
        if fmt is None or data_off is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data_off, data_size


def read_wav(path, frame_offset: int = 0,
             num_frames: tp.Optional[int] = None) -> tp.Tuple[np.ndarray, int]:
    """Read a WAV file (optionally a frame window) -> (float32 ``(C, T)``, sr)."""
    fmt, data_off, data_size = _parse_wav_header(path)
    audio_format, n_channels, samplerate, _byte_rate, block_align, bits = fmt
    total_frames = data_size // block_align
    if num_frames is None:
        num_frames = total_frames - frame_offset
    num_frames = max(0, min(num_frames, total_frames - frame_offset))
    with open(path, "rb") as f:
        f.seek(data_off + frame_offset * block_align)
        data = f.read(num_frames * block_align)
    if audio_format == 3 and bits == 32:
        arr = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        arr = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = (ints << 8) >> 8  # sign-extend
        arr = ints.astype(np.float32) / (2**23)
    elif audio_format == 1 and bits == 32:
        arr = np.frombuffer(data, dtype="<i4").astype(np.float32) / (2**31)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_format}/{bits}bit")
    return arr.reshape(-1, n_channels).T.copy(), samplerate


def write_wav(path, wav: np.ndarray, samplerate: int, *, bits_per_sample: int = 16,
              as_float: bool = False) -> None:
    """Write float32 ``(C, T)`` as WAV (PCM 16/24/32 or IEEE float 32)."""
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim != 2:
        raise ValueError(f"write_wav expects (channels, samples), got {wav.shape}")
    C, _ = wav.shape
    interleaved = wav.T  # (T, C)
    if as_float:
        payload = interleaved.astype("<f4").tobytes()
        fmt_code, bits = 3, 32
    elif bits_per_sample == 16:
        payload = (np.clip(interleaved, -1, 1) * (2**15 - 1)).astype("<i2").tobytes()
        fmt_code, bits = 1, 16
    elif bits_per_sample == 24:
        ints = (np.clip(interleaved, -1, 1) * (2**23 - 1)).astype(np.int32).reshape(-1)
        raw = np.zeros((ints.size, 3), dtype=np.uint8)
        raw[:, 0] = ints & 0xFF
        raw[:, 1] = (ints >> 8) & 0xFF
        raw[:, 2] = (ints >> 16) & 0xFF
        payload = raw.tobytes()
        fmt_code, bits = 1, 24
    elif bits_per_sample == 32:
        payload = (np.clip(interleaved, -1, 1) * (2**31 - 1)).astype("<i4").tobytes()
        fmt_code, bits = 1, 32
    else:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    block_align = C * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt_code, C, samplerate,
                            samplerate * block_align, block_align, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def convert_audio_channels(wav: np.ndarray, channels: int = 2) -> np.ndarray:
    """Channel conversion (``demucs/audio.py:143-166``)."""
    *shape, src_channels, length = wav.shape
    if src_channels == channels:
        return wav
    if channels == 1:
        return wav.mean(axis=-2, keepdims=True)
    if src_channels == 1:
        return np.broadcast_to(wav, (*shape, channels, length)).copy()
    if src_channels >= channels:
        return wav[..., :channels, :]
    raise ValueError("The audio file has less channels than requested but is not mono.")


def resample(wav: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Resample float32 ``wav (..., T)`` on the host (``resample_frac``)."""
    if from_sr == to_sr:
        return wav
    x = torch.from_numpy(np.ascontiguousarray(wav, dtype=np.float32))
    return resample_frac(x, from_sr, to_sr).numpy()


def convert_audio(wav: np.ndarray, from_samplerate: int, to_samplerate: int,
                  channels: int) -> np.ndarray:
    """Channel and rate conversion (``demucs/audio.py:169-172``)."""
    wav = convert_audio_channels(wav, channels)
    return resample(wav, from_samplerate, to_samplerate)


def read_audio(path, samplerate: tp.Optional[int] = None,
               channels: tp.Optional[int] = None) -> tp.Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 ``(C, T)``, sr), converted to ``channels``
    and resampled to ``samplerate`` (then the returned sr)."""
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise ValueError(f"{path}: the port reads WAV files only so far")
    wav, sr = read_wav(path)
    if channels is not None:
        wav = convert_audio_channels(wav, channels)
    if samplerate is not None and samplerate != sr:
        wav = resample(wav, sr, samplerate)
        sr = samplerate
    return wav, sr


def prevent_clip(wav: np.ndarray, mode: str = "rescale") -> np.ndarray:
    """Clipping strategies (``demucs/audio.py:218-233``)."""
    if mode is None or mode == "none":
        return wav
    if not np.issubdtype(wav.dtype, np.floating):
        raise TypeError("too late for clipping")
    if mode == "rescale":
        return wav / max(1.01 * np.abs(wav).max(), 1)
    if mode == "clamp":
        return np.clip(wav, -0.99, 0.99)
    if mode == "tanh":
        return np.tanh(wav)
    raise ValueError(f"Invalid mode {mode}")


def save_audio(wav: np.ndarray, path, samplerate: int, clip: str = "rescale",
               bits_per_sample: int = 16, as_float: bool = False) -> None:
    """Save a WAV file with clip prevention (``demucs/audio.py:236-265``)."""
    wav = prevent_clip(np.asarray(wav, dtype=np.float32), mode=clip)
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise ValueError(f"the port writes .wav files only so far, not {path.suffix}")
    write_wav(path, wav, samplerate, bits_per_sample=32 if as_float else bits_per_sample,
              as_float=as_float)
