"""Audio input and output on the host (port of ``demucs_tpu/audio.py``).

Behavioral reference ``demucs/audio.py``, with numpy in place of
torchaudio:

- WAV (PCM 16/24/32-bit and IEEE float32) and FLAC (``flacio``) are the
  port's own codecs; mp3 binds libmp3lame and libmpg123 (``mp3io``);
- any other format is decoded in process by the libavcodec shim (``avio``)
  or, where only the ffmpeg binaries exist, by ffmpeg as the reference does
  (``AudioFile``);
- channel conversion, resampling (``ops/resample.py``) and the clipping
  strategies are the reference's.

Which codec needs what: WAV and FLAC need nothing but g++ (``native.py``
builds the FLAC helpers); mp3 needs libmp3lame to write and libmpg123 to
read, else the ffmpeg binary; other formats need the libavcodec libraries
and headers (``avio``) or the ffmpeg and ffprobe binaries.
"""

from __future__ import annotations

import json
import shutil
import struct
import subprocess as sp
import tempfile
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch import avio, flacio, mp3io
from demucs_tpu_torch.ops.resample import resample_frac

__all__ = ["AudioFile", "read_wav", "write_wav", "read_audio", "save_audio", "resample",
           "convert_audio", "convert_audio_channels", "prevent_clip", "ffmpeg_available"]


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


class AudioFile:
    """Read audio of any format ffmpeg knows, several streams per file
    (``demucs/audio.py:28-140``): with the ffmpeg and ffprobe binaries where
    both are installed, otherwise in process with the libavcodec shim
    (``avio``), which has the same codecs. In shim mode ``seek_time`` is
    sample-exact (decode, then trim) where ffmpeg's ``-ss`` seeks to the
    nearest sync point."""

    def __init__(self, path):
        self.path = Path(path)
        self._info: tp.Optional[dict] = None
        self._probe: tp.Optional[tuple] = None

    @property
    def _use_ffmpeg(self) -> bool:
        return ffmpeg_available()

    def _avio_probe(self) -> tuple:
        if self._probe is None:
            self._probe = avio.probe(self.path)
        return self._probe

    def __repr__(self):
        return (f"AudioFile(path={self.path}, samplerate={self.samplerate()}, "
                f"channels={self.channels()}, streams={len(self)})")

    @property
    def info(self) -> dict:
        if self._info is None:
            out = sp.check_output(["ffprobe", "-loglevel", "panic", str(self.path),
                                   "-print_format", "json", "-show_format", "-show_streams"])
            self._info = json.loads(out.decode("utf-8"))
        return self._info

    @property
    def duration(self) -> float:
        """Seconds: the container's stated duration, else the longest stream's
        stated length, else the longest stream's decoded length. Never
        negative: a file that decodes to nothing raises."""
        if self._use_ffmpeg:
            stated = self.info["format"].get("duration")
            if stated is not None:
                return float(stated)
        else:
            streams, stated = self._avio_probe()
            if stated > 0:
                return stated
            lengths = [s["frames"] / s["samplerate"] for s in streams
                       if s["samplerate"] > 0 and s["frames"] > 0]
            if lengths:
                return max(lengths)
        lengths = [self.read(streams=k).shape[-1] / self.samplerate(k) for k in range(len(self))]
        if not lengths or max(lengths) <= 0:
            raise RuntimeError(f"{self.path}: no audio to measure the duration of")
        return max(lengths)

    @property
    def _audio_streams(self):
        return [index for index, stream in enumerate(self.info["streams"])
                if stream["codec_type"] == "audio"]

    def __len__(self):
        if not self._use_ffmpeg:
            return len(self._avio_probe()[0])
        return len(self._audio_streams)

    def channels(self, stream=0) -> int:
        if not self._use_ffmpeg:
            return self._avio_probe()[0][stream]["channels"]
        return int(self.info["streams"][self._audio_streams[stream]]["channels"])

    def samplerate(self, stream=0) -> int:
        if not self._use_ffmpeg:
            return self._avio_probe()[0][stream]["samplerate"]
        return int(self.info["streams"][self._audio_streams[stream]]["sample_rate"])

    def read(self, seek_time=None, duration=None, streams=slice(None), samplerate=None,
             channels=None) -> np.ndarray:
        """Stream(s) as float32 ``(S, C, T)``, or ``(C, T)`` for an int stream
        index, optionally from ``seek_time`` for ``duration`` seconds,
        resampled and channel-converted (``demucs/audio.py:71-140``). Shim mode
        decodes each selected stream in full, then trims."""
        streams_arr = np.array(range(len(self)))[streams]
        single = not isinstance(streams_arr, np.ndarray)
        if single:
            streams_arr = [streams_arr]
        if duration is None:
            target_size = query_duration = None
        else:
            target_size = int((samplerate or self.samplerate()) * duration)
            query_duration = float((target_size + 1) / (samplerate or self.samplerate()))

        wavs = []
        if not self._use_ffmpeg:
            for stream in streams_arr:
                wav = avio.read_pcm(self.path, int(stream))[0]
                native_sr = self.samplerate(int(stream))
                if seek_time:
                    wav = wav[..., int(seek_time * native_sr):]
                if samplerate is not None and samplerate != native_sr:
                    wav = resample(wav, native_sr, samplerate)
                if channels is not None:
                    wav = convert_audio_channels(wav, channels)
                if target_size is not None:
                    wav = wav[..., :target_size]
                wavs.append(wav)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                command = ["ffmpeg", "-y", "-loglevel", "panic"]
                if seek_time:
                    command += ["-ss", str(seek_time)]
                command += ["-i", str(self.path)]
                filenames = [f"{tmp}/{i}.f32" for i in range(len(streams_arr))]
                for stream, filename in zip(streams_arr, filenames):
                    command += ["-map", f"0:{self._audio_streams[stream]}"]
                    if query_duration is not None:
                        command += ["-t", str(query_duration)]
                    command += ["-threads", "1", "-f", "f32le"]
                    if samplerate is not None:
                        command += ["-ar", str(samplerate)]
                    command += [filename]
                sp.run(command, check=True)
                for stream, filename in zip(streams_arr, filenames):
                    wav = np.fromfile(filename, dtype=np.float32)
                    wav = wav.reshape(-1, self.channels(int(stream))).T
                    if channels is not None:
                        wav = convert_audio_channels(wav, channels)
                    if target_size is not None:
                        wav = wav[..., :target_size]
                    wavs.append(wav)
        wav = np.stack(wavs, axis=0)
        return wav[0] if single else wav


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
    """Read an audio file -> (float32 ``(C, T)``, sr), converted to
    ``channels`` and resampled to ``samplerate`` (then the returned sr).

    By suffix: ``.wav`` and ``.flac`` through the port's own codecs, ``.mp3``
    through libmpg123 where it exists; anything else (and mp3 without
    libmpg123) through the libavcodec shim, else through the ffmpeg binaries,
    else it raises ``RuntimeError``."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        wav, sr = read_wav(path)
    elif suffix == ".flac":
        wav, sr = flacio.read_flac(path)
    elif suffix == ".mp3" and mp3io.mpg123_available():
        wav, sr = mp3io.read_mp3(path)
    elif avio.available():
        wav, sr = avio.read_pcm(path)
    elif ffmpeg_available():
        audio_file = AudioFile(path)
        wav, sr = audio_file.read(streams=0), audio_file.samplerate()
    else:
        raise RuntimeError(f"Cannot read {path}: not WAV or FLAC, and neither the "
                           "libavcodec shim nor the ffmpeg binaries are available")
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


def _mp3_with_ffmpeg(wav: np.ndarray, path, samplerate: int, bitrate: int) -> None:
    if not ffmpeg_available():
        raise RuntimeError("Saving .mp3 needs libmp3lame or the ffmpeg binary (neither is "
                           "installed); use .wav or .flac output instead.")
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        write_wav(tmp.name, wav, samplerate, as_float=True)
        sp.run(["ffmpeg", "-y", "-loglevel", "panic", "-i", tmp.name, "-b:a", f"{bitrate}k",
                str(path)], check=True)


def save_audio(wav: np.ndarray, path, samplerate: int, bitrate: int = 320,
               clip: str = "rescale", bits_per_sample: int = 16, as_float: bool = False,
               preset: int = 2) -> None:
    """Save audio with clip prevention (``demucs/audio.py:236-265``): ``.wav``
    and ``.flac`` through the port's own codecs (``bits_per_sample`` 16 or 24,
    ``as_float`` for float32 WAV), ``.mp3`` through libmp3lame at ``bitrate``
    kb/s with the quality ``preset`` (2 best .. 7 fastest), the library the
    reference's ``lameenc`` wraps, or through the ffmpeg binary where LAME is
    absent."""
    wav = prevent_clip(np.asarray(wav, dtype=np.float32), mode=clip)
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        write_wav(path, wav, samplerate, bits_per_sample=32 if as_float else bits_per_sample,
                  as_float=as_float)
    elif suffix == ".flac":
        flacio.write_flac(path, wav, samplerate, bits_per_sample=bits_per_sample)
    elif suffix == ".mp3":
        if mp3io.lame_available():
            mp3io.write_mp3(path, wav, samplerate, bitrate, quality=preset)
        else:
            _mp3_with_ffmpeg(wav, path, samplerate, bitrate)
    else:
        raise ValueError(f"Invalid suffix for path: {suffix}")
