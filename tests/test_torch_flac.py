"""The port's FLAC codec (demucs_tpu_torch/flacio.py, its C++ loops in
csrc/codec.cpp through native.py) against the JAX package's flacio, on the
same integer samples made from a seed with numpy.

Tolerance: none. FLAC is lossless: the port's encoder must write the JAX
encoder's bytes, and each decoder must give back the other's samples bit for
bit. The C++ loops equal their pure-Python twins exactly.
"""

import threading

import numpy as np
import pytest

from demucs_tpu import flacio as jflac
from demucs_tpu_torch import flacio, native

from test_flac_golden import EXPECTED, GOLDEN, META


def _pcm(channels, length, bps, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 44100
    wav = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal((channels, length))
    lim = (1 << (bps - 1)) - 1
    return np.clip(np.round(wav * lim), -lim - 1, lim).astype(np.int32)


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("channels,length", [(2, 3 * 4096 + 17), (1, 4097)])
def test_port_and_jax_codecs_agree(bps, channels, length):
    x = _pcm(channels, length, bps, seed=bps + channels)
    data = flacio.encode_flac(x, 44100, bps)
    assert data == jflac.encode_flac(x, 44100, bps)
    got, sr, got_bps = jflac.decode_flac(data)  # port encode, JAX decode
    np.testing.assert_array_equal(got, x)
    got, sr, got_bps = flacio.decode_flac(data)  # JAX encode (same bytes), port decode
    assert (sr, got_bps) == (44100, bps)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_golden_files_decode_as_jax(name):
    data = (GOLDEN / name).read_bytes()
    got, sr, bps = flacio.decode_flac(data)
    want, jsr, jbps = jflac.decode_flac(data)
    assert (sr, bps) == (jsr, jbps) == META[name]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, EXPECTED[name])


def _random_rice_stream(rng, count, k):
    """Bytes holding ``count`` Rice codes of parameter k after a random 5-bit prefix."""
    u = rng.integers(0, 1 << (k + 3), count)
    bits = list(rng.integers(0, 2, 5))
    for v in u:
        bits += [0] * int(v >> k) + [1] + [(int(v) >> (k - 1 - j)) & 1 for j in range(k)]
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8)).tobytes()


@pytest.mark.parametrize("helper", ["crc8", "crc16", "rice_decode", "rice_overrun",
                                    "lpc_restore"])
def test_cpp_helpers_equal_plain_twins(helper):
    rng = np.random.default_rng(sum(map(ord, helper)))
    if helper in ("crc8", "crc16"):
        fast, plain = getattr(native, helper), getattr(native, f"{helper}_plain")
        for n in (0, 1, 7, 300):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert fast(data) == plain(data)
    elif helper == "rice_decode":
        for k in (0, 1, 5, 13):
            data = _random_rice_stream(rng, 200, k)
            out, pos = native.rice_decode(data, 5, 200, k)
            want, want_pos = native.rice_decode_plain(data, 5, 200, k)
            np.testing.assert_array_equal(out, want)
            assert pos == want_pos
    elif helper == "rice_overrun":
        data = _random_rice_stream(rng, 50, 4)
        for fn in (native.rice_decode, native.rice_decode_plain):
            with pytest.raises(ValueError, match="overrun"):
                fn(data, 5, 500, 4)
    else:
        # residuals of a random signal under random coefficients, so that the
        # restored samples are that signal (an unstable predictor stays bounded)
        for order, shift in ((1, 0), (8, 12), (32, 15)):
            coefs = rng.integers(-(1 << 10), 1 << 10, order).astype(np.int32)
            signal = rng.integers(-(1 << 15), 1 << 15, 500).astype(np.int64)
            x = signal.copy()
            for i in range(order, len(x)):
                x[i] -= int(np.dot(coefs, signal[i - order:i][::-1])) >> shift
            want = x.copy()
            native.lpc_restore(coefs, shift, x)
            native.lpc_restore_plain(coefs, shift, want)
            np.testing.assert_array_equal(x, want)
            np.testing.assert_array_equal(x, signal)


@pytest.mark.parametrize("where", ["header", "body"])
def test_flipped_bit_fails_the_crc(where):
    x = _pcm(2, 5000, 16, seed=3)
    data = bytearray(flacio.encode_flac(x, 44100, 16))
    first_frame = data.index(b"\xff\xf8", 4 + 4 + 34)
    data[first_frame + (2 if where == "header" else 40)] ^= 0x10
    with pytest.raises(ValueError, match="CRC"):
        flacio.decode_flac(bytes(data))


def test_float_files_read_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((2, 9000)) * 0.3).clip(-1, 1).astype(np.float32)
    for bps in (16, 24):
        flacio.write_flac(tmp_path / "port.flac", wav, 8000, bits_per_sample=bps)
        jflac.write_flac(tmp_path / "jax.flac", wav, 8000, bits_per_sample=bps)
        assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
        got, sr = flacio.read_flac(tmp_path / "port.flac")
        want, _ = jflac.read_flac(tmp_path / "port.flac")
        assert sr == 8000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_unknown_length_and_truncated_streams():
    x = _pcm(2, 9000, 16, seed=5)
    data = bytearray(flacio.encode_flac(x, 8000, 16))
    packed = int.from_bytes(data[18:26], "big") & ~((1 << 36) - 1)  # total samples 0
    unknown = bytes(data[:18]) + packed.to_bytes(8, "big") + bytes(data[26:])
    np.testing.assert_array_equal(flacio.decode_flac(unknown)[0], x)
    with pytest.raises(ValueError, match="truncated"):
        flacio.decode_flac(bytes(data[: len(data) // 2]))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp(.|\n)*error"):
        native.build("broken")
    assert not list((tmp_path / "build").glob("*.so"))  # no partial library left behind


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    (tmp_path / "one.cpp").write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build("one"))
        except RuntimeError as err:  # recorded and asserted below
            errors.append(err)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and list((tmp_path / "build").glob("*")) == [paths[0]]
    edited = tmp_path / "one.cpp"
    edited.write_text('extern "C" int one() { return 2; }\n')
    assert native.library_path("one") != paths[0]  # an edited source is built anew
