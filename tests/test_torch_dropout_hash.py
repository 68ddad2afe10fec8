"""K3's hashed dropout in the hoisted form the kernels compute it
(``csrc/attention_dropout.cuh``; the bf16 route's ``drop_tile`` in
``csrc/flash_mha.cu``), on the CPU: a numpy int64 model of the keep test
split into a row term and a column term (the counter's XOR and the
finalizer's first ``x ^= x >> 16`` are linear over GF(2)), the column term
formed once a key, the compare ``x >= t << 8``, against the decisions of
the JAX package's ``_uniform_hash`` as ``_attn_kernel`` forms them and
against ``ops/attention.py::dropout_keep``; the plain twin of the bf16
kernel's per-lane drop (``kernels/attention.py::bf16_drop_tile``) mapped
back to ``dropout_keep``'s mask; the integer compare against the float one
at the threshold. All bit-exact (uint32 arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.pallas.attention import _uniform_hash
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.ops.attention import dropout_keep

M32 = 0xFFFFFFFF
ROW_MUL, KEY_MUL, BH_MUL = 0x9E3779B1, 0x85EBCA77, 0x27D4EB2F
BELOW_ONE = float(np.nextafter(np.float32(1), np.float32(0)))  # the largest float32 below 1
RATES = (1e-6, 0.1, 0.5, BELOW_ONE)


def _mul(x, const):
    """x * const mod 2**32 for int64 x in [0, 2**32), without overflowing int64."""
    return (x * (const & 0xFFFF) + ((x * (const >> 16)) & 0xFFFF) * 65536) & M32


def _threshold(rate):
    """Dropout::make's t = ceil(rate 2^24), the rate rounded to float32 first."""
    return int(np.ceil(np.float32(rate) * np.float32(2 ** 24)))


def hoisted_dropped(rows, keys, bh, rate, seed):
    """The kernels' keep test, broadcast over int64 ``rows`` and ``keys``:
    True where the score is dropped."""
    rows, keys = np.asarray(rows, np.int64), np.asarray(keys, np.int64)
    salt = (seed + bh * BH_MUL) & M32
    r = _mul(rows, ROW_MUL) ^ salt
    row_term = r ^ (r >> 16)
    k = _mul(keys, KEY_MUL)
    col_term = k ^ (k >> 16)
    x = row_term ^ col_term
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < (_threshold(rate) << 8)


def pallas_dropped(rows, keys, bh, rate, seed):
    """_attn_kernel's decision for the same scores: the counter in uint32,
    _uniform_hash, the float compare with the rate."""
    r = jnp.asarray(np.asarray(rows, np.int64).astype(np.uint32))
    k = jnp.asarray(np.asarray(keys, np.int64).astype(np.uint32))
    ctr = r * jnp.uint32(ROW_MUL) ^ k * jnp.uint32(KEY_MUL)
    ctr ^= jnp.uint32(seed) + jnp.uint32(bh) * jnp.uint32(BH_MUL)
    return ~np.asarray(_uniform_hash(ctr) >= rate)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed,bh", [(0, 0), (2 ** 32 - 1, 63), (123456789, 17)])
def test_hoisted_keep_test_is_the_pallas_hash(seed, bh, rate):
    """Rows and keys 0..2688 (every released sequence), bit for bit."""
    idx = np.arange(2689, dtype=np.int64)
    rows, keys = idx[:, None], idx[None, :]
    got = hoisted_dropped(rows, keys, bh, rate, seed)
    np.testing.assert_array_equal(got, pallas_dropped(rows, keys, bh, rate, seed))
    if rate < 0.9:
        assert abs(got.mean() - rate) < 0.01 + 5 * rate


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_hoisted_keep_test_at_large_indices(seed, rate):
    """Rows and keys near 2^31 (the kernel's int rows and keys) and past the
    first wraps of r * 0x9E3779B1 and j * 0x85EBCA77 (2^32 / 0x9E3779B1 < 2):
    every index where the products wrap is covered by the same uint32 sums."""
    near = np.concatenate([np.arange(0, 8), 2 ** 31 - 1 - np.arange(200),
                           2 ** 30 + np.arange(100)]).astype(np.int64)
    for bh in (0, 1, 63):
        rows, keys = near[:, None], near[None, :]
        np.testing.assert_array_equal(hoisted_dropped(rows, keys, bh, rate, seed),
                                      pallas_dropped(rows, keys, bh, rate, seed))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed,bh", [(0, 63), (2 ** 32 - 1, 5)])
def test_hoisted_keep_test_is_dropout_keep(seed, bh, rate):
    """ops/attention.py::dropout_keep (the plain version's mask) on the rows
    0..129 and keys 0..2688 of batch-head bh."""
    Tq, Tk = 130, 2689
    keep = dropout_keep(bh + 1, Tq, Tk, rate, seed)[bh].numpy()
    rows, keys = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    np.testing.assert_array_equal(hoisted_dropped(rows, keys, bh, rate, seed), ~keep)


def test_threshold_stays_below_2_24():
    """t < 2^24 for every rate below 1, so t << 8 and (x >> 8) - t's sign are
    exact; a rate of 1 would make t = 2^24, which every entry refuses."""
    assert _threshold(BELOW_ONE) == 2 ** 24 - 1
    assert _threshold(1e-6) == 17 and _threshold(0.5) == 2 ** 23
    assert _threshold(1.0) == 2 ** 24


@pytest.mark.parametrize("route", ["fp32", "bf16"])
@pytest.mark.parametrize("rate", [1.0, 1.5, float("nan")])
def test_rate_one_is_refused(route, rate):
    dtype = torch.float32 if route == "fp32" else torch.bfloat16
    q = torch.zeros(1, 4, 64, dtype=dtype)
    call = K.flash_mha if route == "fp32" else K.flash_mha_bf16
    with pytest.raises(ValueError, match="dropout rate"):
        call(q, q, q, 1, dropout=rate, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout rate"):
        K.bf16_drop_tile(0, 0, 0, rate, 1)


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("bh,row0,k0,rate,seed", [
    (0, 0, 0, 0.1, 0), (63, 128, 256, 0.1, 2 ** 32 - 1), (0, 2560, 2560, 0.1, 9),
    (5, 64, 128, 0.5, 77), (17, 1344, 1280, 1e-6, 3), (2, 192, 2560, BELOW_ONE, 12345)])
def test_bf16_drop_tile_maps_to_dropout_keep(key_tile, bh, row0, k0, rate, seed):
    """The twin's decisions, element e of lane (g, c) of warp w at row row0 +
    16 w + g + 8 ((e >> 1) & 1), key k0 + 8 (e >> 2) + 2c + (e & 1), read back
    into dropout_keep's mask of the warpgroup's tile: every score of the tile
    once, bit for bit."""
    dropped = K.bf16_drop_tile(bh, row0, k0, rate, seed, key_tile)
    assert dropped.shape == (4, 32, key_tile // 2) and dropped.dtype == torch.bool
    e = torch.arange(key_tile // 2)
    w = torch.arange(4)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    g, c = lane // 4, lane % 4
    rows = (row0 + 16 * w + g + 8 * ((e >> 1) & 1)).expand_as(dropped)
    keys = (k0 + 8 * (e >> 2) + 2 * c + (e & 1)).expand_as(dropped)
    seen = torch.zeros(row0 + 64, k0 + key_tile, dtype=torch.int64)
    seen.index_put_((rows.reshape(-1), keys.reshape(-1)),
                    torch.ones(rows.numel(), dtype=torch.int64), accumulate=True)
    assert bool((seen[row0:, k0:] == 1).all())
    grid = torch.zeros(row0 + 64, k0 + key_tile, dtype=torch.bool)
    grid[rows, keys] = dropped
    keep = dropout_keep(bh + 1, row0 + 64, k0 + key_tile, rate, seed)[bh]
    assert torch.equal(grid[row0:, k0:], ~keep[row0:, k0:])
    np.testing.assert_array_equal(dropped.numpy(),
                                  hoisted_dropped(rows.numpy(), keys.numpy(), bh, rate, seed))


@pytest.mark.parametrize("rate", RATES + (0.25, 0.3, 1 / 3))
def test_compare_against_the_limit_is_the_float_compare(rate):
    """x >= t << 8 (Dropout::kept) against _uniform_hash's float compare,
    (x >> 8) * 2^-24 >= rate in float32, at every x around the threshold."""
    t = _threshold(rate)
    x = np.concatenate([np.arange(max(0, (t << 8) - 1024), min(2 ** 32, (t << 8) + 1024)),
                        [0, 255, 256, 2 ** 32 - 1]]).astype(np.int64)
    want = (x >> 8).astype(np.float32) * np.float32(2.0 ** -24) >= np.float32(rate)
    np.testing.assert_array_equal(x >= (t << 8), want)

