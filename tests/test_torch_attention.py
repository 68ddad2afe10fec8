"""Port's attention (the plain version of kernel K3, demucs_tpu_torch.ops.attention
and the K3 wrapper on a CPU tensor) against demucs_tpu's multihead_attention
and its Pallas flash_mha (interpret mode), on the cases of
test_pallas_attention.py: aligned, ragged self, ragged cross, the static
sparse masks, and a fully masked first key block. Then a model of the CUDA
kernel's arithmetic (``_k3_model``: the TF32 cut, the three-term split, tiles
of 64 keys, the online softmax in base 2, the key order of P V) against both.

Tolerance: atol 2e-5, rtol 1e-4, the bound the JAX package holds its own
kernel to (fp32 softmax and products summed in another order).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.attention import multihead_attention
from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu.ops.sparse import get_mask
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.ops.attention import multihead_attention as port_mha

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(B, Tq, Tk, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, C)).astype(np.float32),
            rng.standard_normal((B, Tk, C)).astype(np.float32),
            rng.standard_normal((B, Tk, C)).astype(np.float32))


def _both_jax(q, k, v, H, mask=None):
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jm = None if mask is None else jnp.asarray(mask)
    dense = np.asarray(multihead_attention(jq, jk, jv, H, mask=jm))
    flash = np.asarray(jax_flash_mha(jq, jk, jv, H, mask=jm, block_q=128, block_k=128,
                                     interpret=True))
    return dense, flash


def _port(q, k, v, H, mask=None):
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    plain = port_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                     mask=tm).numpy()
    wrapped = K.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          H, mask=tm).numpy()
    np.testing.assert_array_equal(wrapped, plain)  # CPU tensors take the plain version
    return plain


@pytest.mark.parametrize(
    "B,Tq,Tk,C,H",
    [
        (2, 256, 256, 64, 4),     # aligned self
        (1, 300, 300, 64, 4),     # ragged self
        (2, 260, 130, 128, 8),    # ragged cross (Tq != Tk)
        (1, 70, 90, 384, 8),      # head dim 48 (bottom_channels=0 at released width)
    ],
)
def test_attention_matches_jax(B, Tq, Tk, C, H):
    q, k, v = _qkv(B, Tq, Tk, C, 0)
    dense, flash = _both_jax(q, k, v, H)
    got = _port(q, k, v, H)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


@pytest.mark.parametrize("mask_type", ["diag", "jmask", "random", "global"])
def test_attention_masks_match_jax(mask_type):
    q, k, v = _qkv(1, 300, 300, 64, 1)
    mask = np.asarray(get_mask(300, 300, mask_type, sparse_attn_window=50,
                               global_window=20, mask_random_seed=42, sparsity=0.9))
    dense, flash = _both_jax(q, k, v, 4, mask)
    got = _port(q, k, v, 4, mask)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


def test_fully_masked_first_block():
    q, k, v = _qkv(1, 256, 256, 64, 2)
    mask = np.ones((256, 256), bool)
    mask[:, :128] = False
    dense, flash = _both_jax(q, k, v, 4, mask)
    got = _port(q, k, v, 4, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


def test_fully_masked_row_is_nan():
    """A query row with no kept key gives NaN, as the dense softmax does."""
    q, k, v = _qkv(1, 64, 64, 32, 3)
    mask = np.ones((64, 64), bool)
    mask[5] = False
    dense, _ = _both_jax(q, k, v, 1, mask)
    got = _port(q, k, v, 1, mask)
    assert np.isnan(got[0, 5]).all() and np.isnan(dense[0, 5]).all()
    keep = np.ones(64, bool)
    keep[5] = False
    np.testing.assert_allclose(got[0, keep], dense[0, keep], **TOL)


def test_wrapper_contract_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 64, 4))
    before = K.flash_mha.launches
    K.flash_mha(q, k, v, 2)
    K.flash_mha(q, k, v, 2, dropout=0.1, dropout_seed=3)
    assert K.flash_mha.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="dropout_seed"):
        K.flash_mha(q, k, v, 2, dropout=0.1)


# ---- the kernel's arithmetic (csrc/flash_mha.cu), modelled on the CPU ----
# Change this model whenever the kernel changes.

# Within each group of 8 keys of a tile the kernel's P V reads keys in this
# order: k-position c is key 2c, k-position c + 4 is key 2c + 1.
_KEY_ORDER = (torch.arange(K.KEY_TILE // 8)[:, None] * 8
              + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])).flatten()


def _tf32(x):
    """The TF32 value the kernel gives the tensor core: the fp32 word with its
    low 13 bits cleared (the hardware's own cut of a lo part is modelled the
    same way)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _product(a, b, lo):
    """a @ b as the kernel's wgmma passes: hi.lo, then lo.hi, then hi.hi into
    one fp32 accumulator (3xTF32); with ``lo=False`` only hi.hi (1xTF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if not lo:
        return ah @ bh
    return (ah @ _tf32(b - bh) + _tf32(a - ah) @ bh) + ah @ bh


def _k3_model(q, k, v, num_heads, mask=None, lo=True):
    """K3 as the kernel computes it, head by head: q scaled by log2(e)/sqrt(d)
    in fp32, tiles of 64 keys (zero past Tk), S by three TF32 products,
    masked scores -inf, the -inf-safe base-2 online softmax, each tile's P V
    by three TF32 products in the kernel's key order into an accumulator of
    its own, added to o as o * alpha + P V, and o / l at the end."""
    B, Tq, C = q.shape
    Tk, d, T = k.shape[1], C // num_heads, K.KEY_TILE
    scale = torch.tensor(K.q_scale(d), dtype=torch.float32)
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(num_heads):
            cols = slice(h * d, (h + 1) * d)
            qs = q[b, :, cols] * scale
            acc = torch.zeros(Tq, d)
            m, l = torch.full((Tq,), -math.inf), torch.zeros(Tq)
            for k0 in range(0, Tk, T):
                kt, vt = (torch.zeros(T, d) for _ in range(2))
                n = min(T, Tk - k0)
                kt[:n], vt[:n] = k[b, k0:k0 + n, cols], v[b, k0:k0 + n, cols]
                s = _product(qs, kt.T, lo)
                keep = torch.arange(T) < n
                if mask is not None:
                    keep = keep & torch.nn.functional.pad(mask[:, k0:k0 + n], (0, T - n))
                s = s.masked_fill(~keep, -math.inf)
                m_new = torch.maximum(m, s.max(-1).values)
                base = torch.where(torch.isneginf(m_new), 0.0, m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + _product(p[:, _KEY_ORDER], vt[_KEY_ORDER], lo)
                m = m_new
            out[b, :, cols] = acc / l[:, None]
    return out


def _dense_jax(q, k, v, H, mask=None):
    jm = None if mask is None else jnp.asarray(mask)
    return np.asarray(multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                                          mask=jm))


@pytest.mark.parametrize(
    "B,Tq,Tk,C,H",
    [
        (1, 2688, 2688, 64, 1),   # one head of the released freq<-freq attention
        (1, 300, 300, 128, 4),    # ragged self, head dim 32
        (2, 260, 130, 256, 4),    # ragged cross (Tq != Tk), head dim 64
        (1, 70, 90, 384, 8),      # head dim 48
    ],
)
def test_kernel_model_matches_plain_and_jax(B, Tq, Tk, C, H):
    q, k, v = _qkv(B, Tq, Tk, C, 5)
    got = _k3_model(*(torch.from_numpy(a) for a in (q, k, v)), H).numpy()
    np.testing.assert_allclose(got, _port(q, k, v, H), **TOL)
    np.testing.assert_allclose(got, _dense_jax(q, k, v, H), **TOL)


@pytest.mark.parametrize("mask_type", ["diag", "jmask", "random", "global", "first_tile_and_row"])
def test_kernel_model_masks_match_plain_and_jax(mask_type):
    q, k, v = _qkv(1, 300, 300, 128, 6)
    if mask_type == "first_tile_and_row":
        mask = np.ones((300, 300), bool)
        mask[:, :K.KEY_TILE] = False  # the first key tile, fully masked for every row
        mask[5] = False  # a row with no kept key: NaN
    else:
        mask = np.asarray(get_mask(300, 300, mask_type, sparse_attn_window=50,
                                   global_window=20, mask_random_seed=42, sparsity=0.9))
    got = _k3_model(*(torch.from_numpy(a) for a in (q, k, v)), 4,
                    mask=torch.from_numpy(mask)).numpy()
    plain, dense = _port(q, k, v, 4, mask), _dense_jax(q, k, v, 4, mask)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    assert np.isnan(got).any() == (mask_type == "first_tile_and_row")
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


def test_kernel_model_without_lo_terms_misses_the_tolerance():
    """One TF32 product per matmul (the lo terms dropped) misses atol 2e-5 at
    the released shape: the tolerance tells 3xTF32 from 1xTF32."""
    q, k, v = _qkv(1, 2688, 2688, 64, 5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = _port(q, k, v, 1)
    err_1x = np.abs(_k3_model(tq, tk, tv, 1, lo=False).numpy() - want).max()
    err_3x = np.abs(_k3_model(tq, tk, tv, 1).numpy() - want).max()
    assert err_1x > TOL["atol"] > 10 * err_3x


# ---- the bf16 route ----
# The plain twin on bf16 inputs follows the JAX package's dense path rounding
# for rounding (q scaled in bf16, fp32 scores and softmax, weights rounded to
# bf16, fp32 P V, output rounded to bf16): it equals JAX's dense
# multihead_attention on the same bf16 inputs up to the fp32 order of the
# sums, which moves a rare output by one bf16 step (BF16_DENSE). The Pallas
# kernel (interpret mode) scales q in fp32 and never rounds P, so it differs
# from both by a few bf16 steps of the output (BF16_FLASH). _k3_bf16_model is
# the CUDA kernel's arithmetic (csrc/flash_mha.cu, flash_mha_bf16_kernel):
# tiles of KEY_TILE_BF16 keys, raw fp32 scores, p = 2^(s scale - m scale) in
# one FFMA (m the raw row max), unnormalized P rounded to bf16 per tile, each
# tile's P V added to o before o is rescaled by the next tile's alpha (the
# kernel's software pipeline), o / l rounded once; each row block in the runs
# of key tiles of the wrapper's plan on a 132-SM card (K.bf16_plan,
# K.bf16_schedule), a block of several runs merged by their scaled maxima as
# the kernel's combine does. It is held to BF16_FLASH against the twin, the tolerance
# tests/test_torch_cuda.py holds the kernel to.

BF16_DENSE = dict(atol=2 ** -8, rtol=0)  # one bf16 step at |out| < 1, on a rare element
BF16_FLASH = dict(atol=2 ** -6, rtol=2 ** -6)  # a few bf16 steps of |out|
SMS = 132  # the H100's SMs, for the schedule


def _bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _jax_bf16(*tensors):
    return [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tensors]


def _ffma(x, scale, base):
    """fp32 fma(x, scale, -base): the product exact in float64, one rounding."""
    return (x.double() * scale - base.double()).float()


def _k3_bf16_run(q, k, v, scale, mask, t0, t1):
    """Key tiles [t0, t1) of one row block: (unnormalized o, scaled max, l)."""
    T = K.KEY_TILE_BF16
    acc, pending = torch.zeros(q.shape[0], v.shape[1]), None
    m, l = torch.full((q.shape[0],), -math.inf), torch.zeros(q.shape[0])
    for k0 in range(t0 * T, min(t1 * T, k.shape[0]), T):
        s = q.float() @ k[k0:k0 + T].float().T
        if mask is not None:
            s = s.masked_fill(~mask[:, k0:k0 + T], -math.inf)
        m_new = torch.maximum(m, s.max(-1).values)
        base = torch.where(torch.isneginf(m_new), 0.0, m_new * scale)
        alpha = torch.exp2(_ffma(m, scale, base))
        p = torch.exp2(_ffma(s, scale, base[:, None]))
        if pending is not None:
            acc = (acc + pending) * alpha[:, None]
        l = l * alpha + p.sum(-1)
        pending = p.bfloat16().float() @ v[k0:k0 + T].float()
        m = m_new
    return acc + pending, torch.where(torch.isneginf(m), -math.inf, m * scale), l


def _k3_bf16_model(q, k, v, num_heads, mask=None, persistent=None):
    """``persistent``: force the schedule (True) or a block per row block
    (False); None takes the wrapper's plan."""
    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    scale = torch.tensor(K.q_scale(d), dtype=torch.float32)
    rows, ctas = K.bf16_plan(B, Tq, Tk, num_heads, SMS)
    n_x, n_tiles = -(-Tq // rows), -(-Tk // K.KEY_TILE_BF16)
    blocks = B * num_heads * n_x
    if persistent is not None:
        ctas = min(SMS, blocks * n_tiles) if persistent else blocks
    runs = K.bf16_schedule(blocks, n_tiles, ctas)
    out = torch.empty(B, Tq, C, dtype=torch.bfloat16)
    for r, block_runs in enumerate(runs):
        x, h, b = r % n_x, r // n_x % num_heads, r // (n_x * num_heads)
        qs, cols = slice(x * rows, (x + 1) * rows), slice(h * d, (h + 1) * d)
        keep = None if mask is None else mask[qs]
        parts = [_k3_bf16_run(q[b, qs, cols], k[b, :, cols], v[b, :, cols], scale, keep, t0, t1)
                 for t0, t1 in block_runs]
        if len(parts) == 1:
            acc, _, l = parts[0]
        else:  # the kernel's combine: weights 2^(M_run - M), base 0 if every M is -inf
            top = torch.stack([pt[1] for pt in parts]).max(0).values
            top = torch.where(torch.isneginf(top), 0.0, top)
            w = [torch.exp2(pt[1] - top) for pt in parts]
            acc = sum(wi[:, None] * pt[0] for wi, pt in zip(w, parts))
            l = sum(wi * pt[2] for wi, pt in zip(w, parts))
        out[b, qs, cols] = (acc / l[:, None]).bfloat16()
    return out


def _first_tile(Tk):
    """Keys of the bf16 route's first tile, fully masked in the masked cases;
    the fp32 route's 64 where the bf16 tile would cover every key."""
    return K.KEY_TILE_BF16 if Tk > K.KEY_TILE_BF16 else K.KEY_TILE


@pytest.mark.parametrize("B,Tq,Tk,C,H,masked", [
    (1, 200, 200, 64, 2, False),   # head dim 32
    (2, 130, 70, 96, 2, True),     # head dim 48, ragged cross, masked
    (1, 300, 300, 128, 2, False),  # head dim 64
    (1, 150, 260, 128, 2, True),   # head dim 64, masked
    (3, 70, 130, 128, 2, False),   # B > 1, Tk not a multiple of the tile: the last tile ragged
    (3, 40, 260, 96, 2, True),     # the same at head dim 48, masked
])
def test_bf16_twin_matches_jax_dense_and_pallas(B, Tq, Tk, C, H, masked):
    q, k, v = _bf16(*_qkv(B, Tq, Tk, C, 11))
    mask = None
    if masked:
        mask = torch.rand(Tq, Tk, generator=torch.Generator().manual_seed(3)) > 0.3
        mask[:, :_first_tile(Tk)] = False  # a fully masked first key tile
    jq, jk, jv = _jax_bf16(q, k, v)
    jm = None if mask is None else jnp.asarray(mask.numpy())
    got = port_mha(q, k, v, H, mask=mask)
    assert got.dtype == torch.bfloat16
    assert torch.equal(K.flash_mha(q, k, v, H, mask=mask), got)  # the wrapper on the CPU
    assert torch.equal(K.flash_mha_bf16(q, k, v, H, mask=mask), got)
    dense = multihead_attention(jq, jk, jv, H, mask=jm)
    flash = jax_flash_mha(jq, jk, jv, H, mask=jm, block_q=128, block_k=128, interpret=True)
    assert dense.dtype == flash.dtype == jnp.bfloat16
    got = got.float().numpy()
    dense, flash = (np.asarray(a.astype(jnp.float32)) for a in (dense, flash))
    assert np.mean(got != dense) < 1e-3
    np.testing.assert_allclose(got, dense, **BF16_DENSE)
    np.testing.assert_allclose(got, flash, **BF16_FLASH)
    model = _k3_bf16_model(q, k, v, H, mask=mask).float().numpy()
    np.testing.assert_allclose(model, got, **BF16_FLASH)
    np.testing.assert_allclose(model, flash, **BF16_FLASH)


def test_bf16_fully_masked_row_is_nan():
    q, k, v = _bf16(*_qkv(1, 64, 64, 64, 12))
    mask = torch.ones(64, 64, dtype=torch.bool)
    mask[5] = False
    got = port_mha(q, k, v, 1, mask=mask)
    model = _k3_bf16_model(q, k, v, 1, mask=mask)
    assert torch.isnan(got[0, 5]).all() and torch.isnan(model[0, 5]).all()
    assert torch.isfinite(got[0, 6:]).all() and torch.isfinite(model[0, 6:]).all()


def test_bf16_model_tells_the_routes_apart():
    """The bf16 route's error against the fp32 twin is bf16's (about 1e-3 at
    the released head), two orders over the fp32 route's 2e-5: a card test
    at BF16_FLASH shows the bf16 kernel ran, and K3's fp32 tolerance would
    refuse it."""
    q, k, v = _qkv(1, 512, 512, 64, 13)
    want = _port(q, k, v, 1)
    got = _k3_bf16_model(*_bf16(q, k, v), 1).float().numpy()
    err = np.abs(got - want).max()
    assert 100 * TOL["atol"] < err < BF16_FLASH["atol"] + BF16_FLASH["rtol"] * np.abs(want).max()


@pytest.mark.parametrize("B,Tq,Tk,C,H,masked", [
    (1, 100, 300, 128, 2, False),  # 3 tiles in 1 row block: one run of one tile per range
    (2, 290, 260, 96, 2, True),    # head dim 48, masked, ragged last tile
    (3, 64, 530, 64, 2, False),    # 6 row blocks of 5 tiles, 30 ranges of one; ragged
])
def test_bf16_model_schedule_matches_plain_grid_and_pallas(B, Tq, Tk, C, H, masked):
    """Row blocks cut into runs of key tiles by the persistent schedule and
    merged by their scaled maxima (the kernel's combine) give the plain
    grid's output (one run per row block) within BF16_FLASH, and the Pallas
    kernel's."""
    q, k, v = _bf16(*_qkv(B, Tq, Tk, C, 14))
    mask = None
    if masked:
        mask = torch.rand(Tq, Tk, generator=torch.Generator().manual_seed(4)) > 0.3
        mask[:, :_first_tile(Tk)] = False
        mask[3] = False  # a row with no kept key: NaN from both
    one = _k3_bf16_model(q, k, v, H, mask=mask, persistent=False).float().numpy()
    split = _k3_bf16_model(q, k, v, H, mask=mask, persistent=True).float().numpy()
    np.testing.assert_array_equal(np.isnan(one), np.isnan(split))
    np.testing.assert_allclose(split, one, **BF16_FLASH)
    jq, jk, jv = _jax_bf16(q, k, v)
    jm = None if mask is None else jnp.asarray(mask.numpy())
    flash = np.asarray(jax_flash_mha(jq, jk, jv, H, mask=jm, block_q=128, block_k=128,
                                     interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(split, flash, **BF16_FLASH)


@pytest.mark.parametrize("blocks,n_tiles,ctas", [
    (672, 21, 132),  # freq<-freq, six segments: 106 or 107 tiles per range
    (88, 11, 132),   # time<-time, one segment: more ranges than row blocks
    (6, 3, 18),      # one tile per range
    (7, 5, 7),       # the plain grid: one row block per range
    (5, 1, 3),       # one tile per row block
])
def test_bf16_schedule_covers_every_tile_once(blocks, n_tiles, ctas):
    """The schedule against a unit-by-unit construction: even shares (the
    longer first), each row block's tiles grouped by the range that owns them."""
    units = blocks * n_tiles
    share = [units // ctas + (c < units % ctas) for c in range(ctas)]
    owner = np.repeat(np.arange(ctas), share)
    want = [[] for _ in range(blocks)]
    for u in range(units):
        r, t = divmod(u, n_tiles)
        if t > 0 and owner[u] == owner[u - 1]:
            want[r][-1] = (want[r][-1][0], t + 1)
        else:
            want[r].append((t, t + 1))
    assert K.bf16_schedule(blocks, n_tiles, ctas) == want


@pytest.mark.parametrize("B,Tq,Tk,rows_set,persistent,want", [
    # the released shapes (freq 2688, time 1344 tokens) at one segment and at
    # six: the plan that was the fastest of chip_smoke.py's sweep on the H100
    (1, 2688, 2688, None, None, (192, 112)),  # freq<-freq: 112 row blocks, the plain grid
    (1, 1344, 1344, None, None, (128, 88)),   # time<-time: 56 of 192 rows would leave 76 SMs idle
    (1, 2688, 1344, None, None, (192, 112)),  # freq<-time: 11 key tiles, too few to split
    (1, 1344, 2688, None, None, (128, 132)),  # time<-freq: 21 key tiles, split over every SM
    (6, 2688, 2688, None, None, (192, 132)),  # the served batch: persistent
    (6, 1344, 1344, None, None, (128, 132)),  # 528 row blocks of 128, 4 whole ones per SM
    (6, 2688, 1344, None, None, (192, 132)),
    (6, 1344, 2688, None, None, (192, 132)),
    (6, 2688, 2688, None, False, (192, 672)),  # forced: a block per row block
    (1, 2688, 2688, None, True, (192, 132)),   # forced: persistent
    (1, 64, 100, None, True, (128, 8)),        # 8 units: a block each
    (6, 2688, 2688, 128, None, (128, 132)),    # forced rows
])
def test_bf16_plan(monkeypatch, B, Tq, Tk, rows_set, persistent, want):
    """Rows per block and blocks in the grid of the bf16 route on a 132-SM
    card (8 heads, 128-key tiles)."""
    monkeypatch.setattr(K, "KEY_TILE_BF16", 128)
    monkeypatch.setattr(K, "BF16_ROWS", rows_set)
    monkeypatch.setattr(K, "BF16_PERSISTENT", persistent)
    assert K.bf16_plan(B, Tq, Tk, 8, SMS) == want
