"""The training side of the port's kernels, on the CPU: K3's hashed dropout
(the plain version, which a CPU tensor takes) against the JAX package's
Pallas kernel in interpret mode with the same seed; K3's backward formula
(``flash_mha_bwd_plain``, the plain twin of ``csrc/flash_mha_bwd.cu``)
against autograd through the plain forward with the same dropout pattern,
and at dropout 0 against ``jax.grad`` of the JAX package's dense attention;
the adjoint formulas of K1 and K2 (``stft_dft_backward``,
``istft_dft_backward``) against autograd through their plain versions.

The same on bf16 inputs (K3's bf16 route, which training in bf16 takes): the
dropout against the Pallas kernel on bf16 inputs, its drop pattern read out
bit for bit through one-hot values, the backward formula against autograd
through the plain bf16 forward and against ``jax.grad`` on bf16 inputs, and
a model of the bf16 backward kernel's arithmetic (bf16 products of P Z and
dS, fp32 sums, bf16 out) against the formula, also with dQ summed over the
blocks of keys in any order (the kernel's blocks add theirs as they finish);
the keys per block of the bf16 backward (``bwd_keys``).

Tolerances: the keep-mask is bit-equal (uint32 hash); the forward atol 2e-5,
rtol 1e-4 (test_torch_attention.py's, fp32 sums in another order); the
gradients 1e-5 x each gradient's peak against autograd of the same plain
forward (the same products, written out) and 2e-5 x peak against JAX
(another framework's fp32 softmax and products); the STFT adjoints 1e-5 x
peak (fp32 sums of 512 terms in another order). bf16: the forward 2^-6 abs
+ 2^-6 rel (the bf16 route's tolerance, test_torch_attention.py's
``BF16_FLASH``: the plain version rounds P to bf16 where the Pallas kernel
keeps it fp32), the gradients 2^-6 x each gradient's peak (bf16 outputs,
2^-9 relative, and P, Z P and dS rounded to bf16 at different points on
each side).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.ops.attention import multihead_attention as jax_mha
from demucs_tpu.ops.pallas.attention import _uniform_hash
from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu.ops.sparse import get_mask
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.kernels import stft as KS
from demucs_tpu_torch.ops.attention import apply_dropout, dropout_keep

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
BF16_GRAD_RTOL = 2 ** -6
BF16 = torch.bfloat16


def _qkv(B, Tq, Tk, C, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Tq, C), (B, Tk, C), (B, Tk, C), (B, Tq, C)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_dropout_keep_is_the_pallas_hash():
    """The keep-mask's counters through JAX's own _uniform_hash, bit for bit."""
    BH, Tq, Tk, rate, seed = 3, 37, 50, 0.3, 2**31 - 5
    rows = jnp.arange(Tq, dtype=jnp.uint32)[:, None]
    cols = jnp.arange(Tk, dtype=jnp.uint32)[None, :]
    want = []
    for bh in range(BH):
        ctr = rows * jnp.uint32(0x9E3779B1) ^ cols * jnp.uint32(0x85EBCA77)
        ctr ^= jnp.uint32(seed) + jnp.uint32(bh) * jnp.uint32(0x27D4EB2F)
        want.append(np.asarray(_uniform_hash(ctr) >= rate))
    got = dropout_keep(BH, Tq, Tk, rate, seed).numpy()
    np.testing.assert_array_equal(got, np.stack(want))
    assert 0.6 < got.mean() < 0.8


@pytest.mark.parametrize("B,Tq,Tk,C,H,rate,masked", [
    (2, 130, 130, 64, 4, 0.1, False),
    (1, 140, 90, 128, 8, 0.25, True),
    (1, 70, 90, 96, 2, 0.5, False),   # head dim 48
])
def test_hashed_dropout_matches_pallas(B, Tq, Tk, C, H, rate, masked):
    q, k, v, _ = _qkv(B, Tq, Tk, C, 0)
    seed = 1234567
    mask = (np.asarray(get_mask(Tk, Tq, "diag", 20, 5, 42, 0.9)) if masked else None)
    want = np.asarray(jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                                    mask=None if mask is None else jnp.asarray(mask),
                                    dropout=rate, dropout_seed=jnp.int32(seed), block_q=64,
                                    block_k=64, interpret=True))
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    got = K.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                      mask=tm, dropout=rate, dropout_seed=seed).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    undropped = K.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                            mask=tm).numpy()
    assert np.abs(got - undropped).max() > 0.05  # the drop is there


@pytest.mark.parametrize("rate,masked", [(0.0, False), (0.0, True), (0.2, False), (0.2, True)])
def test_backward_formula_matches_autograd(rate, masked):
    B, Tq, Tk, C, H = 2, 70, 90, 64, 2
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(B, Tq, Tk, C, 1))
    mask = torch.rand(Tq, Tk, generator=torch.Generator().manual_seed(0)) > 0.3 if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.flash_mha(*leaves, H, mask=mask, dropout=rate, dropout_seed=99)
    want = torch.autograd.grad(out, leaves, do)
    got = K.flash_mha_bwd_plain(q, k, v, out.detach(), do, H, mask=mask, dropout=rate,
                                dropout_seed=99)
    before = K.flash_mha_bwd.launches
    wrapped = K.flash_mha_bwd(q, k, v, out.detach(), do, H, lse=None, mask=mask, dropout=rate,
                              dropout_seed=99)
    assert K.flash_mha_bwd.launches == before  # a CPU tensor launches nothing
    for g, w, x in zip(got, want, wrapped):
        assert _rel(g, w) < 1e-5
        torch.testing.assert_close(x, g, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_grad(masked):
    """At dropout 0 the gradients are those of the JAX package's dense attention."""
    B, Tq, Tk, C, H = 1, 96, 80, 128, 4
    q, k, v, do = _qkv(B, Tq, Tk, C, 2)
    mask = np.asarray(get_mask(Tk, Tq, "diag", 10, 4, 42, 0.9)) if masked else None

    def f(q, k, v):
        out = jax_mha(q, k, v, H, mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    out = K.flash_mha(*t, H, mask=tm)
    got = K.flash_mha_bwd_plain(*t, out, torch.from_numpy(do), H, mask=tm)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 2e-5


def test_training_contract_on_cpu():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 64, 4))
    with pytest.raises(ValueError, match="dropout_seed"):
        K.flash_mha(q, k, v, 2, dropout=0.1)
    with pytest.raises(ValueError, match="rate"):
        K.flash_mha(q, k, v, 2, dropout=1.0, dropout_seed=1)
    a = K.flash_mha(q, k, v, 2, dropout=0.1, dropout_seed=5)
    b = K.flash_mha(q, k, v, 2, dropout=0.1, dropout_seed=5)
    c = K.flash_mha(q, k, v, 2, dropout=0.1, dropout_seed=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    x = torch.ones(4000)
    assert apply_dropout(x, 0.1, None) is x and apply_dropout(x, 0.0, torch.Generator()) is x
    y = apply_dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert set(np.unique(y.numpy())) <= {np.float32(0.0), np.float32(1 / 0.75)}
    assert 0.2 < (y == 0).float().mean() < 0.3
    z = apply_dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, z, rtol=0, atol=0)


def _bf16(*arrays):
    """numpy fp32 -> (torch bf16, jax bf16) of the same values."""
    ts = [torch.from_numpy(a).to(BF16) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]


@pytest.mark.parametrize("B,Tq,Tk,C,H,rate,masked", [
    (2, 130, 130, 64, 4, 0.1, False),
    (1, 140, 90, 128, 8, 0.25, True),
    (1, 70, 90, 96, 2, 0.5, False),   # head dim 48
])
def test_bf16_hashed_dropout_matches_pallas(B, Tq, Tk, C, H, rate, masked):
    """bf16 inputs: the plain version's dropout against the Pallas kernel's,
    which keeps q's dtype in its output (attention.py:184)."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, Tq, Tk, C, 0)[:3])
    seed = 7654321
    mask = (np.asarray(get_mask(Tk, Tq, "diag", 20, 5, 42, 0.9)) if masked else None)
    want = jax_flash_mha(jq, jk, jv, H, mask=None if mask is None else jnp.asarray(mask),
                         dropout=rate, dropout_seed=jnp.int32(seed), block_q=64, block_k=64,
                         interpret=True)
    assert want.dtype == jnp.bfloat16
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    got = K.flash_mha(q, k, v, H, mask=tm, dropout=rate, dropout_seed=seed)
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
    undropped = K.flash_mha(q, k, v, H, mask=tm)
    assert (got.float() - undropped.float()).abs().max() > 0.05  # the drop is there


@pytest.mark.parametrize("B,Tq,Tk,H,d", [(2, 150, 64, 2, 64), (1, 90, 48, 3, 48),
                                         (2, 70, 32, 2, 32)])
def test_bf16_drop_pattern_is_the_pallas_one(B, Tq, Tk, H, d):
    """With one-hot values (key j of each head writes channel j alone) the
    output is P Z itself: it is zero exactly where a score was dropped, on
    the port's bf16 route as in the Pallas kernel on bf16 inputs, and there
    as dropout_keep says."""
    rng = np.random.default_rng(3)
    qk = [0.3 * rng.standard_normal((B, T, H * d)).astype(np.float32) for T in (Tq, Tk)]
    onehot = np.zeros((B, Tk, H * d), np.float32)
    for h in range(H):
        onehot[:, np.arange(Tk), h * d + np.arange(Tk)] = 1.0
    (q, k, v), (jq, jk, jv) = _bf16(*qk, onehot)
    rate, seed = 0.3, 2**31 - 11
    got = K.flash_mha(q, k, v, H, dropout=rate, dropout_seed=seed).float().numpy()
    want = np.asarray(jax_flash_mha(jq, jk, jv, H, dropout=rate, dropout_seed=jnp.int32(seed),
                                    block_q=64, block_k=64, interpret=True).astype(jnp.float32))
    dropped = got.reshape(B, Tq, H, d)[..., :Tk] == 0
    np.testing.assert_array_equal(dropped, want.reshape(B, Tq, H, d)[..., :Tk] == 0)
    keep = dropout_keep(B * H, Tq, Tk, rate, seed).numpy().reshape(B, H, Tq, Tk)
    np.testing.assert_array_equal(dropped, ~keep.transpose(0, 2, 1, 3))
    assert 0.2 < dropped.mean() < 0.4


def _bwd_bf16_model(q, k, v, o, do, H, mask, rate, seed, key_order=None, tile_orders=None,
                    keys=128):
    """The bf16 backward kernel's arithmetic (csrc/flash_mha_bwd.cu with T =
    bf16): S from the bf16 q and k in fp32, P = 2^(S log2(e)/sqrt(d) - lse)
    from the forward's base-2 log-sum-exp, D = dO . o, dS = P (Z dO V^T - D)
    in fp32, then Z P and dS rounded to bf16 for the products with dO, Q and
    K (fp32 sums), the gradients out in bf16. ``key_order``: the blocks of
    ``keys`` keys whose dQ parts (each scaled by 1/sqrt(d)) are added in fp32
    in that order, as the kernel's blocks add theirs in whatever order they
    finish; ``tile_orders``: per query tile of 64 rows its own order of the
    blocks, from zero (the deterministic order, ``K.bwd_order``); None: one
    product over all keys."""
    B, Tq, C = q.shape
    d = C // H
    split = lambda t: t.float().reshape(B, -1, H, d).permute(0, 2, 1, 3)  # noqa: E731
    qh, kh, vh, oh, dh = (split(t) for t in (q, k, v, o, do))
    s = (qh @ kh.transpose(-1, -2)) * K.q_scale(d)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s * math.log(2), -1, keepdim=True) / math.log(2)
    p = torch.exp2(s - lse)
    z = (torch.ones_like(p) if rate == 0 else
         dropout_keep(B * H, Tq, k.shape[1], rate, seed).view(p.shape).float() / (1 - rate))
    ds = p * ((dh @ vh.transpose(-1, -2)) * z - (dh * oh).sum(-1, keepdim=True))
    r = lambda t: t.to(BF16).float()  # noqa: E731
    merge = lambda t: t.permute(0, 2, 1, 3).reshape(B, -1, C).to(BF16)  # noqa: E731
    if tile_orders is not None:
        dq = torch.zeros_like(qh)
        for t, blocks in enumerate(tile_orders):
            rows = slice(64 * t, 64 * (t + 1))
            for blk in blocks:
                cols = slice(keys * blk, keys * (blk + 1))
                dq[..., rows, :] += (r(ds)[..., rows, cols] @ kh[..., cols, :]) / math.sqrt(d)
    elif key_order is None:
        dq = r(ds) @ kh / math.sqrt(d)
    else:
        dq = torch.zeros_like(qh)
        for blk in key_order:
            cols = slice(keys * blk, keys * (blk + 1))
            dq = dq + (r(ds)[..., cols] @ kh[..., cols, :]) / math.sqrt(d)
    return (merge(dq), merge(r(ds).transpose(-1, -2) @ qh / math.sqrt(d)),
            merge(r(p * z).transpose(-1, -2) @ dh))


@pytest.mark.parametrize("rate,masked", [(0.0, False), (0.0, True), (0.2, False), (0.2, True)])
def test_bf16_backward_formula_matches_autograd(rate, masked):
    """The backward formula on bf16 inputs (it computes in fp32, returns bf16)
    against autograd through the plain bf16 forward with the same drop, and
    the bf16 kernel's arithmetic against the formula."""
    B, Tq, Tk, C, H = 2, 70, 90, 64, 2
    q, k, v, do = (torch.from_numpy(a).to(BF16) for a in _qkv(B, Tq, Tk, C, 1))
    mask = torch.rand(Tq, Tk, generator=torch.Generator().manual_seed(0)) > 0.3 if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.flash_mha(*leaves, H, mask=mask, dropout=rate, dropout_seed=99)
    want = torch.autograd.grad(out, leaves, do)
    got = K.flash_mha_bwd_plain(q, k, v, out.detach(), do, H, mask=mask, dropout=rate,
                                dropout_seed=99)
    before = K.flash_mha_bwd_bf16.launches
    wrapped = K.flash_mha_bwd_bf16(q, k, v, out.detach(), do, H, lse=None, mask=mask,
                                   dropout=rate, dropout_seed=99)
    assert K.flash_mha_bwd_bf16.launches == before  # a CPU tensor launches nothing
    model = _bwd_bf16_model(q, k, v, out.detach(), do, H, mask, rate, 99)
    for g, w, x, m in zip(got, want, wrapped, model):
        assert g.dtype == BF16
        assert _rel(g.float(), w.float()) < BF16_GRAD_RTOL
        assert _rel(m.float(), g.float()) < BF16_GRAD_RTOL
        torch.testing.assert_close(x, g, rtol=0, atol=0)


@pytest.mark.parametrize("order_seed", [0, 1, 2])
def test_bf16_backward_dq_in_any_block_order(order_seed):
    """The kernel's blocks of 128 keys add their parts of dQ in fp32 in the
    order they finish: the model's dQ summed over the blocks in a shuffled
    order stays within the bf16 tolerance of the formula, and within one bf16
    step of the peak (2**-8) of the sum in key order (the card test's bound
    between two launches, tests/test_torch_cuda.py)."""
    B, Tq, Tk, C, H = 1, 70, 700, 64, 2
    q, k, v, do = (torch.from_numpy(a).to(BF16) for a in _qkv(B, Tq, Tk, C, 5))
    out = K.flash_mha(q, k, v, H, dropout=0.1, dropout_seed=3)
    want = K.flash_mha_bwd_plain(q, k, v, out, do, H, dropout=0.1, dropout_seed=3)[0]
    blocks = np.random.default_rng(order_seed).permutation(-(-Tk // 128)).tolist()
    shuffled = _bwd_bf16_model(q, k, v, out, do, H, None, 0.1, 3, key_order=blocks)[0]
    in_order = _bwd_bf16_model(q, k, v, out, do, H, None, 0.1, 3,
                               key_order=sorted(blocks))[0]
    assert _rel(shuffled.float(), want.float()) < BF16_GRAD_RTOL
    assert _rel(shuffled.float(), in_order.float()) <= 2 ** -8


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_backward_model_in_the_deterministic_order_matches_jax(keys, masked):
    """The kernel's arithmetic with dQ summed as the deterministic backward
    sums it (each query tile's parts added in its own order, K.bwd_order:
    staggered walks, ties by block) against the gradients of the JAX
    package's dense attention on the same bf16 inputs, within the bf16
    tolerance; the order differs from key order on most tiles, and the sums
    stay within one bf16 step of dQ's peak (2**-8) of key order's."""
    B, Tq, Tk, C, H = 1, 300, 700, 128, 2
    q, k, v, do = _qkv(B, Tq, Tk, C, 7)
    mask = np.asarray(get_mask(Tk, Tq, "diag", 10, 4, 42, 0.9)) if masked else None
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _bf16(q, k, v, do)

    def f(q, k, v):
        out = jax_mha(q, k, v, H, mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    out = K.flash_mha(tq, tk, tv, H, mask=tm)
    n_qt, n_kb = -(-Tq // 64), -(-Tk // keys)
    orders = K.bwd_order(n_qt, n_kb)
    assert sum(blocks != sorted(blocks) for blocks in orders) >= n_qt - 1
    got = _bwd_bf16_model(tq, tk, tv, out, tdo, H, tm, 0.0, 0, tile_orders=orders, keys=keys)
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) < BF16_GRAD_RTOL
    in_order = _bwd_bf16_model(tq, tk, tv, out, tdo, H, tm, 0.0, 0,
                               key_order=list(range(n_kb)), keys=keys)[0]
    assert _rel(got[0].float(), in_order.float()) <= 2 ** -8


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_backward_matches_jax_grad(masked):
    """At dropout 0, on bf16 inputs, the gradients of the JAX package's dense
    attention in bf16."""
    B, Tq, Tk, C, H = 1, 96, 80, 128, 4
    q, k, v, do = _qkv(B, Tq, Tk, C, 2)
    mask = np.asarray(get_mask(Tk, Tq, "diag", 10, 4, 42, 0.9)) if masked else None
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _bf16(q, k, v, do)

    def f(q, k, v):
        out = jax_mha(q, k, v, H, mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    out = K.flash_mha(tq, tk, tv, H, mask=tm)
    got = K.flash_mha_bwd_plain(tq, tk, tv, out, tdo, H, mask=tm)
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) < BF16_GRAD_RTOL


@pytest.mark.parametrize("n_fft,hop,length", [(512, 128, 4096), (512, 128, 4001),
                                              (1024, 256, 6000)])
def test_stft_backward_formulas(n_fft, hop, length):
    """K1's gradient (K2 on scaled inputs, zero-padded) and K2's (K1 on the
    output gradient, scaled per bin) against autograd through the plain versions."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, length, generator=gen).requires_grad_()
    zr, zi = KS.stft_dft(x, n_fft, hop)  # a CPU tensor: the plain version
    gr, gi = torch.randn(zr.shape, generator=gen), torch.randn(zi.shape, generator=gen)
    (want,) = torch.autograd.grad((zr * gr).sum() + (zi * gi).sum(), x)
    got = KS.stft_dft_backward(gr, gi, n_fft, hop, length)
    assert got.shape == x.shape and _rel(got, want) < 1e-5
    only_re = KS.stft_dft_backward(gr, None, n_fft, hop, length)
    (want_re,) = torch.autograd.grad((KS.stft_dft(x, n_fft, hop)[0] * gr).sum(), x)
    assert _rel(only_re, want_re) < 1e-5

    zr = torch.randn(2, 11, n_fft // 2 + 1, generator=gen).requires_grad_()
    zi = torch.randn(2, 11, n_fft // 2 + 1, generator=gen).requires_grad_()
    y = KS.istft_dft(zr, zi, n_fft, hop)
    g = torch.randn(y.shape, generator=gen)
    want = torch.autograd.grad(y, (zr, zi), g)
    got = KS.istft_dft_backward(g, n_fft, hop)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5
    assert not got[1][..., 0].any() and not got[1][..., -1].any()  # bins K2 ignores


@pytest.mark.parametrize("B,Tk,H,want", [
    (1, 2688, 8, 128),   # freq self, one segment: 168 blocks of 128 keys, 2 waves either way
    (8, 2688, 8, 128),   # the training batch: 11 waves either way, 128 keys the cheaper
    (1, 130, 1, 128),    # under one round of blocks either way
    (1, 2112, 8, 64),    # 136 blocks of 128 keys on 132 SMs, 264 of 64 two an SM
    (8, 1344, 8, 64),    # a half-empty last block of 128 keys per head
])
def test_bwd_keys_plan(monkeypatch, B, Tk, H, want):
    """The bf16 backward's keys per block (kernels/attention.py bwd_keys) on a
    132-SM card, and BWD_KEYS_BF16 fixing it."""
    assert K.bwd_keys(B, Tk, H, 132) == want
    monkeypatch.setattr(K, "BWD_KEYS_BF16", 64)
    assert K.bwd_keys(B, Tk, H, 132) == 64


def test_backward_argtypes_match_the_c_signature(monkeypatch):
    """The backward library's ctypes declaration against csrc/flash_mha_bwd.cu's
    exports (test_torch_build.py's check, for the library it does not load)."""
    from demucs_tpu_torch.kernels import _build
    from test_torch_build import _exported, _FakeLib

    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    K._bwd_lib.cache_clear()
    try:
        K._bwd_lib()
    finally:
        K._bwd_lib.cache_clear()
    exported = _exported((_build.CSRC / "flash_mha_bwd.cu").read_text())
    assert set(fake.functions) == set(exported) == {"flash_mha_bwd_f32", "flash_mha_bwd_bf16",
                                                    "flash_mha_bwd_ordered_plan"}
    for name, kinds in exported.items():
        assert fake.functions[name].argtypes == kinds
        assert fake.functions[name].restype is ctypes.c_int
