"""K3's backward under a static keep-mask as its masked instances read it
(csrc/flash_mha_bwd.cuh, flash_mha_bwd_masked.cu): the backward's tile map of
each plan (per key block the query tiles that keep a score, full or partial,
the entry its staggered walk starts at, each unit's turn in the
deterministic order), the mask packed into bits in the order of the
transposed scores' lanes, the masked deterministic order, and a tiled model
of the masked backward (listed units only, bits only on partial units, dQ's
parts added in that order) against ``jax.grad`` of the JAX package's dense
attention under the mask and against ``flash_mha_bwd_plain``; the wrappers'
side (MaskTiles builds it all at construction, the launch's arguments, the
autograd node carrying the forward's tiles) and the build of the sources.

Tolerance of the model: 2e-5 x each gradient's peak against both (fp32
products and sums in another order, as tests/test_torch_attention_train.py
against JAX). A fully masked row's gradients are zero in the kernels; both
references take it unmasked with dO = 0 there, which adds nothing.
"""

import ctypes
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.ops.attention import multihead_attention as jax_mha
from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.ops import sparse as tsp

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

MASKS = ("diag", "global", "jmask", "random", "diag_jmask_random")
RELEASED = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))  # (Tq, Tk)
DEFAULTS = dict(sparse_attn_window=500, global_window=100, mask_random_seed=42, sparsity=0.95)
GRAD_RTOL = 2e-5


def _static(mask_type, Tq, Tk, **options):
    opts = dict(DEFAULTS, **options)
    return tsp.get_mask(Tk, Tq, mask_type, opts["sparse_attn_window"], opts["global_window"],
                        opts["mask_random_seed"], opts["sparsity"])


def _holes(Tq, Tk):
    """Kept at random, with an empty key block of every plan (keys 128-255),
    empty query tiles (queries 64-191) and a fully masked row (7)."""
    mask = np.random.default_rng(6).random((Tq, Tk)) > 0.4
    mask[:, 128:256] = False
    mask[64:192] = False
    mask[min(7, Tq - 1)] = False
    return mask


def _small(name, Tq, Tk):
    return (_holes(Tq, Tk) if name == "holes"
            else _static(name, Tq, Tk, sparse_attn_window=20, global_window=9, sparsity=0.9))


RAGGED = {f"{name} {Tq}x{Tk}": _small(name, Tq, Tk)
          for Tq, Tk in ((300, 260), (130, 333), (64, 200), (1, 5))
          for name in MASKS + ("holes",)}


def _brute_classes(mask, keys, qt):
    """(n_kb, n_qt): 0 empty, 2 full (every score of its queries kept, the
    block inside Tk), 1 partial."""
    Tq, Tk = mask.shape
    n_kb, n_qt = -(-Tk // keys), -(-Tq // qt)
    want = np.zeros((n_kb, n_qt), np.int8)
    for x in range(n_kb):
        for t in range(n_qt):
            sub = mask[t * qt:(t + 1) * qt, x * keys:(x + 1) * keys]
            if sub.any():
                want[x, t] = 2 if sub.all() and (x + 1) * keys <= Tk else 1
    return want


def _check_bwd_map(mask, keys, qt):
    tm = K.bwd_tile_map(mask, keys, qt)
    classes = tm["classes"]
    np.testing.assert_array_equal(classes, _brute_classes(mask, keys, qt))
    n_kb, n_qt = classes.shape
    # the list: exactly the non-empty units, key block by key block in tile order
    want = [(x, t, int(classes[x, t] == 1)) for x in range(n_kb) for t in range(n_qt)
            if classes[x, t]]
    off, ent = tm["off"], tm["ent"]
    got = [(x, int(e) >> 1, int(e) & 1) for x in range(n_kb) for e in ent[off[x]:off[x + 1]]]
    assert got == want
    assert tm["counts"] == tuple(int(c) for c in (classes > 0).sum(1))
    # the walks: the list rotated at rot is the staggered walk restricted to it
    for x in range(n_kb):
        tiles = [int(e) >> 1 for e in ent[off[x]:off[x + 1]]]
        n, r = len(tiles), int(tm["rot"][x])
        assert (r == 0 if n == 0 else 0 <= r < n)
        assert [tiles[(k + r) % n] for k in range(n)] == K.bwd_walk_masked(x, classes, True)
        assert tiles == K.bwd_walk_masked(x, classes, False)
    # the turns: each unit's place among the blocks that visit its tile
    for turn, stagger in ((tm["turn_s"], True), (tm["turn_p"], False)):
        order = K.bwd_order_masked(classes, stagger)
        for (x, t, _), place in zip(want, turn):
            assert order[t][place] == x
    flat = tm["map"]
    nnz = len(ent)
    assert flat.dtype == np.int32 and list(flat[:2]) == [nnz, n_kb]
    np.testing.assert_array_equal(flat[2:3 + n_kb], off)
    rest = flat[3 + n_kb:]
    for part in (ent, tm["rot"], tm["turn_s"], tm["turn_p"]):
        np.testing.assert_array_equal(rest[:len(part)], part)
        rest = rest[len(part):]
    assert len(rest) == 0
    return tm


@pytest.mark.parametrize("keys,qt", K.BWD_PLANS)
@pytest.mark.parametrize("mask_type", MASKS)
@pytest.mark.parametrize("Tq,Tk", RELEASED)
def test_bwd_tile_map_of_released_masks(mask_type, Tq, Tk, keys, qt):
    """Every static mask at the reference's defaults and the released
    shapes, every backward plan: the classes against a unit-by-unit reading
    of the mask, the list exactly the non-empty units, the walks and the
    turns those of the masked order."""
    _check_bwd_map(_static(mask_type, Tq, Tk), keys, qt)


@pytest.mark.parametrize("keys,qt", K.BWD_PLANS)
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_bwd_tile_map_of_ragged_masks(name, keys, qt):
    """Tq and Tk not whole tiles or blocks, and the holes (an empty key
    block, empty query tiles, a fully masked row): the last key block of a
    ragged Tk is never full, queries past Tq count neither way."""
    mask = RAGGED[name]
    tm = _check_bwd_map(mask, keys, qt)
    if mask.shape[1] % keys:
        assert (tm["classes"][-1] != 2).all()
    if name.startswith("holes") and mask.shape[1] > 256:
        assert tm["counts"][128 // keys] == 0  # an empty key block: no unit at all


@pytest.mark.parametrize("qt", (32, 64))
@pytest.mark.parametrize("name", sorted(RAGGED) + [f"{m} released" for m in MASKS])
def test_bwd_bits_unpack_by_lane(name, qt):
    """The bits unpacked as the lanes of each key block read them give back
    the transposed mask, 0 past Tq and past Tk; and they are pack_mask_bits
    of the transposed mask, shifted to the query tile's part of its word."""
    mask = RAGGED[name] if name in RAGGED else _static(name.split()[0], 2688, 1344)
    Tq, Tk = mask.shape
    bits = K.pack_mask_bits_bwd(mask, qt)
    pad = -(-Tk // K.MASK_ROW_PAD) * K.MASK_ROW_PAD
    assert bits.dtype == (np.uint8 if qt == 32 else np.uint16)
    assert bits.shape == (-(-Tq // qt), pad, 4) and not bits[:, Tk:].any()
    words = K.pack_mask_bits(np.ascontiguousarray(mask.T))
    for t in range(bits.shape[0]):
        per = 128 // qt
        np.testing.assert_array_equal(
            bits[t], (words[t // per] >> (qt // 4 * (t % per))) & ((1 << qt // 4) - 1))
    for keys in {k for k, q in K.BWD_PLANS if q == qt}:
        got = K.unpack_mask_bits_bwd(bits, Tq, Tk, keys, qt)
        want = np.zeros_like(got)
        want[:Tk, :Tq] = mask.T
        np.testing.assert_array_equal(got, want)


def test_bwd_bit_layout():
    """One score at a time: query t qt + 8 i + 2 c + b of key j sets bit
    2 i + b of element c of (tile t, key j) and nothing else."""
    for qt in (32, 64):
        for query in (0, 1, 2, 7, 8, 13, qt - 1, qt, qt + 9, 2 * qt + 5):
            mask = np.zeros((3 * qt, 70), bool)
            mask[query, 61] = True
            bits = K.pack_mask_bits_bwd(mask, qt)
            t, rest = divmod(query, qt)
            i, rest = divmod(rest, 8)
            c, b = divmod(rest, 2)
            want = np.zeros_like(bits)
            want[t, 61, c] = 1 << (2 * i + b)
            np.testing.assert_array_equal(bits, want)


# (n_kb, n_qt) of the released plans (fp32 64 x 32; bf16 64 x 64 and 128 x 64), ragged ones
ORDER_SHAPES = [(42, 84), (21, 42), (42, 42), (11, 21), (21, 84), (5, 3), (1, 6), (7, 1)]


@pytest.mark.parametrize("n_kb,n_qt", ORDER_SHAPES)
@pytest.mark.parametrize("stagger", [True, False])
def test_masked_order_adds_each_unit_once(n_kb, n_qt, stagger):
    """Under a mask each listed unit is added exactly once, only the blocks
    that visit a tile hold a turn on it, a block's walk visits its units in
    the order of the unmasked walk, and with no empty unit the order is the unmasked
    (bwd_order) exactly."""
    rng = np.random.default_rng(n_kb * 100 + n_qt)
    full = np.full((n_kb, n_qt), 2, np.int8)
    assert K.bwd_order_masked(full, stagger) == K.bwd_order(n_qt, n_kb, stagger)
    for share in (0.05, 0.3, 0.8):
        classes = np.where(rng.random((n_kb, n_qt)) < share, 1, 0).astype(np.int8)
        order = K.bwd_order_masked(classes, stagger)
        for t, blocks in enumerate(order):
            assert sorted(blocks) == [x for x in range(n_kb) if classes[x, t]]
        for x in range(n_kb):
            walk = K.bwd_walk_masked(x, classes, stagger)
            assert sorted(walk) == [t for t in range(n_qt) if classes[x, t]]
            full_walk = K.bwd_walk(x, n_qt, n_kb, stagger)
            assert walk == [t for t in full_walk if classes[x, t]]
        # every wait points to a block earlier on the tile (a smaller step of
        # its walk, ties by block): no cycle among resident blocks
        steps = [{t: k for k, t in enumerate(K.bwd_walk(x, n_qt, n_kb, stagger))}
                 for x in range(n_kb)]
        for t, blocks in enumerate(order):
            keyed = [(steps[x][t], x) for x in blocks]
            assert keyed == sorted(keyed)


# ---- the masked backward, modelled on the CPU ----

def _lane_keep(bits, x, t, keys, qt):
    """The keep test of partial unit (key block x, query tile t) as the
    lanes read the stage's bits: (keys, qt) bool, keys as rows."""
    out = np.zeros((keys, qt), bool)
    e = np.arange(qt // 2)
    bit = 2 * (e >> 2) + (e & 1)
    stage = bits[t, x * keys:(x + 1) * keys].astype(np.int64)
    for c in range(4):
        out[:, 8 * (e >> 2) + 2 * c + (e & 1)] = (stage[:, c, None] >> bit) & 1
    return out


def _masked_bwd_model(q, k, v, do, num_heads, mask, keys, qt, stagger):
    """K3's masked backward in fp32 (numpy) as the kernels walk it: per
    (batch, head) each key block's listed units in its walk's order; per unit
    S^T from zero-padded tiles, P = 2^(S^T scale - lse) (lse from the
    forward: base 2, -inf for a fully masked row, +inf past Tq), the keep
    test only on a partial unit and from the lanes' bits, D = dO . o, dV and
    dK summed over the block's units, and each tile's dQ parts added in the
    masked deterministic order. Returns dq, dk, dv and the units visited
    and tested."""
    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    scale, sm = K.q_scale(d), 1.0 / math.sqrt(d)
    tm = K.bwd_tile_map(mask, keys, qt)
    bits = K.pack_mask_bits_bwd(mask, qt)
    n_kb, n_qt = tm["classes"].shape
    order = K.bwd_order_masked(tm["classes"], stagger)
    pad_q, pad_k = n_qt * qt, n_kb * keys
    kept = np.zeros((pad_q, pad_k), bool)
    kept[:Tq, :Tk] = mask
    dq, dk, dv = (np.zeros((B, T, C), np.float32) for T in (Tq, Tk, Tk))
    visited, tested = [], set()
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for b in range(B):
            for h in range(num_heads):
                cols = slice(h * d, (h + 1) * d)
                qh, doh = (np.zeros((pad_q, d), np.float32) for _ in range(2))
                kh, vh = (np.zeros((pad_k, d), np.float32) for _ in range(2))
                qh[:Tq], doh[:Tq] = q[b, :, cols], do[b, :, cols]
                kh[:Tk], vh[:Tk] = k[b, :, cols], v[b, :, cols]
                s = (qh[:Tq] @ kh[:Tk].T) * scale
                p = np.where(mask, np.exp2(s - s.max(1, keepdims=True, initial=-np.inf,
                                                      where=mask)), 0.0)
                lse = np.full(pad_q, np.inf, np.float32)
                lse[:Tq] = np.log2(p.sum(1)) + s.max(1, initial=-np.inf, where=mask)
                o = (p / p.sum(1, keepdims=True)) @ vh[:Tk]
                dd = np.zeros(pad_q, np.float32)
                dd[:Tq] = (doh[:Tq] * o).sum(1)
                parts = {}
                for x in range(n_kb):
                    kb, vb = kh[x * keys:(x + 1) * keys], vh[x * keys:(x + 1) * keys]
                    acc_dk, acc_dv = np.zeros((keys, d), np.float32), np.zeros((keys, d),
                                                                              np.float32)
                    units = {int(e) >> 1: int(e) & 1
                             for e in tm["ent"][tm["off"][x]:tm["off"][x + 1]]}
                    for t in K.bwd_walk_masked(x, tm["classes"], stagger):
                        visited.append((x, t))
                        rows = slice(t * qt, (t + 1) * qt)
                        st = (kb @ qh[rows].T) * scale  # S^T: keys x queries
                        pt = np.exp2(st - lse[rows][None, :])
                        dpt = vb @ doh[rows].T
                        dst = pt * (dpt - dd[rows][None, :])
                        if units[t]:
                            tested.add((x, t))
                            keep = _lane_keep(bits, x, t, keys, qt)
                            pt, dst = np.where(keep, pt, 0.0), np.where(keep, dst, 0.0)
                        acc_dv += pt @ doh[rows]
                        acc_dk += dst @ qh[rows]
                        parts[x, t] = dst.T @ kb * sm
                    n = min(keys, Tk - x * keys)
                    dk[b, x * keys:x * keys + n, cols] = (acc_dk * sm)[:n]
                    dv[b, x * keys:x * keys + n, cols] = acc_dv[:n]
                for t in range(n_qt):
                    acc = np.zeros((qt, d), np.float32)
                    for x in order[t]:
                        acc += parts[x, t]
                    n = min(qt, Tq - t * qt)
                    dq[b, t * qt:t * qt + n, cols] = acc[:n]
    return dq, dk, dv, visited, tested, tm


MODEL_MASKS = MASKS + ("holes",)


@functools.lru_cache(maxsize=None)
def _refs(name):
    """q, k, v, dO (1 x 300 x 64, 2 heads of 32 over 260 keys), the mask,
    and the gradients of JAX's dense attention (jax.grad) and of the plain
    backward, a fully masked row taken unmasked with dO = 0 there."""
    Tq, Tk, C, H = 300, 260, 64, 2
    rng = np.random.default_rng(23)
    q, k, v, do = (rng.standard_normal((1, T, C)).astype(np.float32) for T in (Tq, Tk, Tk, Tq))
    mask = _small(name, Tq, Tk)
    empty = ~mask.any(1)
    ref_mask = mask | empty[:, None]
    do_ref = np.where(empty[None, :, None], 0.0, do).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jax_mha(q, k, v, H, mask=jnp.asarray(ref_mask)) * jnp.asarray(do_ref))

    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = K.flash_mha_plain(*t, H, mask=torch.from_numpy(ref_mask))
    plain = [g.numpy() for g in K.flash_mha_bwd_plain(*t, out, torch.from_numpy(do_ref), H,
                                                       mask=torch.from_numpy(ref_mask))]
    return q, k, v, do, H, mask, want, plain


@pytest.mark.parametrize("stagger", [True, False])
@pytest.mark.parametrize("keys,qt", K.BWD_PLANS)
@pytest.mark.parametrize("name", MODEL_MASKS)
def test_masked_backward_model_matches_jax_and_plain(name, keys, qt, stagger):
    """The masked backward visits only the listed units, tests bits only on
    the partial ones, adds each tile's dQ parts in the masked order, and
    gives jax.grad's and the plain backward's gradients: the holes' empty
    key block (dK = dV = 0), empty query tiles and fully masked row (dQ = 0)
    included."""
    q, k, v, do, H, mask, want, plain = _refs(name)
    dq, dk, dv, visited, tested, tm = _masked_bwd_model(q, k, v, do, H, mask, keys, qt, stagger)
    classes = tm["classes"]
    assert sorted(set(visited)) == sorted(zip(*np.nonzero(classes)))
    assert len(visited) == H * len(set(visited))  # each unit once per head (B = 1)
    assert tested == set(zip(*np.nonzero(classes == 1)))
    for got, w, p in zip((dq, dk, dv), want, plain):
        assert np.isfinite(got).all()
        for ref in (w, p):
            assert np.abs(got - ref).max() <= GRAD_RTOL * np.abs(ref).max()
    if name == "holes":
        assert not dk[0, 128:256].any() and not dv[0, 128:256].any()
        assert not dq[0, 7].any() and not dq[0, 64:192].any()


# ---- the wrappers' side ----

def test_mask_tiles_build_the_backward_at_construction(monkeypatch):
    """MaskTiles holds the backward's map of every plan and its bits of
    every query tile size from its construction: a launch (a backward, a
    CUDA graph's capture) builds nothing."""
    mask = _holes(300, 260)
    tiles = K.MaskTiles(mask, "cpu")
    assert set(tiles.bwd_maps) == set(K.BWD_PLANS) and set(tiles.bwd_bits) == {32, 64}
    for keys, qt in K.BWD_PLANS:
        np.testing.assert_array_equal(tiles.bwd_maps[keys, qt].numpy(),
                                      K.bwd_tile_map(mask, keys, qt)["map"])
    for qt in (32, 64):
        want = K.pack_mask_bits_bwd(mask, qt)
        np.testing.assert_array_equal(tiles.bwd_bits[qt].numpy(),
                                      want.reshape(-1).view(np.uint8))

    def refuse(*args):
        raise AssertionError("built at launch")

    monkeypatch.setattr(K, "bwd_tile_map", refuse)
    monkeypatch.setattr(K, "pack_mask_bits_bwd", refuse)
    for keys, qt in K.BWD_PLANS:
        assert tiles.bwd_launch(keys, qt) == (tiles.bwd_maps[keys, qt].data_ptr(),
                                              tiles.bwd_bits[qt].data_ptr())


class _Entry:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Lib:
    def __init__(self, *names):
        for name in names:
            setattr(self, name, _Entry())


@pytest.mark.parametrize("entry,dtype,keys", [("flash_mha_bwd_f32", torch.float32, 64),
                                              ("flash_mha_bwd_bf16", torch.bfloat16, 128),
                                              ("flash_mha_bwd_bf16", torch.bfloat16, 64)])
def test_masked_launch_arguments(monkeypatch, entry, dtype, keys):
    """A masked launch goes to the masked library's entry of its route with
    the plan's tile map and the bits of its query tiles (from the mask's
    MaskTiles; the fp32 entry's forward map and bits, read at head dim 128
    only, null), never to the unmasked entry; an unmasked one the reverse."""
    plain, masked = _Lib("flash_mha_bwd_f32", "flash_mha_bwd_bf16"), _Lib(
        "flash_mha_bwd_masked_f32", "flash_mha_bwd_masked_bf16")
    monkeypatch.setattr(K, "_bwd_lib", lambda: plain)
    monkeypatch.setattr(K, "_bwd_masked_lib", lambda: masked)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    monkeypatch.setattr(K, "BWD_KEYS_BF16", keys)
    B, Tq, Tk, H, d = 2, 300, 260, 2, 32
    mask_np = _holes(Tq, Tk)
    mask = torch.from_numpy(mask_np)
    monkeypatch.setattr(K, "_checked", lambda q, k, v, h, m, dt: (
        B, Tq, Tk, d, None if m is None else m.to(torch.uint8)))
    tiles = K.MaskTiles(mask_np, "cpu")
    q, o, do = (torch.zeros(B, Tq, H * d, dtype=dtype) for _ in range(3))
    k, v = (torch.zeros(B, Tk, H * d, dtype=dtype) for _ in range(2))
    lse = torch.zeros(B * H, Tq)
    qt = 32 if dtype == torch.float32 else 64
    K._launch_bwd(entry, dtype, q, k, v, o, do, H, lse, mask, 0.1, 7, tiles=tiles)
    (args,) = getattr(masked, entry.replace("flash_mha_bwd", "flash_mha_bwd_masked")).calls
    fwd = 2 if dtype == torch.float32 else 0  # the fp32 entry's forward map and bits
    assert len(args) == 25 + fwd and not getattr(plain, entry).calls
    assert args[6] == tiles.bwd_maps[keys, qt].data_ptr()
    assert args[7] == tiles.bwd_bits[qt].data_ptr()
    assert args[8:8 + fwd] == (None,) * fwd
    assert args[19 + fwd] == keys  # the plan's keys a block
    K._launch_bwd(entry, dtype, q, k, v, o, do, H, lse, None, 0.1, 7)
    (args,) = getattr(plain, entry).calls
    assert len(args) == 24 and args[6] is None


def test_masked_f32_d128_launch_passes_the_forward_map(monkeypatch):
    """At head dim 128 the fp32 masked launch also gives its entry the
    forward's tile map of 64 rows and 32 keys and its bits (that dQ kernel
    walks them), and a dQ sum of one float (it sums each query in a block)."""
    masked = _Lib("flash_mha_bwd_masked_f32", "flash_mha_bwd_masked_bf16")
    monkeypatch.setattr(K, "_bwd_masked_lib", lambda: masked)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    B, Tq, Tk, H, d = 1, 300, 260, 1, 128
    mask_np = _holes(Tq, Tk)
    mask = torch.from_numpy(mask_np)
    monkeypatch.setattr(K, "_checked", lambda q, k, v, h, m, dt: (
        B, Tq, Tk, d, m.to(torch.uint8)))
    tiles = K.MaskTiles(mask_np, "cpu")
    q, o, do = (torch.zeros(B, Tq, H * d) for _ in range(3))
    k, v = (torch.zeros(B, Tk, H * d) for _ in range(2))
    K._launch_bwd("flash_mha_bwd_f32", torch.float32, q, k, v, o, do, H, torch.zeros(B * H, Tq),
                  mask, 0.1, 7, tiles=tiles)
    (args,) = masked.flash_mha_bwd_masked_f32.calls
    assert len(args) == 27
    assert args[6:10] == (*tiles.bwd_launch(64, 32), *tiles.launch(64, 32))
    assert args[20] == d and args[21] == 64


def test_autograd_node_keeps_the_forwards_tiles(monkeypatch):
    """The backward of a masked launch reads the MaskTiles its forward read
    (kept in the node), as the forward does."""
    seen = {}

    def forward(q, k, v, num_heads, tiles, rate, seed, want_lse, head_dim=None):
        return q.clone(), torch.zeros(q.shape[0] * num_heads, q.shape[1])

    def backward(q, k, v, o, dout, num_heads, **kw):
        seen.update(kw)
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(K, "_forward_f32", forward)
    monkeypatch.setattr(K, "flash_mha_bwd", backward)
    mask = np.ones((8, 8), bool)
    tiles = K.MaskTiles(mask, "cpu")
    q, k, v = (torch.zeros(1, 8, 32, requires_grad=True) for _ in range(3))
    out = K._FlashMHA.apply(q, k, v, 1, torch.from_numpy(mask), tiles, 0.0, 0, True)
    out.sum().backward()
    assert seen["mask_tiles"] is tiles and seen["mask"] is not None


def test_masked_sources_and_declarations():
    """The masked kernels are sources of their own: the forward's linked into
    its library (PARTS, built in parallel), exporting nothing itself; the
    backward's a library (with its head dim 128 part) whose ctypes
    declaration matches its C entries."""
    from test_torch_build import _exported, _FakeLib

    assert _build.parts("flash_mha") == ["flash_mha", "flash_mha_masked", "flash_mha_d128"]
    assert _build.parts("flash_mha_bwd_masked") == ["flash_mha_bwd_masked",
                                                    "flash_mha_bwd_masked_d128"]
    assert _build.parts("flash_mha_bwd") == ["flash_mha_bwd", "flash_mha_bwd_d128"]
    for part in ("flash_mha_masked", "flash_mha_d128", "flash_mha_bwd_d128",
                 "flash_mha_bwd_masked_d128"):
        assert 'extern "C"' not in (_build.CSRC / f"{part}.cu").read_text()
    fake = _FakeLib()
    K._bwd_masked_lib.cache_clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_build, "load", lambda name: fake)
            K._bwd_masked_lib()
    finally:
        K._bwd_masked_lib.cache_clear()
    exported = _exported((_build.CSRC / "flash_mha_bwd_masked.cu").read_text())
    assert set(fake.functions) == set(exported) == {
        "flash_mha_bwd_masked_f32", "flash_mha_bwd_masked_bf16",
        "flash_mha_bwd_masked_ordered_plan"}
    for name, kinds in exported.items():
        assert fake.functions[name].argtypes == kinds
        assert fake.functions[name].restype is ctypes.c_int


def test_a_library_of_several_sources_compiles_each_then_links(tmp_path, monkeypatch):
    """_build.Job: one nvcc -c per source of the library, all started at
    once, then one link of their objects into the library; the objects are
    removed and the report holds every compile's."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("lib", "lib_part"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/usr/bin/env python3\n"
                    "import sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('x')\n"
                    "if '-c' in sys.argv:\n"
                    "    print('ptxas info    : Used 8 registers')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "PARTS", {"lib": ("lib", "lib_part")})
    out = tmp_path / "liblib.so"
    report, error = _build.Job("lib", csrc, out, str(nvcc)).finish()
    assert error is None and out.is_file() and report.count("Used 8 registers") == 2
    calls = log.read_text().splitlines()
    assert len(calls) == 3 and all(" -c " in c and "-shared" not in c for c in calls[:2])
    assert "-shared" in calls[2] and calls[2].count(".o") == 2
    assert not list(tmp_path.glob("*.o"))
