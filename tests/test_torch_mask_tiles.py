"""K3 under a static keep-mask as its kernels read it (csrc/flash_mha.cu):
the tile map of each plan (empty, full and partial (row block, key tile)
units, the list of the non-empty ones), the mask packed into bits in the
order the kernels' lanes hold the scores, the persistent schedule over the
listed units, and a tiled model of the masked loop (only the listed units
visited, the keep test only on partial ones, pieces merged as the combine
kernel merges them) against the Pallas kernel (interpret mode) and the
port's plain version.

Tolerance of the model: atol 2e-5, rtol 1e-4 (the fp32 bound of
tests/test_torch_attention.py), NaN exactly where the references have it.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.ops import sparse as tsp

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=2e-5, rtol=1e-4)
SMS = 132  # the H100's SMs
MASKS = ("diag", "global", "jmask", "random", "diag_jmask_random")
RELEASED = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))  # (Tq, Tk)
DEFAULTS = dict(sparse_attn_window=500, global_window=100, mask_random_seed=42, sparsity=0.95)


def _static(mask_type, Tq, Tk, **options):
    opts = dict(DEFAULTS, **options)
    return tsp.get_mask(Tk, Tq, mask_type, opts["sparse_attn_window"], opts["global_window"],
                        opts["mask_random_seed"], opts["sparsity"])


def _holes(Tq, Tk, rows=128, keys=64):
    """Kept at random, with a fully masked row, a fully masked row block and
    a fully masked key tile."""
    mask = np.random.default_rng(5).random((Tq, Tk)) > 0.4
    mask[min(7, Tq - 1)] = False
    mask[rows:2 * rows] = False
    mask[:, keys:2 * keys] = False
    return mask


def _ragged_masks():
    out = {}
    for Tq, Tk in ((300, 260), (130, 70), (64, 200), (1, 5)):
        for name in MASKS:
            out[f"{name} {Tq}x{Tk}"] = _static(name, Tq, Tk, sparse_attn_window=20,
                                               global_window=9, sparsity=0.9)
        out[f"holes {Tq}x{Tk}"] = _holes(Tq, Tk)
    return out


RAGGED = _ragged_masks()


def _brute_classes(mask, rows, keys):
    Tq, Tk = mask.shape
    n_x, n_t = -(-Tq // rows), -(-Tk // keys)
    want = np.zeros((n_x, n_t), np.int8)
    for x in range(n_x):
        for t in range(n_t):
            sub = mask[x * rows:(x + 1) * rows, t * keys:(t + 1) * keys]
            if sub.any():
                want[x, t] = 2 if sub.all() and (t + 1) * keys <= Tk else 1
    return want


def _check_map(mask, rows, keys):
    tm = K.tile_map(mask, rows, keys)
    classes = tm["classes"]
    np.testing.assert_array_equal(classes, _brute_classes(mask, rows, keys))
    # the list: exactly the non-empty units, row block by row block in key order
    want = [(x, t, int(classes[x, t] == 1)) for x in range(classes.shape[0])
            for t in range(classes.shape[1]) if classes[x, t]]
    off, ent = tm["off"], tm["ent"]
    got = [(x, int(e) >> 1, int(e) & 1) for x in range(classes.shape[0])
           for e in ent[off[x]:off[x + 1]]]
    assert got == want
    assert list(tm["empty"]) == [x for x in range(classes.shape[0]) if not classes[x].any()]
    flat = tm["map"]
    n_x = classes.shape[0]
    assert flat.dtype == np.int32
    assert list(flat[:2]) == [len(ent), len(tm["empty"])]
    np.testing.assert_array_equal(flat[2:3 + n_x], off)
    np.testing.assert_array_equal(flat[3 + n_x:3 + n_x + len(ent)], ent)
    np.testing.assert_array_equal(flat[3 + n_x + len(ent):], tm["empty"])
    assert tm["counts"] == tuple(int(c) for c in (classes > 0).sum(1))


@pytest.mark.parametrize("rows,keys", K.MASK_PLANS)
@pytest.mark.parametrize("mask_type", MASKS)
@pytest.mark.parametrize("Tq,Tk", RELEASED)
def test_tile_map_of_released_masks(mask_type, Tq, Tk, rows, keys):
    """Every static mask at the reference's defaults and the four released
    shapes, every plan: the classes against a unit-by-unit reading of the
    mask, the list exactly the non-empty units."""
    _check_map(_static(mask_type, Tq, Tk), rows, keys)


@pytest.mark.parametrize("rows,keys", K.MASK_PLANS)
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_tile_map_of_ragged_masks(name, rows, keys):
    """Tq and Tk not multiples of any tile: the last key tile is never full,
    rows past Tq count neither way."""
    mask = RAGGED[name]
    _check_map(mask, rows, keys)
    classes = K.tile_classes(mask, rows, keys)
    if mask.shape[1] % keys:
        assert (classes[:, -1] != 2).all()


@pytest.mark.parametrize("keys", (32, 64, 128))
@pytest.mark.parametrize("name", sorted(RAGGED) + [f"{m} released" for m in MASKS])
def test_packed_bits_unpack_by_lane(name, keys):
    """The words unpacked lane by lane as the kernels test them give back the
    mask, 0 past Tk (to the end of the last tile) and past Tq."""
    mask = RAGGED[name] if name in RAGGED else _static(name.split()[0], 2688, 1344)
    Tq, Tk = mask.shape
    words = K.pack_mask_bits(mask)
    pad = -(-Tq // K.MASK_ROW_PAD) * K.MASK_ROW_PAD
    assert words.dtype == np.uint32 and words.shape == (-(-Tk // 128), pad, 4)
    assert not words[:, Tq:].any()
    got = K.unpack_mask_bits(words, Tq, Tk, keys)
    want = np.zeros_like(got)
    want[:, :Tk] = mask
    np.testing.assert_array_equal(got, want)


def test_lane_word_layout():
    """One key at a time: key 128 w + 8 j + 2 c + b of row r sets bit 2 j + b
    of word c of (w, r) and nothing else."""
    for key in (0, 1, 2, 7, 8, 13, 127, 128, 200):
        mask = np.zeros((3, 260), bool)
        mask[2, key] = True
        words = K.pack_mask_bits(mask)
        w, rest = divmod(key, 128)
        j, rest = divmod(rest, 8)
        c, b = divmod(rest, 2)
        want = np.zeros_like(words)
        want[w, 2, c] = 1 << (2 * j + b)
        np.testing.assert_array_equal(words, want)


def _cover(runs, counts, n_x):
    """Each row block's runs, contiguous, in order, covering its units once."""
    for r, block_runs in enumerate(runs):
        n = counts[r % n_x]
        covered = [i for i0, i1 in block_runs for i in range(i0, i1)]
        assert covered == list(range(n)), (r, block_runs, n)


@pytest.mark.parametrize("ctas", (1, 2, 7, 31, SMS, "plain"))
@pytest.mark.parametrize("name", ["diag 300x260", "global 300x260", "holes 300x260",
                                  "holes 130x70", "random 64x200", "released diag",
                                  "released global"])
def test_compacted_schedule_covers_each_unit_once(name, ctas):
    """The persistent schedule over the listed units (csrc/flash_mha.cu
    Schedule, Units): even shares of the B H nnz units, each unit of each
    row block in exactly one run, the runs of a range contiguous; row blocks
    with no unit have no run, and they are exactly the map's empty list."""
    mask = (_static(name.split()[1], 2688, 2688) if name.startswith("released")
            else RAGGED[name])
    B, H = 2, 3
    for rows, keys in K.MASK_PLANS:
        tm = K.tile_map(mask, rows, keys)
        counts, n_x = tm["counts"], len(tm["counts"])
        blocks = n_x * H * B
        units = blocks // n_x * sum(counts)
        G = blocks if ctas == "plain" else min(ctas, units)
        runs = K.bf16_schedule(blocks, -(-mask.shape[1] // keys), G, counts)
        _cover(runs, counts, n_x)
        assert [r for r in range(blocks) if not runs[r]] == [
            r for r in range(blocks) if r % n_x in set(tm["empty"])]
        if G == blocks:
            assert all(len(rr) <= 1 for rr in runs)
            continue
        # the ranges: walking the runs in unit order gives the even cut
        lo = K._ranges(units, G)
        starts = K._starts(counts, blocks // n_x)
        edges = sorted({starts[r] + i0 for r, rr in enumerate(runs) for i0, _ in rr}
                       | {starts[r] + i1 for r, rr in enumerate(runs) for _, i1 in rr})
        assert set(lo) <= set(edges)
        assert set(edges) <= set(lo) | set(starts) | {starts[r] + counts[r % n_x]
                                                      for r in range(blocks)}


def test_schedule_without_map_is_unchanged():
    """No map: every row block holds every tile (the unmasked schedule)."""
    for blocks, n_tiles, ctas in ((672, 21, 132), (88, 11, 132), (7, 5, 7)):
        full = K.bf16_schedule(blocks, n_tiles, ctas, (n_tiles,))
        assert K.bf16_schedule(blocks, n_tiles, ctas) == full


@functools.lru_cache(maxsize=None)
def _released_tiles(mask_type, Tq, Tk):
    return K.MaskTiles(_static(mask_type, Tq, Tk), "cpu")


@pytest.mark.parametrize("B", (1, 6))
@pytest.mark.parametrize("mask_type", MASKS)
@pytest.mark.parametrize("Tq,Tk", RELEASED)
def test_plan_under_mask(monkeypatch, B, mask_type, Tq, Tk):
    """The bf16 plan under a mask prices the listed units: a valid grid (a
    block per row block, or at most one per SM and at most one per unit),
    and a mask whose every unit is full prices as no mask does."""
    monkeypatch.setattr(K, "KEY_TILE_BF16", 128)
    tiles = _released_tiles(mask_type, Tq, Tk)
    rows, ctas = K.bf16_plan(B, Tq, Tk, 8, SMS, tiles)
    blocks = -(-Tq // rows) * 8 * B
    units = blocks // len(tiles.counts[rows, 128]) * sum(tiles.counts[rows, 128])
    assert rows in (128, 192) and (ctas == blocks or ctas <= min(SMS, units))
    n_tiles = -(-Tk // 128)
    for persistent in (False, True):
        ctas = min(SMS, blocks * n_tiles) if persistent else blocks
        assert K._plan_cost(blocks, n_tiles, rows, ctas, persistent, SMS) == pytest.approx(
            K._plan_cost(blocks, n_tiles, rows, ctas, persistent, SMS,
                         (n_tiles,) * (blocks // 8 // B)))


def test_plan_of_an_empty_mask_is_the_plain_grid():
    tiles = K.MaskTiles(np.zeros((300, 260), bool), "cpu")
    rows, ctas = K.bf16_plan(2, 300, 260, 4, SMS, tiles)
    assert ctas == -(-300 // rows) * 4 * 2


# ---- the masked loop, modelled on the CPU ----

def _lane_keep(words, x, rows, t, keys):
    """The keep test of partial tile t for row block x, as the lanes read the
    words (``load_words``, ``keep_bits``): (rows, keys) bool."""
    out = np.zeros((rows, keys), bool)
    e = np.arange(keys // 2)
    bit = 2 * (e >> 2) + (e & 1)
    w = words[t * keys // 128, x * rows:(x + 1) * rows].astype(np.int64)
    if keys < 128:  # a tile's share of its group's words: 16 bits at 64 keys, 8 at 32
        w = w >> (keys // 4 * (t % (128 // keys)))
    for c in range(4):
        out[:, 8 * (e >> 2) + 2 * c + (e & 1)] = (w[:, c, None] >> bit) & 1
    return torch.from_numpy(out)


def _masked_model(q, k, v, num_heads, mask, rows, keys, ctas):
    """K3's masked loop in fp32: the persistent schedule over the tile map's
    units (``ctas`` ranges; ``None``: a block per row block), each unit's S,
    -inf from the bits only on a partial tile, the -inf-safe base-2 online
    softmax, each run's (o, scaled max, l) merged as the combine kernel
    merges them, the row blocks the map lists as empty NaN. Also returns the
    tiles tested and the tiles visited."""
    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    scale = K.q_scale(d)
    tm = K.tile_map(mask, rows, keys)
    words = K.pack_mask_bits(mask)
    n_x = len(tm["counts"])
    blocks = n_x * num_heads * B
    runs = K.bf16_schedule(blocks, -(-Tk // keys), blocks if ctas is None else ctas,
                           tm["counts"])
    out = torch.full((B, Tq, C), math.nan)
    tested, visited = set(), []
    for r, block_runs in enumerate(runs):
        x, h, b = r % n_x, r // n_x % num_heads, r // (n_x * num_heads)
        listed = tm["ent"][tm["off"][x]:tm["off"][x + 1]]
        cols = slice(h * d, (h + 1) * d)
        qb = torch.zeros(rows, d)
        n_q = min(rows, Tq - x * rows)
        qb[:n_q] = q[b, x * rows:x * rows + n_q, cols]
        parts = []
        for i0, i1 in block_runs:
            acc, m, l = torch.zeros(rows, d), torch.full((rows,), -math.inf), torch.zeros(rows)
            for unit in listed[i0:i1]:
                t, partial = int(unit) >> 1, int(unit) & 1
                visited.append((x, t))
                kt, vt = torch.zeros(keys, d), torch.zeros(keys, d)
                n_k = min(keys, Tk - t * keys)
                keys_t = slice(t * keys, t * keys + n_k)
                kt[:n_k], vt[:n_k] = k[b, keys_t, cols], v[b, keys_t, cols]
                s = (qb @ kt.T) * scale
                if partial:
                    tested.add((x, t))
                    s = s.masked_fill(~_lane_keep(words, x, rows, t, keys), -math.inf)
                m_new = torch.maximum(m, s.max(-1).values)
                base = torch.where(torch.isneginf(m_new), 0.0, m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ vt
                m = m_new
            parts.append((acc, m, l))
        if not parts:
            continue  # an empty row block: NaN, as the kernel's fill writes
        top = torch.stack([pt[1] for pt in parts]).max(0).values
        top = torch.where(torch.isneginf(top), 0.0, top)
        w = [torch.exp2(pt[1] - top) for pt in parts]
        acc = sum(wi[:, None] * pt[0] for wi, pt in zip(w, parts))
        l = sum(wi * pt[2] for wi, pt in zip(w, parts))
        out[b, x * rows:x * rows + n_q, cols] = (acc / l[:, None])[:n_q]
    return out, tested, visited, tm


MODEL_MASKS = ("diag", "global", "jmask", "random", "diag_jmask_random", "holes")
_REFS: dict = {}


def _refs(name):
    """q, k, v (1 x 300 x 64, 2 heads of 32 over 260 keys), the mask, and the
    Pallas kernel's and the plain version's outputs."""
    if name not in _REFS:
        Tq, Tk, C, H = 300, 260, 64, 2
        rng = np.random.default_rng(19)
        q, k, v = (rng.standard_normal((1, T, C)).astype(np.float32) for T in (Tq, Tk, Tk))
        mask = (_holes(Tq, Tk) if name == "holes" else
                _static(name, Tq, Tk, sparse_attn_window=20, global_window=9, sparsity=0.9))
        jax_out = np.asarray(jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                                           mask=jnp.asarray(mask), block_q=128, block_k=128,
                                           interpret=True))
        plain = K.flash_mha_plain(*(torch.from_numpy(a) for a in (q, k, v)), H,
                                  mask=torch.from_numpy(mask)).numpy()
        _REFS[name] = (q, k, v, H, mask, jax_out, plain)
    return _REFS[name]


@pytest.mark.parametrize("ctas", (None, 7, SMS))
@pytest.mark.parametrize("rows,keys", K.MASK_PLANS)
@pytest.mark.parametrize("name", MODEL_MASKS)
def test_masked_model_matches_pallas_and_plain(name, rows, keys, ctas):
    """The masked loop visits only the listed units and tests bits only on
    the partial ones, and gives the Pallas kernel's output (interpret mode)
    and the plain version's, NaN exactly where they have it: the fully
    masked row and row block of ``holes`` included."""
    q, k, v, H, mask, jax_out, plain = _refs(name)
    got, tested, visited, tm = _masked_model(*(torch.from_numpy(a) for a in (q, k, v)), H,
                                             mask, rows, keys, ctas)
    got = got.numpy()
    classes = tm["classes"]
    assert sorted(set(visited)) == sorted(zip(*np.nonzero(classes)))
    assert len(visited) == H * len(set(visited))  # each unit once per head (B = 1)
    assert tested == set(zip(*np.nonzero(classes == 1)))
    for ref in (jax_out, plain):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, **TOL)
    if name == "holes":
        assert np.isnan(got[0, 7]).all()
        assert np.isnan(got[0, 128:256]).all()


# ---- the wrappers' side: the registry, the launch's arguments ----

def test_mask_tiles_are_kept_with_their_mask():
    """Built once per mask tensor, rebuilt after it is written to, and
    forgotten with it."""
    mask = torch.from_numpy(_holes(300, 260))
    tiles = K.mask_tiles(mask)
    assert K.mask_tiles(mask) is tiles
    key = id(mask)
    mask[0, 0] = not bool(mask[0, 0])
    again = K.mask_tiles(mask)
    assert again is not tiles
    np.testing.assert_array_equal(K.unpack_mask_bits(again.bits.numpy().view(np.uint32), 300,
                                                     260)[:, :260], mask.numpy())
    del mask
    assert key not in K._TILES


def test_mask_tiles_refuse_a_capture(monkeypatch):
    """A tile map built inside a CUDA graph's capture would read the mask on
    the host: it raises; one registered before is found."""
    mask = torch.ones(64, 64, dtype=torch.bool)
    registered = K.mask_tiles(mask)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert K.mask_tiles(mask) is registered
    with pytest.raises(RuntimeError, match="capture"):
        K.mask_tiles(torch.ones(64, 64, dtype=torch.bool))


def test_keep_mask_registers_its_tiles(monkeypatch):
    """ops/sparse.py builds the tile maps beside a table off the CPU from the
    same numpy array (here the meta device stands in for the card)."""
    seen = []
    monkeypatch.setattr(tsp, "register_mask_tiles", lambda t, host: seen.append((t, host)))
    args = (300, 260, "diag", 20, 9, 42, 0.9)
    tsp._keep_mask.cache_clear()
    try:
        tsp.keep_mask(*args, device="cpu")
        assert seen == []  # the CPU takes the plain version: no tiles
        table = tsp.keep_mask(*args, device="meta")
    finally:
        tsp._keep_mask.cache_clear()
    ((got, host),) = seen
    assert got is table
    np.testing.assert_array_equal(host, tsp.get_mask(260, 300, "diag", 20, 9, 42, 0.9))


class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        self.flash_mha_f32 = _FakeEntry()
        self.flash_mha_bf16 = _FakeEntry()


@pytest.mark.parametrize("B,Tq,Tk,mask_type", [
    (1, 2688, 2688, "diag"), (6, 2688, 2688, "global"), (1, 1344, 2688, "diag_jmask_random"),
    (6, 1344, 1344, "jmask"), (2, 300, 260, "holes")])
def test_launch_arguments_under_mask(monkeypatch, B, Tq, Tk, mask_type):
    """Each route passes the plan's tile map and the bits, and the bf16
    route gives merge scratch exactly when a range of its schedule starts
    inside a row block."""
    fake = _FakeLib()
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: SMS)
    mask = _holes(Tq, Tk) if mask_type == "holes" else _static(mask_type, Tq, Tk)
    tiles = K.MaskTiles(mask, "cpu")
    H, d = 8, 64
    q = torch.zeros(B, Tq, H * d, dtype=torch.bfloat16)
    kv = torch.zeros(B, Tk, H * d, dtype=torch.bfloat16)
    K._forward_bf16(q, kv, kv, H, tiles, 0.0, 0, False)
    (args,) = fake.flash_mha_bf16.calls
    rows, ctas = args[15], args[16]
    assert (rows, ctas) == K.bf16_plan(B, Tq, Tk, H, SMS, tiles)
    assert args[3] == tiles.maps[rows, K.KEY_TILE_BF16].data_ptr()
    assert args[4] == tiles.bits.data_ptr()
    counts = tiles.counts[rows, K.KEY_TILE_BF16]
    blocks = len(counts) * H * B
    runs = K.bf16_schedule(blocks, -(-Tk // K.KEY_TILE_BF16), ctas, counts)
    assert (args[6] is not None) == any(len(r) > 1 or (r and r[0][0] > 0)
                                        or (r and r[-1][1] < counts[i % len(counts)])
                                        for i, r in enumerate(runs))
    K._forward_f32(q.float(), kv.float(), kv.float(), H, tiles, 0.0, 0, False)
    (args,) = fake.flash_mha_f32.calls
    assert args[3] == tiles.maps[K.BLOCK_ROWS, K.KEY_TILE].data_ptr()
    assert args[4] == tiles.bits.data_ptr()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_masked_bf16_launch_refuses_too_many_row_blocks(monkeypatch, rate):
    """The masked bf16 kernel keeps the tile map's offsets in shared memory
    and refuses more than MASK_ROW_BLOCKS row blocks a launch: past
    MASK_PIECE_ROWS queries the wrapper launches a piece of the rows at a
    time, each with its piece's tile map and bits, none past the limit at
    any plan's rows, each given its first global row (the dropout's hash
    counts global rows) and the call's rate and seed."""
    fake = _FakeLib()
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(K, "BF16_ROWS", 192)
    Tq, Tk = K.MASK_ROW_BLOCKS * 192 + 1, 8
    tiles = K.MaskTiles(np.ones((Tq, Tk), bool), "cpu")
    q = torch.zeros(1, Tq, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, Tk, 64, dtype=torch.bfloat16)
    K._forward_bf16(q, kv, kv, 1, tiles, rate, 3, False)
    calls = fake.flash_mha_bf16.calls
    assert len(calls) == len(tiles.pieces) == 2
    for args, (r0, r1, piece) in zip(calls, tiles.pieces):
        rows = args[15]
        assert args[9] == r1 - r0 and -(-(r1 - r0) // rows) <= K.MASK_ROW_BLOCKS
        assert args[3] == piece.maps[rows, K.KEY_TILE_BF16].data_ptr()
        assert args[4] == piece.bits.data_ptr()
        assert args[17] == pytest.approx(rate) and args[18] == 3
        assert len(args) == 21 and args[19] == r0


def _drop_rows_of_pieces(calls, H, rate, seed, keys=64):
    """The dropout pattern the masked bf16 kernel draws on each launch of
    ``calls`` (recorded arguments: the piece's rows and its first global
    row), from the kernel's own arithmetic per
    warpgroup tile (bf16_drop_tile: row terms of the launch's row plus its
    first global row) at the tiles on each side of every piece's edge ->
    {global first row of a tile: (H, 64, Tk) keep}."""
    out = {}
    for args in calls:
        n, Tk = args[9], args[10]
        row0 = args[19]
        for local in sorted({0, 64, n - n % 64 - 64, n - n % 64} - {n}):
            tiles = []
            for bh in range(H):
                row = []
                for k0 in range(0, Tk, keys):
                    lanes = ~K.bf16_drop_tile(bh, row0 + local, k0, rate, seed, keys)
                    e = torch.arange(keys // 2)
                    w, lane = torch.meshgrid(torch.arange(4), torch.arange(32), indexing="ij")
                    r = (16 * w[..., None] + lane[..., None] // 4 + 8 * ((e >> 1) & 1))
                    j = 8 * (e >> 2) + 2 * (lane[..., None] % 4) + (e & 1)
                    tile = torch.zeros(64, keys, dtype=torch.bool)
                    tile[r, j] = lanes
                    row.append(tile)
                tiles.append(torch.cat(row, 1)[:, :Tk])
            out[row0 + local] = torch.stack(tiles)
    return out


def test_masked_bf16_pieces_drop_the_global_rows(monkeypatch):
    """Past MASK_PIECE_ROWS queries with dropout: the pattern each piece's
    launch draws (the kernel's arithmetic on its rows from the piece's first
    global row), stitched over the pieces, is dropout_keep's over the global
    rows, at the rows on each side of the pieces' edge."""
    from demucs_tpu_torch.ops.attention import dropout_keep

    fake = _FakeLib()
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: SMS)
    H, Tq, Tk, rate, seed = 2, K.MASK_PIECE_ROWS + 200, 100, 0.2, 9876
    tiles = K.MaskTiles(np.ones((Tq, Tk), bool), "cpu")
    q = torch.zeros(1, Tq, H * 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, Tk, H * 64, dtype=torch.bfloat16)
    K._forward_bf16(q, kv, kv, H, tiles, rate, seed, False)
    calls = fake.flash_mha_bf16.calls
    assert [c[9] for c in calls] == [r1 - r0 for r0, r1, _ in tiles.pieces]
    got = _drop_rows_of_pieces(calls, H, rate, K._seed32(rate, seed))
    want = dropout_keep(H, Tq + 64, Tk, rate, seed, "cpu")
    assert K.MASK_PIECE_ROWS in got and K.MASK_PIECE_ROWS - 64 in got
    for first, keep in got.items():
        assert torch.equal(keep, want[:, first:first + 64]), first


@pytest.mark.parametrize("Tq", [1, K.MASK_PIECE_ROWS - 1, K.MASK_PIECE_ROWS,
                                K.MASK_PIECE_ROWS + 1, 2 * K.MASK_PIECE_ROWS + 77])
def test_mask_pieces_cover_every_row_once(Tq):
    """The bf16 route's pieces of a masked call: consecutive, each at most
    MASK_PIECE_ROWS rows (MASK_ROW_BLOCKS row blocks of the smallest plan),
    every query row in exactly one."""
    pieces = K.mask_pieces(Tq)
    rows = [r for r0, r1 in pieces for r in range(r0, r1)]
    assert rows == list(range(Tq))
    assert all(0 < r1 - r0 <= K.MASK_PIECE_ROWS for r0, r1 in pieces)
    assert K.MASK_PIECE_ROWS // 128 <= K.MASK_ROW_BLOCKS


def test_mask_tiles_pieces_hold_their_rows():
    """A mask past MASK_PIECE_ROWS rows keeps each piece's tiles, built from
    that piece's rows: its bits are the packed rows, its maps their maps."""
    Tq, Tk = K.MASK_PIECE_ROWS + 300, 70
    mask = np.random.default_rng(3).random((Tq, Tk)) > 0.5
    tiles = K.MaskTiles(mask, "cpu")
    assert [(r0, r1) for r0, r1, _ in tiles.pieces] == K.mask_pieces(Tq)
    for r0, r1, piece in tiles.pieces:
        assert piece.shape == (r1 - r0, Tk) and not piece.pieces and not piece.bwd_maps
        np.testing.assert_array_equal(piece.bits.numpy().view(np.uint32),
                                      K.pack_mask_bits(mask[r0:r1]))
        for rows, keys in K.MASK_PLANS:
            np.testing.assert_array_equal(piece.maps[rows, keys].numpy(),
                                          K.tile_map(mask[r0:r1], rows, keys)["map"])
    assert not K.MaskTiles(mask[:K.MASK_PIECE_ROWS], "cpu").pieces
