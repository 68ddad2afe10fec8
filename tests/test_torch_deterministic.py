"""K3's backward under torch.use_deterministic_algorithms (C5): the wrapper
hands the kernel a counter per (batch, head, query tile), with which the key
blocks add their parts of dQ in an order fixed by the shape, and the
cooperative grid's item counter; without the flag it hands none and the
blocks add in the order they finish. The kernel itself runs only on the card
(tests/test_torch_cuda.py); here the C entries are fakes that record what the
wrapper passes (and ``bwd_plan`` reads), and the CPU twin of the order and
the grid (``bwd_walk``, ``bwd_turn``, ``bwd_order``, ``bwd_rounds``) is held
to what the kernel relies on: each (tile, key block) added once, every wait
pointing back, no chain of waits when the blocks run in lockstep, no
deadlock in any interleaving, rounds of whole heads that fit the resident
blocks, the plain key-block order past them."""

import contextlib
import random

import pytest
import torch

from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.kernels import attention as K


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeBwdLib:
    def __init__(self):
        self.flash_mha_bwd_f32 = _FakeEntry()
        self.flash_mha_bwd_bf16 = _FakeEntry()


@pytest.mark.parametrize("B,H,Tq", [(1, 8, 2688), (8, 8, 1344), (2, 3, 1), (1, 1, 33)])
def test_dq_turns_follow_the_flag(deterministic, B, H, Tq):
    turns = K.dq_turns(B, H, Tq, "cpu")
    # one counter per query tile of the fp32 route (32 rows), which has more than bf16's (64),
    # then the cooperative grid's item counter
    assert turns.dtype == torch.int32 and turns.numel() == B * H * -(-Tq // 32) + 1
    torch.use_deterministic_algorithms(False)
    assert K.dq_turns(B, H, Tq, "cpu") is None


def _launch(monkeypatch, entry: str, dtype: torch.dtype):
    fake = _FakeBwdLib()
    monkeypatch.setattr(K, "_bwd_lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_checked", lambda q, k, v, h, mask, dt: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h, None))
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    B, Tq, Tk, H, d = 2, 100, 70, 2, 32
    g = torch.Generator().manual_seed(0)
    q, o, do = (torch.randn(B, Tq, H * d, generator=g).to(dtype) for _ in range(3))
    k, v = (torch.randn(B, Tk, H * d, generator=g).to(dtype) for _ in range(2))
    lse = torch.zeros(B * H, Tq)
    K._launch_bwd(entry, dtype, q, k, v, o, do, H, lse, None, 0.0, 0)
    (args,) = getattr(fake, entry).calls
    return args, (B, H, Tq)


@pytest.mark.parametrize("entry,dtype", [("flash_mha_bwd_f32", torch.float32),
                                         ("flash_mha_bwd_bf16", torch.bfloat16)])
@pytest.mark.parametrize("ordered", [False, True])
def test_backward_wrapper_passes_the_deterministic_choice(monkeypatch, request, entry, dtype,
                                                         ordered):
    """The turns are the C entry's 10th argument, after stats and dq_acc:
    a pointer under the flag, null without it, on both routes."""
    if ordered:
        request.getfixturevalue("deterministic")
    args, _ = _launch(monkeypatch, entry, dtype)
    assert len(args) == 24  # 13 pointers, 6 ints, 3 floats, the seed, the stream
    dq_acc, turns = args[8], args[9]
    assert isinstance(dq_acc, int) and dq_acc != 0
    if ordered:
        assert isinstance(turns, int) and turns != 0
    else:
        assert turns is None


def test_backward_c_signature_takes_the_turns():
    """The C entries declare the turns where the wrapper passes them (the
    build test checks the argtypes against the same source)."""
    source = (_build.CSRC / "flash_mha_bwd.cu").read_text()
    for entry in ("flash_mha_bwd_f32", "flash_mha_bwd_bf16"):
        head = source[source.index(f"int {entry}("):]
        params = head[:head.index(")")].split(",")
        assert params[8].split()[-1] == "dq_acc" and params[9].split()[-1] == "turns"
        assert params[9].split()[0] == "unsigned*"


# (query tiles, key blocks) of the released shapes (freq self, time self, cross, both ways;
# bf16 64-row tiles x 128- or 64-key blocks, fp32 32-row tiles x 64 keys), ragged and small
# ones, more blocks than tiles (offsets shared: ties by block), one tile, one block
SHAPES = [(42, 21), (21, 11), (42, 11), (21, 21), (42, 42), (21, 42), (84, 42), (84, 21),
          (42, 84), (5, 24), (3, 7), (1, 5), (6, 1), (1, 1), (13, 13), (17, 9)]


@pytest.mark.parametrize("n_qt,n_kb", SHAPES)
@pytest.mark.parametrize("stagger", [True, False])
def test_bwd_order_adds_each_tile_once(n_qt, n_kb, stagger):
    """Every key block walks every query tile once, and on every tile every
    block has one place in the order: each (tile, block) is added exactly
    once, and the kernel's closed form of a block's place (Walk::turn, its
    twin bwd_turn) is the place the order gives it."""
    for x in range(n_kb):
        assert sorted(K.bwd_walk(x, n_qt, n_kb, stagger)) == list(range(n_qt))
    order = K.bwd_order(n_qt, n_kb, stagger)
    assert len(order) == n_qt
    for t, blocks in enumerate(order):
        assert sorted(blocks) == list(range(n_kb))
        assert [K.bwd_turn(x, t, n_qt, n_kb, stagger) for x in blocks] == list(range(n_kb))
    if not stagger:  # the plain order: key-block order on every tile, every walk from tile 0
        assert all(blocks == list(range(n_kb)) for blocks in order)
        assert all(K.bwd_walk(x, n_qt, n_kb, False) == list(range(n_qt)) for x in range(n_kb))


@pytest.mark.parametrize("n_qt,n_kb", SHAPES)
@pytest.mark.parametrize("stagger", [True, False])
def test_bwd_waits_point_to_smaller_step_and_block(n_qt, n_kb, stagger):
    """On every tile each block waits for the one before it in the order,
    which reaches the tile at a strictly smaller (step, block): the waits of
    a head form no cycle."""
    steps = [{t: k for k, t in enumerate(K.bwd_walk(x, n_qt, n_kb, stagger))}
             for x in range(n_kb)]
    for t, blocks in enumerate(K.bwd_order(n_qt, n_kb, stagger)):
        keys = [(steps[x][t], x) for x in blocks]
        assert all(a < b for a, b in zip(keys, keys[1:]))


def _lockstep_stalls(n_qt: int, n_kb: int, stagger: bool) -> int:
    """The steps lost to waiting when every block of a head runs one step a
    tick and a tile's turn passes on at the tick after the addition: a block
    whose turn has not come waits where it is."""
    order = K.bwd_order(n_qt, n_kb, stagger)
    place = [{x: p for p, x in enumerate(blocks)} for blocks in order]
    walks = [K.bwd_walk(x, n_qt, n_kb, stagger) for x in range(n_kb)]
    counters, done, stalls = [0] * n_qt, [0] * n_kb, 0
    while min(done) < n_qt:
        passed = []
        for x in range(n_kb):
            if done[x] == n_qt:
                continue
            t = walks[x][done[x]]
            if counters[t] == place[t][x]:
                passed.append(t)
                done[x] += 1
            else:
                stalls += 1
        assert passed, "no block could go on"
        for t in passed:
            counters[t] += 1
    return stalls


@pytest.mark.parametrize("n_qt,n_kb", [s for s in SHAPES if s[1] <= s[0]])
def test_bwd_staggered_walks_wait_for_nothing_in_lockstep(n_qt, n_kb):
    """Where a head has no more key blocks than query tiles (every released
    shape), the staggered walks in lockstep never wait: each block's
    predecessor on a tile reached it a step or more earlier. The plain order
    loses at least a step per block behind the first (the chain)."""
    assert _lockstep_stalls(n_qt, n_kb, True) == 0
    assert _lockstep_stalls(n_qt, n_kb, False) >= n_kb * (n_kb - 1) // 2


@pytest.mark.parametrize("n_qt,n_kb", [s for s in SHAPES if s[1] > 1])
def test_bwd_staggered_order_waits_on_later_blocks(n_qt, n_kb):
    """Why the staggered grid gives each block its items by rounds, known
    ahead, and not from the item counter with the next item read ahead: in
    the staggered order a later key block of a head precedes an earlier one
    on some tile (its walk starts nearer), so a block that took a later
    block of its own head to run next would wait on itself. In the plain
    order no later block precedes an earlier one."""
    def later_first(stagger):
        return any(blocks.index(y) < blocks.index(x)
                   for blocks in K.bwd_order(n_qt, n_kb, stagger)
                   for x in range(n_kb) for y in range(x + 1, n_kb))

    assert later_first(True) is (n_qt > 1)
    assert not later_first(False)


def _interleavings_finish(n_qt: int, n_kb: int, stagger: bool, ring: int, seed: int) -> bool:
    """A head's blocks under a random interleaving of their roles: a block's
    consumers make step k once its writers have taken step k - ring out of
    the ring; a writer adds a step made by its consumers when the tile's turn
    is its own, then passes the turn on. True when every block finishes;
    False when nothing can move (a deadlock)."""
    order = K.bwd_order(n_qt, n_kb, stagger)
    place = [{x: p for p, x in enumerate(blocks)} for blocks in order]
    walks = [K.bwd_walk(x, n_qt, n_kb, stagger) for x in range(n_kb)]
    made, added, counters = [0] * n_kb, [0] * n_kb, [0] * n_qt
    rng = random.Random(seed)
    while min(added) < n_qt:
        moves = [("make", x) for x in range(n_kb) if made[x] < n_qt and made[x] - added[x] < ring]
        moves += [("add", x) for x in range(n_kb) if added[x] < made[x]
                  and counters[walks[x][added[x]]] == place[walks[x][added[x]]][x]]
        if not moves:
            return False
        kind, x = rng.choice(moves)
        if kind == "make":
            made[x] += 1
        else:
            counters[walks[x][added[x]]] += 1
            added[x] += 1
    return counters == [n_kb] * n_qt


@pytest.mark.parametrize("n_qt,n_kb", SHAPES)
@pytest.mark.parametrize("stagger", [True, False])
@pytest.mark.parametrize("ring", [1, 2, 3])
def test_bwd_order_never_deadlocks_a_resident_head(n_qt, n_kb, stagger, ring):
    """With all of a head's blocks resident (what the cooperative grid's
    rounds give), every interleaving tried finishes, at every ring depth."""
    assert all(_interleavings_finish(n_qt, n_kb, stagger, ring, seed) for seed in range(5))


@pytest.mark.parametrize("B,H,n_kb,capacity", [
    (8, 8, 21, 132), (1, 8, 21, 132), (8, 8, 42, 132), (8, 8, 42, 264), (8, 8, 11, 132),
    (3, 5, 7, 20), (1, 1, 132, 132), (2, 3, 1, 4), (1, 2, 133, 132), (1, 2, 266, 264)])
def test_bwd_rounds_cover_every_head_once(B, H, n_kb, capacity):
    """Rounds of whole heads: every (batch, head) in exactly one round, no
    round asks for more blocks than are resident, the grid is the largest
    round; past the capacity, the plain key-block order on at most the resident
    blocks (they take their items from a counter)."""
    got = K.bwd_rounds(B, H, n_kb, capacity)
    if n_kb > capacity:
        assert not got["stagger"] and got["rounds"] is None
        assert got["grid"] == min(capacity, B * H * n_kb)
        return
    assert got["stagger"]
    heads = [head for rnd in got["rounds"] for head in rnd]
    assert sorted(heads) == list(range(B * H))
    assert all(len(rnd) * n_kb <= got["grid"] <= capacity for rnd in got["rounds"])
    assert got["grid"] == got["heads_per_round"] * n_kb
    # block c of the grid takes item c + r * grid, r = 0, 1, ...: round r's heads
    for r, rnd in enumerate(got["rounds"]):
        items = [c + r * got["grid"] for c in range(got["grid"]) if c + r * got["grid"]
                 < B * H * n_kb]
        assert sorted({i // n_kb for i in items}) == rnd


@pytest.mark.parametrize("keys,per_sm,Tk,stagger", [
    (128, 1, 2688, True), (64, 2, 2688, True), (128, 1, 16896, True), (128, 1, 17000, False),
    (64, 2, 17000, False), (64, 1, 8448, True), (64, 1, 9000, False)])
def test_bwd_plan_takes_key_block_order_past_the_capacity(keys, per_sm, Tk, stagger):
    """On a 132-SM card (one block an SM of 128-key bf16 blocks or of fp32's
    64 keys, two of 64-key bf16 blocks): the staggered order while a head's
    key blocks fit the resident blocks, the plain key-block order past them;
    at the released freq self (B = 8, 8 heads) rounds of whole heads."""
    capacity, n_kb = per_sm * 132, -(-Tk // keys)
    plan = K.bwd_rounds(1, 2, n_kb, capacity)
    assert plan["stagger"] is stagger is (n_kb <= capacity)
    assert plan["grid"] <= capacity
    released = K.bwd_rounds(8, 8, -(-2688 // keys), capacity)
    assert released["stagger"] and len(released["rounds"]) == -(-64 // released["heads_per_round"])


class _FakePlanLib:
    """The backward library's plan entry: writes ``plan`` and returns ``status``."""

    def __init__(self, plan, status=0):
        self.plan, self.status, self.calls = plan, status, []

    def flash_mha_bwd_ordered_plan(self, *args):
        self.calls.append(args[:-1])
        for i, value in enumerate(self.plan):
            args[-1][i] = value
        return self.status


@pytest.mark.parametrize("dtype,keys,plan,agrees", [
    # n_qt, n_kb, blocks an SM, SMs, grid, staggered, ring: freq self at B = 8
    (torch.bfloat16, 128, (42, 21, 1, 132, 126, 1, 3), True),
    (torch.bfloat16, 64, (42, 42, 2, 132, 252, 1, 2), True),
    (torch.float32, 64, (84, 42, 1, 132, 126, 1, 1), True),
    # a grid or an order other than the twin's is reported as such
    (torch.bfloat16, 128, (42, 21, 1, 132, 132, 1, 3), False),
    (torch.float32, 64, (84, 42, 1, 132, 126, 0, 1), False)])
def test_bwd_plan_reads_the_launch_plan(monkeypatch, dtype, keys, plan, agrees):
    """bwd_plan reports what the kernel's launch computes (the C entry
    flash_mha_bwd_ordered_plan): the sizes it is asked for, the route and
    the keys go in; the grid, the order and the ring come out, with the
    resident blocks, the rounds of heads and whether the CPU twin agrees."""
    fake = _FakePlanLib(plan)
    monkeypatch.setattr(K, "_bwd_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    got = K.bwd_plan(dtype, keys, 8, 2688, 2688, 8, 64, device=torch.device("cuda", 0))
    assert fake.calls == [(int(dtype == torch.bfloat16), 8, 2688, 2688, 8, 64, keys)]
    assert (got["n_qt"], got["n_kb"], got["grid"], got["ring"]) == (plan[0], plan[1], plan[4],
                                                                     plan[6])
    assert got["stagger"] is bool(plan[5]) and got["capacity"] == plan[2] * plan[3]
    assert got["twin_agrees"] is agrees
    if agrees:
        assert got["n_rounds"] == -(-64 // (got["grid"] // got["n_kb"]))


def test_bwd_plan_raises_on_a_failed_query(monkeypatch):
    monkeypatch.setattr(K, "_bwd_lib", lambda: _FakePlanLib((0,) * 7, status=1))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="flash_mha_bwd_ordered_plan"):
        K.bwd_plan(torch.float32, 64, 1, 64, 64, 1, 32, device=torch.device("cuda", 0))


@pytest.mark.parametrize("B,Tk,H", [(1, 2688, 8), (8, 2688, 8), (1, 2112, 8), (8, 1344, 8)])
def test_bwd_keys_take_128_under_the_flag(deterministic, B, Tk, H):
    """Under torch.use_deterministic_algorithms the bf16 backward prices
    64-key blocks (half the dQ ring, twice the turns) above 128-key ones:
    128 keys at the released shapes, also where the default plan takes 64."""
    assert K.bwd_keys(B, Tk, H, 132) == 128
