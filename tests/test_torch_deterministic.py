"""K3's backward under torch.use_deterministic_algorithms (C5): the wrapper
hands the kernel a counter per (batch, head, query tile), with which the key
blocks add their parts of dQ in key-block order; without the flag it hands
none and the blocks add in the order they finish. The kernel itself runs
only on the card (tests/test_torch_cuda.py); here the C entry is a fake that
records what the wrapper passes."""

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
    # one counter per query tile of the fp32 route (32 rows), which has more than bf16's (64)
    assert turns.dtype == torch.int32 and turns.numel() == B * H * -(-Tq // 32)
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
