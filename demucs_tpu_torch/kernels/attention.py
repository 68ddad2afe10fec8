"""K3: fused multi-head attention over projected q/k/v.

Replaces ``demucs_tpu/ops/pallas/attention.py`` (``flash_mha``, kernel
``_attn_kernel``) with the kernels of ``csrc/flash_mha.cu``, by the dtype of
the inputs (the Pallas kernel takes any float dtype):

- fp32 (:func:`flash_mha`'s own launch): both products on the H100's tensor
  cores (``wgmma``) in the three-term TF32 split, which keeps fp32-level
  accuracy whatever ``torch.backends`` says about TF32 (more accurate than
  any matmul precision string); each launch first lays K and V out, split
  and with V transposed, as the shared-memory image the products read, in a
  scratch tensor.
- bf16 (:func:`flash_mha_bf16`): one bf16 ``wgmma`` per product with fp32
  accumulation; one producer thread brings K and V in by the tensor memory
  accelerator (3-D tensor maps encoded per call); each consumer warpgroup
  issues a tile's S with the previous tile's P V and runs the softmax while
  that P V is on the tensor cores, and the warpgroups take turns to issue;
  the softmax scale folded into one FFMA per score; P packed to bf16 in
  registers; the output in bf16. Either a block per row block, or one block
  per SM walking an even share of the (row block, key tile) units, with a
  second small kernel merging the partial sums of the row blocks that two
  blocks share; a cost model picks (:func:`bf16_plan`, :func:`bf16_schedule`).

Both: an online softmax over tiles of keys (64 on the fp32 route,
``KEY_TILE_BF16`` on the bf16 route) with fp32 accumulators; an optional
``(Tq, Tk)`` boolean keep-mask shared by batch and heads; the -inf-safe
rescale (a fully masked row gives NaN, as the plain softmax does). Head dims
32, 48 and 64. The plain version is
:func:`demucs_tpu_torch.ops.attention.multihead_attention`. Any other dtype
on the card raises.

Training, on both routes: the Pallas kernel's hashed dropout of the
probabilities (``dropout``, ``dropout_seed``; ``csrc/attention_dropout.cuh``,
bit for bit the pattern of the plain version's
:func:`~demucs_tpu_torch.ops.attention.dropout_keep`), and a gradient: each
route's launch is an autograd node (:class:`_FlashMHA`) whose forward also
keeps each row's log-sum-exp when a gradient is wanted and whose backward
launches the hand-written backward kernel of ``csrc/flash_mha_bwd.cu`` in
the inputs' type (:func:`flash_mha_bwd`, :func:`flash_mha_bwd_bf16`): one
pass over the queries per block of keys, five ``wgmma`` products a tile (3xTF32
or bf16), the operands brought in by tensor-map copies, dQ summed across the
blocks by fp32 reductions in L2: in the order the blocks finish (its last
bits may differ from run to run), or, under
``torch.use_deterministic_algorithms(True)``, in an order fixed by the shape
(:func:`dq_turns`, :func:`bwd_order`: each block of keys walks the query
tiles from a tile of its own, the order follows the walks, writers outside
the consumer warpgroups add; a cooperative grid, :func:`bwd_rounds`), bit
for bit the same every run.

A call that wants no gradient and no dropout is the registered op
``demucs_tpu_torch::flash_mha`` (:func:`flash_mha_op`; ``torch.library``):
its CUDA kernel is the route of the dtype, its CPU kernel the plain version,
and a fake kernel gives the shape. ``torch.export`` keeps the op as one
node, so an exported program (the HTDemucs core, ``export/core.py``)
launches K3 wherever it runs. Each route's launch count sits where it
launches (``_forward_f32``, ``_forward_bf16``), so the op, the autograd node
and a program all count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.ops.attention import _split_heads, dropout_keep, multihead_attention

__all__ = ["flash_mha", "flash_mha_op", "flash_mha_bf16", "flash_mha_plain", "flash_mha_bwd",
           "flash_mha_bwd_bf16", "flash_mha_bwd_plain", "HEAD_DIMS", "KEY_TILE",
           "KEY_TILE_BF16", "q_scale", "bf16_plan", "bf16_schedule", "bf16_tiles", "bwd_keys",
           "bwd_walk", "bwd_turn", "bwd_order", "bwd_rounds", "bwd_plan"]

HEAD_DIMS = (32, 48, 64)
KEY_TILE = 64  # keys per tile of the fp32 route's loop
# Query rows per block of the fp32 route: 64 (one consumer warpgroup) or 128
# (two, which overlap one's softmax with the other's products; the faster at
# every released shape and batch on the H100, PERF.md).
BLOCK_ROWS = 128
# The bf16 route's plan (chip_smoke.py sweeps every part on the H100,
# PERF.md): keys per tile (64 or 128); query rows per block, 128 or 192 (two
# or three consumer warpgroups); whether one block per SM walks an even share
# of all the work (the persistent schedule) or each block takes a row block.
# None leaves the choice to bf16_plan.
KEY_TILE_BF16 = 128
BF16_ROWS = None
BF16_PERSISTENT = None
# bf16_plan's model of the kernel's time, in units of one key tile against
# 128 query rows on one SM. The constants are fitted to chip_smoke.py's sweep
# on the H100 (PERF.md), where the model picks the fastest plan at every
# released shape, at one segment and at six.
_ROWS_COST = {128: 1.0, 192: 1.3}  # a key tile at 128 and at 192 rows
_BLOCK_START = 3.0  # a block of the plain grid: its Q, first S and softmax, last P V, stores
_PIECE_START = 1.5  # a row block inside a persistent block, whose loads run ahead
_MERGE = 5.0  # the second kernel, which merges the row blocks that two blocks share
# The bf16 backward kernel's keys per block (csrc/flash_mha_bwd.cu): 64 (one
# consumer warpgroup, two blocks per SM) or 128 (two warpgroups, one block
# per SM); None leaves the choice to bwd_keys (chip_smoke.py sweeps both).
# The fp32 route's block always holds 64: its operand images fill the SM.
BWD_KEYS_BF16 = None
# bwd_keys's model: the time of 64 keys' work on a whole SM, relative, for the
# two block sizes (128 keys: one block an SM; 64 keys: two blocks share it),
# fitted to chip_smoke.py's sweep on the H100 (PERF.md); the second under
# torch.use_deterministic_algorithms, where 64-key blocks have half the dQ
# ring and the Q/dO ring of 128-key blocks and twice the turns a tile.
_BWD_COST = {64: 1.02, 128: 1.0}
_BWD_COST_ORDERED = {64: 1.4, 128: 1.0}
# A status at or above this from flash_mha_bf16 is a failed tensor-map
# encode (csrc/tensor_map.cuh ENCODE_FAILED), plus the driver's CUresult.
_ENCODE_FAILED = 10000


# The plain version of K3, used for CPU tensors and as the kernel's oracle.
flash_mha_plain = multihead_attention


def q_scale(head_dim: int) -> float:
    """The softmax scale in base 2, log2(e)/sqrt(d): the fp32 route multiplies
    q by it before the split, the bf16 route folds it into each fp32 score's
    FFMA with the row max."""
    return math.log2(math.e) / math.sqrt(head_dim)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels read 16-byte rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_mha_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, f, i, p]
    lib.flash_mha_f32.restype = i
    lib.flash_mha_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, i, f, i, p]
    lib.flash_mha_bf16.restype = i
    lib.flash_mha_bf16_tiles.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.flash_mha_bf16_tiles.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_mha_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("flash_mha_bwd_f32", "flash_mha_bwd_bf16"):
        getattr(lib, name).argtypes = [p] * 13 + [i] * 6 + [f, f, f, i, p]
        getattr(lib, name).restype = i
    lib.flash_mha_bwd_ordered_plan.argtypes = [i] * 7 + [p]
    lib.flash_mha_bwd_ordered_plan.restype = i
    return lib


def _seed32(rate: float, seed) -> int:
    """The dropout seed's 32 bits, as a uint32 (the Pallas kernel casts its
    int32 seed to uint32; the C entry points take them as an int)."""
    if rate <= 0.0:
        return 0
    if seed is None:
        raise ValueError("dropout > 0 requires dropout_seed")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(seed) & 0xFFFFFFFF


def _int32(bits: int) -> int:
    """A uint32 as the C int of the same bits."""
    return bits - (1 << 32) if bits >= 1 << 31 else bits


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
             mask: torch.Tensor | None, dtype: torch.dtype):
    """Shapes, head dim and dtype of a CUDA launch -> (B, Tq, Tk, d, keep)."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, C) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if C % num_heads:
        raise ValueError(f"{C} channels do not split into {num_heads} heads")
    d = C // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha supports head dims {HEAD_DIMS}, got {d}")
    if Tk == 0:
        raise ValueError("flash_mha needs at least one key")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise TypeError(f"this route of flash_mha takes {dtype} CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
    keep = None
    if mask is not None:
        if tuple(mask.shape) != (Tq, Tk):
            raise ValueError(f"mask {tuple(mask.shape)} is not (Tq, Tk) = {(Tq, Tk)}")
        keep = mask.to(device=q.device, dtype=torch.uint8).contiguous()
    return B, Tq, Tk, d, keep


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              *, mask: torch.Tensor | None = None, dropout: float = 0.0,
              dropout_seed: int | None = None) -> torch.Tensor:
    """Attention of ``q (B, Tq, C)`` over ``k, v (B, Tk, C)`` with ``num_heads``
    heads -> ``(B, Tq, C)`` in their dtype (before the output projection).

    ``mask``: optional boolean keep-mask ``(Tq, Tk)``. ``dropout`` /
    ``dropout_seed`` (a host int, which the caller draws from its generator):
    the hashed train-time dropout of the probabilities. A call that wants no
    gradient and no dropout is the registered op ``demucs_tpu_torch::flash_mha``
    (what ``torch.export`` traces): its CPU kernel is the plain version, its
    CUDA kernel K3 on the route of the dtype. Otherwise a CPU tensor takes
    the plain version and a CUDA tensor the autograd node :class:`_FlashMHA`
    (fp32 here, bf16 through :func:`flash_mha_bf16`), whose gradient is the
    backward kernel of its route. Any other CUDA input raises.
    ``flash_mha.launches`` counts the fp32 route's forward launches.
    """
    seed = _seed32(dropout, dropout_seed)
    if dropout == 0.0 and not _wants_grad(q, k, v):
        return torch.ops.demucs_tpu_torch.flash_mha(q, k, v, num_heads, mask)
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, mask=mask, dropout=dropout,
                               dropout_seed=seed)
    if q.dtype == torch.bfloat16:
        return flash_mha_bf16(q, k, v, num_heads, mask=mask, dropout=dropout,
                              dropout_seed=seed)
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, torch.float32)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashMHA.apply(q, k, v, num_heads, keep, float(dropout), seed, _wants_grad(q, k, v))


@torch.library.custom_op("demucs_tpu_torch::flash_mha", mutates_args=(), device_types="cpu")
def flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """K3's inference forward as a registered op (no dropout, no gradient):
    on the CPU the plain version; on the card (the ``cuda`` kernel below) the
    hand-written kernel of the dtype's route, which raises on what it does not
    take. ``torch.export`` keeps it as one node, so an exported program runs
    K3 wherever it is loaded."""
    return flash_mha_plain(q, k, v, num_heads, mask=mask)


@flash_mha_op.register_kernel("cuda")
def _flash_mha_op_cuda(q, k, v, num_heads, mask=None):
    dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, dtype)
    if B * Tq == 0:
        return torch.empty_like(q)
    route = _forward_bf16 if dtype == torch.bfloat16 else _forward_f32
    return route(_aligned(q), _aligned(k), _aligned(v), num_heads, keep, 0.0, 0, False)[0]


@flash_mha_op.register_fake
def _flash_mha_op_fake(q, k, v, num_heads, mask=None):
    return torch.empty_like(q)


def _wants_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd will ask for the launch's gradient (then the forward
    keeps each row's log-sum-exp for the backward kernel)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _forward_f32(q, k, v, num_heads: int, keep, rate: float, seed: int, want_lse: bool):
    """One launch of the fp32 route -> (o, lse or None)."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    d = C // num_heads
    out = torch.empty_like(q)
    image = torch.empty(B, num_heads, -(-Tk // KEY_TILE), 4, KEY_TILE * d, device=q.device)
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    status = _lib().flash_mha_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if keep is None else keep.data_ptr(), image.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Tq, Tk, num_heads, d, q_scale(d), BLOCK_ROWS, rate, _int32(seed),
        _build.stream_ptr(q.device))
    _build.check(status, "flash_mha_f32")
    flash_mha.launches += 1
    return out, lse


class _FlashMHA(torch.autograd.Function):
    """K3 as an autograd node, on the route of its inputs' dtype: the forward
    kernel (keeping each row's log-sum-exp when a gradient is wanted), then
    the backward kernel of the same route (:func:`flash_mha_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, keep, rate, seed, want_lse):
        route = _forward_bf16 if q.dtype == torch.bfloat16 else _forward_f32
        out, lse = route(q, k, v, num_heads, keep, rate, seed, want_lse)
        if want_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (num_heads, keep, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        num_heads, keep, rate, seed = ctx.args
        dq, dk, dv = flash_mha_bwd(q, k, v, out, dout, num_heads, lse=lse, mask=keep,
                                   dropout=rate, dropout_seed=seed)
        return dq, dk, dv, None, None, None, None, None


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor, num_heads: int, *, lse: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None, dropout: float = 0.0,
                        dropout_seed: int | None = None) -> tuple:
    """The plain version of :func:`flash_mha_bwd`, the backward formula
    written out in fp32 (it recomputes the softmax and does not read ``lse``):
    with ``P = softmax(S)``, ``Z`` the dropout's keep / (1 - rate) (or 1) and
    ``D = rowsum(dO o)``: ``dV = (Z P)^T dO``, ``dS = P (Z dO V^T - D)``,
    ``dQ = dS K / sqrt(d)``, ``dK = dS^T Q / sqrt(d)``."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    d = C // num_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, oh, dh = (_split_heads(t.float(), num_heads) for t in (q, k, v, o, dout))
    scores = (qh * scale) @ kh.transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(~mask.to(device=q.device, dtype=torch.bool), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    z = None
    if dropout > 0.0:
        keep = dropout_keep(B * num_heads, Tq, Tk, dropout, _seed32(dropout, dropout_seed),
                            q.device).view(B, num_heads, Tq, Tk)
        z = keep.float() / (1.0 - dropout)
    pz = p if z is None else p * z
    dp = dh @ vh.transpose(-1, -2)
    if z is not None:
        dp = dp * z
    ds = p * (dp - (dh * oh).sum(-1, keepdim=True))
    merge = lambda t: t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], C)  # noqa: E731
    dq = merge(ds @ kh * scale)
    dk = merge(ds.transpose(-1, -2) @ qh * scale)
    dv = merge(pz.transpose(-1, -2) @ dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  dout: torch.Tensor, num_heads: int, *, lse: torch.Tensor,
                  mask: torch.Tensor | None = None, dropout: float = 0.0,
                  dropout_seed: int | None = None) -> tuple:
    """K3's backward: ``(dq, dk, dv)`` of :func:`flash_mha` at ``q, k, v``
    with output ``o`` and its gradient ``dout``, from the forward's ``lse (B
    * H, Tq)`` and its ``mask``, ``dropout`` and ``dropout_seed``. A CPU
    tensor takes :func:`flash_mha_bwd_plain`; an fp32 CUDA tensor launches
    ``csrc/flash_mha_bwd.cu`` (the row dots, one pass for dQ, dK and dV in
    3xTF32 ``wgmma`` over blocks of 64 keys, dQ's sums out), a bf16 one
    :func:`flash_mha_bwd_bf16`; anything else raises.
    ``flash_mha_bwd.launches`` counts the fp32 route's launches."""
    seed = _seed32(dropout, dropout_seed)
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, o, dout, num_heads, mask=mask, dropout=dropout,
                                   dropout_seed=seed)
    if q.dtype == torch.bfloat16:
        return flash_mha_bwd_bf16(q, k, v, o, dout, num_heads, lse=lse, mask=mask,
                                  dropout=dropout, dropout_seed=seed)
    grads = _launch_bwd("flash_mha_bwd_f32", torch.float32, q, k, v, o, dout, num_heads, lse,
                        mask, dropout, seed)
    flash_mha_bwd.launches += 1
    return grads


def flash_mha_bwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       dout: torch.Tensor, num_heads: int, *, lse: torch.Tensor,
                       mask: torch.Tensor | None = None, dropout: float = 0.0,
                       dropout_seed: int | None = None) -> tuple:
    """K3's backward on the bf16 route: as :func:`flash_mha_bwd`, bf16 in and
    out (fp32 ``lse``), bf16 ``wgmma`` products with fp32 accumulation, the
    keys per block by :func:`bwd_keys`. A CPU tensor takes
    :func:`flash_mha_bwd_plain`; a bf16 CUDA tensor launches
    ``csrc/flash_mha_bwd.cu`` (the row dots, the pass, dQ's rounding);
    anything else raises.
    ``flash_mha_bwd_bf16.launches`` counts its launches."""
    seed = _seed32(dropout, dropout_seed)
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, o, dout, num_heads, mask=mask, dropout=dropout,
                                   dropout_seed=seed)
    grads = _launch_bwd("flash_mha_bwd_bf16", torch.bfloat16, q, k, v, o, dout, num_heads, lse,
                        mask, dropout, seed)
    flash_mha_bwd_bf16.launches += 1
    return grads


def _launch_bwd(entry: str, dtype: torch.dtype, q, k, v, o, dout, num_heads: int, lse, mask,
                rate: float, seed: int) -> tuple:
    """One launch of ``csrc/flash_mha_bwd.cu``'s C entry ``entry`` on ``dtype``
    CUDA tensors -> ``(dq, dk, dv)``."""
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, dtype)
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{entry}: {name} must be a {dtype} {tuple(q.shape)} tensor on "
                             f"{q.device}")
    if lse is None or lse.shape != (B * num_heads, Tq) or lse.dtype != torch.float32:
        raise ValueError(f"{entry}: lse must be float32 {(B * num_heads, Tq)}")
    q, k, v, o, dout, lse = (_aligned(t) for t in (q, k, v, o, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each row's lse and D = dO . o, padded to tiles of 64 (bf16) or 32 (fp32)
    stats = torch.empty(B * num_heads * -(-Tq // 64) * 128, device=q.device)
    # dQ's fp32 sums over the blocks of keys, per tile of queries (the launch zeroes them)
    dq_acc = torch.empty(B * num_heads * -(-Tq // 64) * 64 * d, device=q.device)
    turns = dq_turns(B, num_heads, Tq, q.device)
    keys = (bwd_keys(B, Tk, num_heads, _sm_count(q.device.index or 0))
            if dtype == torch.bfloat16 else 64)
    status = getattr(_bwd_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), None if keep is None else keep.data_ptr(), stats.data_ptr(),
        dq_acc.data_ptr(), None if turns is None else turns.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, num_heads,
        d, keys, q_scale(d), 1.0 / math.sqrt(d), float(rate), _int32(seed),
        _build.stream_ptr(q.device))
    _check_launch(status, entry)
    return dq, dk, dv


def dq_turns(B: int, num_heads: int, Tq: int, device) -> torch.Tensor | None:
    """The backward kernel's turns under ``torch.use_deterministic_algorithms``:
    a counter per (batch, head, query tile of 32 or more rows) that orders
    the blocks' additions to dQ (:func:`bwd_order`), then the cooperative
    grid's item counter (:func:`bwd_rounds`); the launch zeroes them. dQ
    then repeats bit for bit. None otherwise (dQ's blocks add in the order
    they finish, its last bits may differ between launches)."""
    if not torch.are_deterministic_algorithms_enabled():
        return None
    return torch.empty(B * num_heads * -(-Tq // 32) + 1, dtype=torch.int32, device=device)


def bwd_walk(x: int, n_qt: int, n_kb: int, stagger: bool = True) -> list:
    """The query tiles key block ``x`` of ``n_kb`` walks, step by step, in the
    deterministic backward (csrc/flash_mha_bwd.cu ``Walk::tile``): staggered,
    from its own tile ``x n_qt // n_kb`` round the ``n_qt`` tiles; else (the
    plain order) from tile 0."""
    o = x * n_qt // n_kb if stagger else 0
    return [(o + k) % n_qt for k in range(n_qt)]


def bwd_turn(x: int, t: int, n_qt: int, n_kb: int, stagger: bool = True) -> int:
    """Key block ``x``'s position in tile ``t``'s order, in closed form as the
    kernel computes it (``Walk::turn``): the blocks whose walk starts
    cyclically after its own and at or before ``t``, and those that start with
    it and have a smaller index. :func:`bwd_order` defines the order."""
    if not stagger:
        return x
    o = x * n_qt // n_kb

    def upto(v):  # the blocks whose walk starts at tile v or before
        return -(-(v + 1) * n_kb // n_qt)

    ahead = upto(t) - upto(o) if t >= o else n_kb - upto(o) + upto(t)
    return ahead + x - upto(o - 1)


def bwd_order(n_qt: int, n_kb: int, stagger: bool = True) -> list:
    """Per query tile, the key blocks in the order they add their parts of
    dQ under ``torch.use_deterministic_algorithms``: by the step at which
    their walks (:func:`bwd_walk`) reach the tile, ties by block. The plain
    order (``stagger=False``) is 0, 1, ... on every tile."""
    steps = [{t: k for k, t in enumerate(bwd_walk(x, n_qt, n_kb, stagger))}
             for x in range(n_kb)]
    return [sorted(range(n_kb), key=lambda x: (steps[x][t], x)) for t in range(n_qt)]


def bwd_rounds(B: int, num_heads: int, n_kb: int, capacity: int) -> dict:
    """The CPU twin of the deterministic backward's cooperative grid
    (csrc/flash_mha_bwd.cu ``ordered_plan``; :func:`bwd_plan` reads the
    launch's) for ``n_kb`` key blocks a head and ``capacity``
    resident blocks: where a head's blocks fit, the staggered order in rounds
    of ``capacity // n_kb`` whole heads (at most all), block c taking item c
    (key block fastest, then head) of each round, and ``rounds`` lists each
    round's heads; otherwise the plain order on ``min(capacity, items)``
    blocks, which take their items from a counter (``rounds`` None)."""
    heads = B * num_heads
    if n_kb <= capacity:
        per = min(capacity // n_kb, heads)
        return dict(stagger=True, grid=per * n_kb, heads_per_round=per,
                    rounds=[list(range(r, min(r + per, heads))) for r in range(0, heads, per)])
    return dict(stagger=False, grid=min(capacity, heads * n_kb), heads_per_round=0, rounds=None)


_PLAN = ("n_qt", "n_kb", "blocks_per_sm", "sms", "grid", "stagger", "ring")


def bwd_plan(dtype: torch.dtype, keys: int, B: int, Tq: int, Tk: int, num_heads: int, d: int,
             device=None) -> dict:
    """The plan of the deterministic backward's launch at these sizes on the
    card (``device``, the current one by default), as the launch computes it
    (``csrc/flash_mha_bwd.cu`` ``ordered_plan``): a head's query tiles and
    key blocks, the blocks an SM holds, the SMs, the blocks launched, the
    order (staggered, else key-block order), the depth of the dQ ring; then
    the resident blocks (``capacity``), the rounds of heads and whether the
    CPU twin (:func:`bwd_rounds`) chose the same grid and order. ``keys``:
    keys per block (64 or 128 on the bf16 route, 64 on the fp32 route)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bwd_plan: float32 or bfloat16, got {dtype}")
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    out = (ctypes.c_int * len(_PLAN))()
    with torch.cuda.device(device):
        status = _bwd_lib().flash_mha_bwd_ordered_plan(
            int(dtype == torch.bfloat16), B, Tq, Tk, num_heads, d, keys, out)
    _build.check(status, "flash_mha_bwd_ordered_plan")
    plan = dict(zip(_PLAN, out), keys=keys)
    plan["stagger"] = bool(plan["stagger"])
    plan["capacity"] = plan["blocks_per_sm"] * plan["sms"]
    twin = bwd_rounds(B, num_heads, plan["n_kb"], plan["capacity"])
    plan["heads_per_round"] = twin["heads_per_round"]
    plan["n_rounds"] = None if twin["rounds"] is None else len(twin["rounds"])
    plan["twin_agrees"] = twin["grid"] == plan["grid"] and twin["stagger"] == plan["stagger"]
    return plan


def bwd_keys(B: int, Tk: int, num_heads: int, sm_count: int) -> int:
    """Keys per block of the bf16 backward kernel, 64 or 128: the one the
    model prices lowest, the blocks an SM takes at once (one of 128 keys,
    two of 64) times ``_BWD_COST`` (``_BWD_COST_ORDERED`` under
    ``torch.use_deterministic_algorithms``), at least one such round. The
    last block of each head covers keys past Tk: 128-key blocks waste more
    of a ragged Tk. ``BWD_KEYS_BF16`` fixes the choice."""
    if BWD_KEYS_BF16 is not None:
        return BWD_KEYS_BF16
    costs = _BWD_COST_ORDERED if torch.are_deterministic_algorithms_enabled() else _BWD_COST
    best = None
    for keys, per_sm in ((128, 1), (64, 2)):
        blocks = -(-Tk // keys) * num_heads * B
        cost = max(blocks / (per_sm * sm_count), 1.0) * costs[keys]
        if best is None or cost < best[0]:
            best = (cost, keys)
    return best[1]


def _ranges(units: int, ctas: int) -> list:
    """The first unit of each of the persistent schedule's ``ctas`` ranges,
    then ``units``: as even as they come, the first ``units % ctas`` one
    longer (csrc/flash_mha.cu ``Schedule::lo``)."""
    q, rem = divmod(units, ctas)
    return [c * q + min(c, rem) for c in range(ctas + 1)]


def _splits(lo: list, n_tiles: int) -> bool:
    """Whether a range starts inside a row block: then the kernel writes
    partial sums and the merge kernel runs."""
    return any(u % n_tiles for u in lo[1:-1])


@functools.lru_cache(maxsize=None)
def _plan_cost(blocks: int, n_tiles: int, rows: int, ctas: int, persistent: bool,
               sm_count: int) -> float:
    """The modelled time of a plan: the plain grid's waves, or the persistent
    schedule's longest range with a start for each row block it touches."""
    if not persistent:
        return -(-blocks // sm_count) * (n_tiles + _BLOCK_START) * _ROWS_COST[rows]
    lo = _ranges(blocks * n_tiles, ctas)
    longest = max(lo[c + 1] - lo[c] + _PIECE_START * ((lo[c + 1] - 1) // n_tiles
                                                      - lo[c] // n_tiles + 1)
                  for c in range(ctas))
    return (longest + _MERGE * _splits(lo, n_tiles)) * _ROWS_COST[rows]


def bf16_plan(B: int, Tq: int, Tk: int, num_heads: int, sm_count: int) -> tuple:
    """(query rows per block, blocks in the grid) of the bf16 route.

    Of 128 or 192 rows, each on the plain grid (a block per row block) or on
    the persistent schedule (one block per SM of the card's ``sm_count``,
    each walking an even share of the (row block, key tile) units,
    :func:`bf16_schedule`), the plan the model above prices lowest.
    ``BF16_ROWS`` and ``BF16_PERSISTENT`` fix either choice.
    """
    n_tiles = -(-Tk // KEY_TILE_BF16)
    best = None
    for rows in (BF16_ROWS,) if BF16_ROWS else (128, 192):
        blocks = -(-Tq // rows) * num_heads * B
        for persistent in (False, True) if BF16_PERSISTENT is None else (BF16_PERSISTENT,):
            ctas = min(sm_count, blocks * n_tiles) if persistent else blocks
            cost = _plan_cost(blocks, n_tiles, rows, ctas, persistent, sm_count)
            if best is None or cost < best[0]:
                best = (cost, rows, ctas)
    return best[1:]


def bf16_schedule(blocks: int, n_tiles: int, ctas: int) -> list:
    """The persistent schedule of csrc/flash_mha.cu (``Schedule``): the
    ``blocks x n_tiles`` (row block, key tile) units, row block by row block,
    cut into ``ctas`` contiguous ranges (:func:`_ranges`). Returns, per row
    block, its runs of key tiles ``[(t0, t1), ...]`` in key order, one per
    range that takes part of it; a row block of more than one run is merged
    from their partial sums."""
    lo = _ranges(blocks * n_tiles, ctas)
    runs: list = [[] for _ in range(blocks)]
    for c in range(ctas):
        u = lo[c]
        while u < lo[c + 1]:
            r = u // n_tiles
            end = min(lo[c + 1], (r + 1) * n_tiles)
            runs[r].append((u - r * n_tiles, end - r * n_tiles))
            u = end
    return runs


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_launch(status: int, what: str) -> None:
    """Raise on a failed tensor-map encode or a CUDA error of a launch."""
    if status >= _ENCODE_FAILED:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{status - _ENCODE_FAILED})")
    _build.check(status, what)


def flash_mha_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   *, mask: torch.Tensor | None = None, dropout: float = 0.0,
                   dropout_seed: int | None = None) -> torch.Tensor:
    """K3's bf16 route: bf16 ``q (B, Tq, C)``, ``k, v (B, Tk, C)`` -> bf16
    ``(B, Tq, C)``, with :func:`flash_mha`'s ``mask`` and dropout. A CPU
    tensor takes the plain version; a bf16 CUDA tensor launches the kernel
    (its result carries a gradient through :func:`flash_mha_bwd_bf16`),
    anything else on the card raises; an empty batch or query launches
    nothing. ``flash_mha_bf16.launches`` counts its launches."""
    seed = _seed32(dropout, dropout_seed)
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, mask=mask, dropout=dropout,
                               dropout_seed=seed)
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, torch.bfloat16)
    if B * Tq == 0:
        return torch.empty_like(q)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashMHA.apply(q, k, v, num_heads, keep, float(dropout), seed, _wants_grad(q, k, v))


def _forward_bf16(q, k, v, num_heads: int, keep, rate: float, seed: int, want_lse: bool):
    """One launch of the bf16 route (and its merge kernel where the plan
    splits a row block) -> (o, lse or None)."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    d = C // num_heads
    rows, ctas = bf16_plan(B, Tq, Tk, num_heads, _sm_count(q.device.index or 0))
    n_tiles = -(-Tk // KEY_TILE_BF16)
    out = torch.empty_like(q)
    part = None
    if _splits(_ranges(-(-Tq // rows) * num_heads * B * n_tiles, ctas), n_tiles):
        # two slots per range: rows x (o, then the scaled max and the sum)
        part = torch.empty(2 * ctas * rows * (d + 2), device=q.device)
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    status = _lib().flash_mha_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if keep is None else keep.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Tq, Tk, num_heads, d, q_scale(d),
        KEY_TILE_BF16, rows, ctas, rate, _int32(seed), _build.stream_ptr(q.device))
    _check_launch(status, "flash_mha_bf16")
    flash_mha_bf16.launches += 1
    return out, lse


flash_mha.launches = 0
flash_mha_bwd.launches = 0
flash_mha_bf16.launches = 0
flash_mha_bwd_bf16.launches = 0


def bf16_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               p: torch.Tensor) -> tuple:
    """Bring-up check of the bf16 route's two products alone, on the card:
    bf16 ``q (64, d)``, ``k, v (n, d)`` and fp32 ``p (64, n)``, n = 64 or 128
    keys -> fp32 ``(Q K^T, bf16(P) V)`` by one warpgroup's ``wgmma`` s through
    the kernel's tensor-map copies, swizzled tile image, descriptors and
    fragment maps (a wrong one gives wrong numbers, no error)."""
    d, n = q.shape[1], k.shape[0]
    if d not in HEAD_DIMS or q.shape != (64, d) or n not in (64, 128):
        raise ValueError(f"bf16_tiles takes q (64, d), d in {HEAD_DIMS}, and 64 or 128 keys")
    if k.shape != (n, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({n}, {d})")
    if p.shape != (64, n) or p.dtype != torch.float32:
        raise ValueError(f"p must be a (64, {n}) float32 tensor")
    q, k, v = (_aligned(t) for t in (q, k, v))
    p = p.contiguous()
    s_out = torch.empty(64, n, device=q.device)
    o_out = torch.empty(64, d, device=q.device)
    status = _lib().flash_mha_bf16_tiles(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                                         s_out.data_ptr(), o_out.data_ptr(), d, n,
                                         _build.stream_ptr(q.device))
    _check_launch(status, "flash_mha_bf16_tiles")
    return s_out, o_out
