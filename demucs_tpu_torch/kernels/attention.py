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
rescale (a fully masked row gives NaN, as the plain softmax does). The
kernels have instances at head dims 32, 48, 64 and 128 (:data:`HEAD_DIMS`;
at 128 the fp32 route takes 32 keys a tile and 64 rows a block with Q's
split in shared memory, the bf16 route 64 keys and 128 rows,
``csrc/flash_mha_d128.cu``); any other head dim up to 128 runs on the
smallest instance above it, each head's q, k and v padded with zero
channels (which leave every score as it was) and the output cropped
(:func:`instance_dim`, :func:`pad_heads`, :func:`crop_heads`), the softmax
scale the true head dim's; the pad and the crop are differentiable ops
outside the autograd node, so a gradient at a padded head dim runs the
backward instances of its pad. The backward and the dropout have instances
at every head dim the forward has (:data:`TRAIN_HEAD_DIM`, 128; the
backward's at 128 in ``csrc/flash_mha_bwd_d128.cu``: the bf16 route's one
consumer warpgroup of 64 keys, the fp32 route's dK / dV and dQ kernels);
past 128 the wrappers raise. Under a mask each route reads it as :class:`MaskTiles`, built
once per mask on the host (:func:`mask_tiles`; ``ops/sparse.py`` builds the
transformer's beside its cached table): for each plan a tile map of the
(row block, key tile) units that keep a score, full or partial (the
kernels stream and compute only those, and test no key of a full one), and
the mask packed into bits in the order the kernels' lanes hold the scores
(a partial tile's keep test is a bit test); the backward's view of it is
built at the same time (:func:`bwd_tile_map`, :func:`pack_mask_bits_bwd`:
per key block the query tiles that keep a score, in the order of the
transposed scores' lanes). The plain version is
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
for bit the same every run. Under a keep-mask the backward's launches
take their own instances (``csrc/flash_mha_bwd_masked.cu``): each block of
keys walks only the query tiles its tile map lists, tests bits only on
partial units, and (deterministic) adds dQ in the same order restricted to
the blocks that visit each tile (:func:`bwd_order_masked`).

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

import bisect
import ctypes
import functools
import heapq
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.ops.attention import _mul32, _split_heads, dropout_keep, multihead_attention

__all__ = ["flash_mha", "flash_mha_op", "flash_mha_bf16", "flash_mha_plain", "flash_mha_bwd",
           "flash_mha_bwd_bf16", "flash_mha_bwd_plain", "HEAD_DIMS", "KEY_TILE",
           "KEY_TILE_BF16", "q_scale", "bf16_plan", "bf16_schedule", "bf16_tiles",
           "bf16_drop_tile", "bwd_keys", "MaskTiles", "mask_tiles", "register_mask_tiles",
           "tile_classes", "tile_map", "pack_mask_bits", "unpack_mask_bits", "MASK_PLANS",
           "bwd_walk", "bwd_turn", "bwd_order", "bwd_rounds", "bwd_plan", "BWD_PLANS",
           "bwd_tile_map", "bwd_order_masked", "bwd_walk_masked", "pack_mask_bits_bwd",
           "unpack_mask_bits_bwd", "instance_dim", "pad_heads", "crop_heads",
           "flash_mha_padded_plain", "f32_plan", "bf16_key_tile", "mask_pieces",
           "TRAIN_HEAD_DIM", "MASK_PIECE_ROWS"]

# The head dims of the kernels' instances; a smaller head runs on the next
# one up, padded (instance_dim). The backward and the dropout have instances
# up to TRAIN_HEAD_DIM, every forward instance's.
HEAD_DIMS = (32, 48, 64, 128)
TRAIN_HEAD_DIM = 128
KEY_TILE = 64  # keys per tile of the fp32 route's loop (F32_PLAN_D128 at head dim 128)
# Query rows per block of the fp32 route: 64 (one consumer warpgroup) or 128
# (two, which overlap one's softmax with the other's products; the faster at
# every released shape and batch on the H100, PERF.md).
BLOCK_ROWS = 128
# The fp32 route's (query rows a block, keys a tile) at head dim 128: a
# tile's image of 64 keys would take 128 KiB a stage, and Q's split, held in
# shared memory there, 64 KiB a warpgroup (csrc/flash_mha.cuh F32Cfg).
F32_PLAN_D128 = (64, 32)
# The bf16 route's plan (chip_smoke.py sweeps every part on the H100,
# PERF.md): keys per tile (64 or 128); query rows per block, 128 or 192 (two
# or three consumer warpgroups); whether one block per SM walks an even share
# of all the work (the persistent schedule) or each block takes a row block.
# None leaves the choice to bf16_plan.
KEY_TILE_BF16 = 128
BF16_ROWS = None
BF16_PERSISTENT = None
# The bf16 route's (keys a tile, query rows a block) at head dim 128, its one
# plan there: 4 stages of 128 keys would not fit beside the Q images
# (csrc/flash_mha.cuh dispatch_bf16); BF16_PERSISTENT still applies.
BF16_PLAN_D128 = (64, 128)
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
# The (query rows a block, keys a tile) of every plan either route takes: the
# fp32 route's 64 or 128 rows at 64 keys and 64 rows at 32 keys (head dim
# 128), the bf16 route's 128 or 192 at 64 or 128. A keep-mask's tile maps are
# built for all of them at once.
MASK_PLANS = ((64, 32), (64, 64), (128, 64), (128, 128), (192, 64), (192, 128))
# The (keys a block, queries a tile) of every plan of the backward: the fp32
# route's 64 keys x 32 queries, the bf16 route's 64 or 128 keys x 64 queries
# (csrc/flash_mha_bwd.cuh F32Bwd, Bf16Bwd). A keep-mask's backward tile maps
# are built for all of them, its backward bits for each query tile size.
BWD_PLANS = ((64, 32), (64, 64), (128, 64))
# The packed mask's query rows are padded to a multiple of this (every plan's
# rows divide it: a row block's words never run past the array;
# csrc/flash_mha.cu mask_rows).
MASK_ROW_PAD = 384
# The bf16 route's masked kernel keeps the tile map's offsets in shared
# memory: at most this many row blocks a launch (csrc/flash_mha.cu OFF_SMEM -
# 1). Past MASK_PIECE_ROWS queries (that many row blocks of the smallest
# plan's 128 rows) a masked bf16 call launches in pieces of its rows
# (mask_pieces; each piece's MaskTiles are built with the mask's).
MASK_ROW_BLOCKS = 511
MASK_PIECE_ROWS = MASK_ROW_BLOCKS * 128
# A status at or above this from flash_mha_bf16 is a failed tensor-map
# encode (csrc/tensor_map.cuh ENCODE_FAILED), plus the driver's CUresult.
_ENCODE_FAILED = 10000


# The plain version of K3, used for CPU tensors and as the kernel's oracle.
flash_mha_plain = multihead_attention


def q_scale(head_dim: int) -> float:
    """The softmax scale in base 2, log2(e)/sqrt(d): the fp32 route multiplies
    q by it before the split, the bf16 route folds it into each fp32 score's
    FFMA with the row max. ``d`` is the heads' own dim, also where they run
    padded on a larger instance."""
    return math.log2(math.e) / math.sqrt(head_dim)


def instance_dim(d: int) -> int:
    """The head dim of the kernels' instance that runs heads of ``d``
    channels: the smallest of :data:`HEAD_DIMS` at least ``d``. Past the
    largest it raises."""
    for D in HEAD_DIMS:
        if d <= D:
            return D
    raise ValueError(f"flash_mha supports head dims up to {HEAD_DIMS[-1]} (instances "
                     f"{HEAD_DIMS}, a smaller head padded to the next), got {d}: no instance "
                     f"past {HEAD_DIMS[-1]} (ROADMAP Queue C)")


def pad_heads(x: torch.Tensor, num_heads: int, D: int) -> torch.Tensor:
    """``(B, T, H d)`` -> ``(B, T, H D)``: each head's d channels, then D - d
    zeros (differentiable; ``x`` itself where d = D)."""
    B, T, C = x.shape
    d = C // num_heads
    if d == D:
        return x
    return F.pad(x.reshape(B, T, num_heads, d), (0, D - d)).reshape(B, T, num_heads * D)


def crop_heads(x: torch.Tensor, num_heads: int, d: int) -> torch.Tensor:
    """``(B, T, H D)`` -> ``(B, T, H d)``: each head's first d channels
    (differentiable; ``x`` itself where d = D)."""
    B, T, C = x.shape
    D = C // num_heads
    if d == D:
        return x
    return x.reshape(B, T, num_heads, D)[..., :d].reshape(B, T, num_heads * d)


def _on_instance(fn, num_heads: int, d: int, *ts: torch.Tensor) -> torch.Tensor:
    """``fn`` on ``ts`` (``(B, T, H d)`` each) padded to the instance of head
    dim ``d``, its output cropped back to d."""
    D = instance_dim(d)
    return crop_heads(fn(*(pad_heads(t, num_heads, D) for t in ts)), num_heads, d)


def flash_mha_padded_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the path a CUDA tensor takes at a head dim
    between instances: q, k and v padded to the instance's head dim, the
    plain attention there at the true head dim's scale, the output cropped."""
    d = q.shape[-1] // num_heads
    return _on_instance(lambda q, k, v: flash_mha_plain(q, k, v, num_heads, mask=mask,
                                                        head_dim=d), num_heads, d, q, k, v)


def f32_plan(D: int) -> tuple:
    """(query rows a block, keys a tile) of the fp32 route at instance head
    dim ``D``: ``BLOCK_ROWS`` and ``KEY_TILE``, at 128 ``F32_PLAN_D128``."""
    return F32_PLAN_D128 if D == 128 else (BLOCK_ROWS, KEY_TILE)


def bf16_key_tile(D: int) -> int:
    """Keys a tile of the bf16 route at instance head dim ``D``."""
    return BF16_PLAN_D128[0] if D == 128 else KEY_TILE_BF16


def _instance_key(D: int, tiles, rate: float) -> str:
    """A forward launch's instance, as the routes' ``launches_by_instance``
    name it: head dim, masked or not, with dropout or not ("D=128 masked
    dropout")."""
    return f"D={D}" + ("" if tiles is None else " masked") + (" dropout" if rate > 0.0 else "")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels read 16-byte rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_mha_f32.argtypes = [p] * 8 + [i, i, i, i, i, f, i, f, i, p]
    lib.flash_mha_f32.restype = i
    lib.flash_mha_bf16.argtypes = [p] * 8 + [i, i, i, i, i, f, i, i, i, f, i, i, p]
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


@functools.lru_cache(maxsize=None)
def _bwd_masked_lib() -> ctypes.CDLL:
    """The masked backward's library (``csrc/flash_mha_bwd_masked.cu``)."""
    lib = _build.load("flash_mha_bwd_masked")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_mha_bwd_masked_f32.argtypes = [p] * 16 + [i] * 6 + [f, f, f, i, p]
    lib.flash_mha_bwd_masked_bf16.argtypes = [p] * 14 + [i] * 6 + [f, f, f, i, p]
    lib.flash_mha_bwd_masked_f32.restype = lib.flash_mha_bwd_masked_bf16.restype = i
    lib.flash_mha_bwd_masked_ordered_plan.argtypes = [i] * 7 + [p]
    lib.flash_mha_bwd_masked_ordered_plan.restype = i
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
    instance_dim(d)  # raises past the largest instance
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
    return _node(q, k, v, num_heads, d, keep, _tiles(mask, keep), float(dropout), seed)


def _node(q, k, v, num_heads: int, d: int, keep, tiles, rate: float, seed: int) -> torch.Tensor:
    """The autograd node :class:`_FlashMHA` on q, k, v padded to the
    instance of head dim ``d``, its output cropped back."""
    want = _wants_grad(q, k, v)
    return _on_instance(lambda q, k, v: _FlashMHA.apply(
        _aligned(q), _aligned(k), _aligned(v), num_heads, keep, tiles, rate, seed, want, d),
        num_heads, d, q, k, v)


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
    tiles = _tiles(mask, keep)
    return _on_instance(lambda q, k, v: route(_aligned(q), _aligned(k), _aligned(v), num_heads,
                                              tiles, 0.0, 0, False, d)[0], num_heads, d, q, k, v)


@flash_mha_op.register_fake
def _flash_mha_op_fake(q, k, v, num_heads, mask=None):
    return torch.empty_like(q)


def _wants_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd will ask for the launch's gradient (then the forward
    keeps each row's log-sum-exp for the backward kernel)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _forward_f32(q, k, v, num_heads: int, tiles, rate: float, seed: int, want_lse: bool,
                 head_dim: int | None = None):
    """One launch of the fp32 route at the instance of q's head dim (one of
    :data:`HEAD_DIMS`) -> (o, lse or None); ``tiles``: the mask's
    :class:`MaskTiles`, or None; ``head_dim``: the heads' own dim where they
    come padded with zero channels (the softmax scale's), else q's."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    D = C // num_heads
    rows, keys = f32_plan(D)
    out = torch.empty_like(q)
    image = torch.empty(B, num_heads, -(-Tk // keys), 4, keys * D, device=q.device)
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    tmap, bits = (None, None) if tiles is None else tiles.launch(rows, keys)
    status = _lib().flash_mha_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tmap, bits, image.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Tq, Tk, num_heads, D, q_scale(head_dim or D), rows, rate, _int32(seed),
        _build.stream_ptr(q.device))
    _build.check(status, "flash_mha_f32")
    flash_mha.launches += 1
    flash_mha.launches_by_instance[_instance_key(D, tiles, rate)] += 1
    return out, lse


class _FlashMHA(torch.autograd.Function):
    """K3 as an autograd node, on the route of its inputs' dtype: the forward
    kernel (keeping each row's log-sum-exp when a gradient is wanted), then
    the backward kernel of the same route (:func:`flash_mha_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, keep, tiles, rate, seed, want_lse, head_dim=None):
        route = _forward_bf16 if q.dtype == torch.bfloat16 else _forward_f32
        out, lse = route(q, k, v, num_heads, tiles, rate, seed, want_lse, head_dim)
        if want_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (num_heads, keep, tiles, rate, seed, head_dim)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        num_heads, keep, tiles, rate, seed, head_dim = ctx.args
        dq, dk, dv = flash_mha_bwd(q, k, v, out, dout, num_heads, lse=lse, mask=keep,
                                   mask_tiles=tiles, dropout=rate, dropout_seed=seed,
                                   head_dim=head_dim)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor, num_heads: int, *, lse: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None, dropout: float = 0.0,
                        dropout_seed: int | None = None, head_dim: int | None = None) -> tuple:
    """The plain version of :func:`flash_mha_bwd`, the backward formula
    written out in fp32 (it recomputes the softmax and does not read ``lse``):
    with ``P = softmax(S)``, ``Z`` the dropout's keep / (1 - rate) (or 1) and
    ``D = rowsum(dO o)``: ``dV = (Z P)^T dO``, ``dS = P (Z dO V^T - D)``,
    ``dQ = dS K / sqrt(d)``, ``dK = dS^T Q / sqrt(d)``; ``head_dim``: d where
    the heads come padded with zero channels (else C / num_heads)."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(head_dim or C // num_heads)
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
                  mask: torch.Tensor | None = None, mask_tiles: "MaskTiles | None" = None,
                  dropout: float = 0.0, dropout_seed: int | None = None,
                  head_dim: int | None = None) -> tuple:
    """K3's backward: ``(dq, dk, dv)`` of :func:`flash_mha` at ``q, k, v``
    with output ``o`` and its gradient ``dout``, from the forward's ``lse (B
    * H, Tq)`` and its ``mask``, ``dropout`` and ``dropout_seed``. A CPU
    tensor takes :func:`flash_mha_bwd_plain`; an fp32 CUDA tensor launches
    ``csrc/flash_mha_bwd.cu`` (the row dots, one pass for dQ, dK and dV in
    3xTF32 ``wgmma`` over blocks of 64 keys, dQ's sums out), under a mask
    ``csrc/flash_mha_bwd_masked.cu``'s instances, which read the mask as its
    :class:`MaskTiles` (``mask_tiles``, as the forward built them; else
    :func:`mask_tiles` of ``mask``); a bf16 one :func:`flash_mha_bwd_bf16`;
    anything else raises. On the card q's head dim is an instance's
    (:data:`HEAD_DIMS`; at 128 ``csrc/flash_mha_bwd_d128.cu``'s two kernels,
    dK and dV by key block, dQ by row block); ``head_dim``: the heads' own
    dim where q, k, v, o and dout come padded with zero channels to it (the
    autograd node pads a head between instances). ``flash_mha_bwd.launches``
    counts the fp32 route's launches, ``flash_mha_bwd.masked_launches`` those
    of them under a mask, ``flash_mha_bwd.launches_by_instance`` each by
    head dim, mask and order (:func:`_bwd_instance_key`)."""
    seed = _seed32(dropout, dropout_seed)
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, o, dout, num_heads, mask=mask, dropout=dropout,
                                   dropout_seed=seed, head_dim=head_dim)
    if q.dtype == torch.bfloat16:
        return flash_mha_bwd_bf16(q, k, v, o, dout, num_heads, lse=lse, mask=mask,
                                  mask_tiles=mask_tiles, dropout=dropout, dropout_seed=seed,
                                  head_dim=head_dim)
    grads = _launch_bwd("flash_mha_bwd_f32", torch.float32, q, k, v, o, dout, num_heads, lse,
                        mask, dropout, seed, tiles=mask_tiles, head_dim=head_dim)
    flash_mha_bwd.launches += 1
    flash_mha_bwd.masked_launches += mask is not None
    flash_mha_bwd.launches_by_instance[_bwd_instance_key(q, num_heads, mask)] += 1
    return grads


def flash_mha_bwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       dout: torch.Tensor, num_heads: int, *, lse: torch.Tensor,
                       mask: torch.Tensor | None = None, mask_tiles: "MaskTiles | None" = None,
                       dropout: float = 0.0, dropout_seed: int | None = None,
                       head_dim: int | None = None) -> tuple:
    """K3's backward on the bf16 route: as :func:`flash_mha_bwd`, bf16 in and
    out (fp32 ``lse``), bf16 ``wgmma`` products with fp32 accumulation, the
    keys per block by :func:`bwd_keys`. A CPU tensor takes
    :func:`flash_mha_bwd_plain`; a bf16 CUDA tensor launches
    ``csrc/flash_mha_bwd.cu`` (the row dots, the pass, dQ's rounding), under
    a mask the masked instances (``mask_tiles`` and ``head_dim`` as for
    :func:`flash_mha_bwd`; at head dim 128 one consumer warpgroup of 64
    keys); anything else raises. ``flash_mha_bwd_bf16.launches`` counts its
    launches, ``flash_mha_bwd_bf16.masked_launches`` those under a mask,
    ``flash_mha_bwd_bf16.launches_by_instance`` each by instance."""
    seed = _seed32(dropout, dropout_seed)
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, o, dout, num_heads, mask=mask, dropout=dropout,
                                   dropout_seed=seed, head_dim=head_dim)
    grads = _launch_bwd("flash_mha_bwd_bf16", torch.bfloat16, q, k, v, o, dout, num_heads, lse,
                        mask, dropout, seed, tiles=mask_tiles, head_dim=head_dim)
    flash_mha_bwd_bf16.launches += 1
    flash_mha_bwd_bf16.masked_launches += mask is not None
    flash_mha_bwd_bf16.launches_by_instance[_bwd_instance_key(q, num_heads, mask)] += 1
    return grads


def _bwd_instance_key(q, num_heads: int, mask) -> str:
    """A backward launch's instance, as the routes' ``launches_by_instance``
    name it: head dim, masked or not, and deterministic (the ordered
    instances; at head dim 128 on the fp32 route the same kernels, whose dQ
    needs no order) or not."""
    return (f"D={q.shape[-1] // num_heads}" + ("" if mask is None else " masked")
            + (" deterministic" if torch.are_deterministic_algorithms_enabled() else ""))


def _launch_bwd(entry: str, dtype: torch.dtype, q, k, v, o, dout, num_heads: int, lse, mask,
                rate: float, seed: int, tiles: "MaskTiles | None" = None,
                head_dim: int | None = None) -> tuple:
    """One launch of ``csrc/flash_mha_bwd.cu``'s C entry ``entry`` on ``dtype``
    CUDA tensors -> ``(dq, dk, dv)``; under ``mask``, of the masked library's
    entry of the same route with the mask's tile map and bits (``tiles``, or
    the mask's :class:`MaskTiles`) for the launch's plan. q's head dim is an
    instance's (:data:`HEAD_DIMS`; the autograd node pads a head between
    them); ``head_dim``: the heads' own dim where they come so padded."""
    B, Tq, Tk, d, keep = _checked(q, k, v, num_heads, mask, dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"{entry}: head dim {d} is no instance's {HEAD_DIMS}: pad the heads "
                         f"to {instance_dim(d)} channels (pad_heads) and pass head_dim={d}")
    scale_dim = head_dim or d
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
    # dQ's fp32 sums over the blocks of keys, per tile of queries (the launch zeroes
    # them); the fp32 route at head dim 128 sums each query's dQ in one block: unread
    split = dtype == torch.float32 and d == 128
    dq_acc = torch.empty(1 if split else B * num_heads * -(-Tq // 64) * 64 * d, device=q.device)
    turns = dq_turns(B, num_heads, Tq, q.device)
    keys = (bwd_keys(B, Tk, num_heads, _sm_count(q.device.index or 0), d)
            if dtype == torch.bfloat16 else 64)
    args = (stats.data_ptr(), dq_acc.data_ptr(), None if turns is None else turns.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, num_heads, d, keys,
            q_scale(scale_dim), 1.0 / math.sqrt(scale_dim), float(rate), _int32(seed),
            _build.stream_ptr(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr())
    if keep is None:
        status = getattr(_bwd_lib(), entry)(*ptrs, None, *args)
    else:
        tiles = _tiles(mask, keep) if tiles is None else tiles
        maps = tiles.bwd_launch(keys, 64 if dtype == torch.bfloat16 else 32)
        if dtype == torch.float32:  # at 128 its dQ kernel walks the forward's map (64, 32)
            maps += tiles.launch(64, 32) if split else (None, None)
        entry = entry.replace("flash_mha_bwd", "flash_mha_bwd_masked")
        status = getattr(_bwd_masked_lib(), entry)(*ptrs, *maps, *args)
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
             device=None, masked: bool = False) -> dict:
    """The plan of the deterministic backward's launch at these sizes on the
    card (``device``, the current one by default), as the launch computes it
    (``csrc/flash_mha_bwd.cu`` ``ordered_plan``): a head's query tiles and
    key blocks, the blocks an SM holds, the SMs, the blocks launched, the
    order (staggered, else key-block order), the depth of the dQ ring; then
    the resident blocks (``capacity``), the rounds of heads and whether the
    CPU twin (:func:`bwd_rounds`) chose the same grid and order. ``keys``:
    keys per block (64 or 128 on the bf16 route, 64 at head dim 128 and on
    the fp32 route, which has no such grid at 128);
    ``masked``: the plan of the masked instances (their own occupancy)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bwd_plan: float32 or bfloat16, got {dtype}")
    if dtype == torch.float32 and d == 128:
        raise ValueError("bwd_plan: the fp32 backward at head dim 128 has no cooperative grid "
                         "(its dQ kernel sums each query in one block, in a fixed order)")
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    out = (ctypes.c_int * len(_PLAN))()
    entry = (_bwd_masked_lib().flash_mha_bwd_masked_ordered_plan if masked
             else _bwd_lib().flash_mha_bwd_ordered_plan)
    with torch.cuda.device(device):
        status = entry(int(dtype == torch.bfloat16), B, Tq, Tk, num_heads, d, keys, out)
    _build.check(status, "flash_mha_bwd_ordered_plan")
    plan = dict(zip(_PLAN, out), keys=keys)
    plan["stagger"] = bool(plan["stagger"])
    plan["capacity"] = plan["blocks_per_sm"] * plan["sms"]
    twin = bwd_rounds(B, num_heads, plan["n_kb"], plan["capacity"])
    plan["heads_per_round"] = twin["heads_per_round"]
    plan["n_rounds"] = None if twin["rounds"] is None else len(twin["rounds"])
    plan["twin_agrees"] = twin["grid"] == plan["grid"] and twin["stagger"] == plan["stagger"]
    return plan


def bwd_keys(B: int, Tk: int, num_heads: int, sm_count: int, head_dim: int = 64) -> int:
    """Keys per block of the bf16 backward kernel, 64 or 128: the one the
    model prices lowest, the blocks an SM takes at once (one of 128 keys,
    two of 64) times ``_BWD_COST`` (``_BWD_COST_ORDERED`` under
    ``torch.use_deterministic_algorithms``), at least one such round. The
    last block of each head covers keys past Tk: 128-key blocks waste more
    of a ragged Tk. ``BWD_KEYS_BF16`` fixes the choice. At the instance head
    dim ``head_dim`` 128 always 64, the one plan there (one consumer
    warpgroup: two would take 256 KiB of shared memory)."""
    if head_dim == 128:
        return 64
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


def _starts(counts: tuple, n_bh: int) -> list:
    """The first unit of each row block (``Units::start``) under a tile map:
    row block r = x + n_x bh holds ``counts[x]`` units."""
    off = np.concatenate([[0], np.cumsum(counts)])
    return [bh * int(off[-1]) + int(o) for bh in range(n_bh) for o in off[:-1]]


def _splits_at(lo: list, starts: list) -> bool:
    """:func:`_splits` under a tile map: a range that starts at no row
    block's first unit."""
    first = set(starts)
    return any(u not in first for u in lo[1:-1])


@functools.lru_cache(maxsize=256)
def _masked_splits(counts: tuple, n_bh: int, ctas: int) -> bool:
    """:func:`_splits_at` of a masked launch's schedule (cached: a launch
    reads it on the host, where its lists would cost more than the kernel)."""
    return _splits_at(_ranges(n_bh * sum(counts), ctas), _starts(counts, n_bh))


@functools.lru_cache(maxsize=None)
def _plan_cost(blocks: int, n_tiles: int, rows: int, ctas: int, persistent: bool,
               sm_count: int, counts: tuple | None = None) -> float:
    """The modelled time of a plan: the plain grid's waves, or the persistent
    schedule's longest range with a start for each row block it touches.
    ``counts``: under a mask, each row block's units of its tile map (by x);
    the plain grid's blocks then go to the SMs as they free up (an empty one
    costs nothing) and the ranges cut the listed units."""
    if counts is None:
        if not persistent:
            return -(-blocks // sm_count) * (n_tiles + _BLOCK_START) * _ROWS_COST[rows]
        lo = _ranges(blocks * n_tiles, ctas)
        longest = max(lo[c + 1] - lo[c] + _PIECE_START * ((lo[c + 1] - 1) // n_tiles
                                                          - lo[c] // n_tiles + 1)
                      for c in range(ctas))
        return (longest + _MERGE * _splits(lo, n_tiles)) * _ROWS_COST[rows]
    n_x = len(counts)
    if not persistent:
        free = [0.0] * sm_count
        for r in range(blocks):
            units = counts[r % n_x]
            heapq.heapreplace(free, free[0] + (units + _BLOCK_START if units else 0.0))
        return max(free) * _ROWS_COST[rows]
    n_bh = blocks // n_x
    starts = [u for u, units in zip(_starts(counts, n_bh), counts * n_bh) if units]
    lo = _ranges(n_bh * sum(counts), ctas)
    longest = max(lo[c + 1] - lo[c] + _PIECE_START * (
        1 + bisect.bisect_left(starts, lo[c + 1]) - bisect.bisect_right(starts, lo[c]))
        for c in range(ctas))
    return (longest + _MERGE * _splits_at(lo, starts)) * _ROWS_COST[rows]


def bf16_plan(B: int, Tq: int, Tk: int, num_heads: int, sm_count: int,
              tiles: "MaskTiles | None" = None, head_dim: int = 64) -> tuple:
    """(query rows per block, blocks in the grid) of the bf16 route at the
    instance head dim ``head_dim``.

    Of 128 or 192 rows, each on the plain grid (a block per row block) or on
    the persistent schedule (one block per SM of the card's ``sm_count``,
    each walking an even share of the (row block, key tile) units,
    :func:`bf16_schedule`), the plan the model above prices lowest. Under a
    mask (``tiles``, its :class:`MaskTiles`) the units are its tile map's:
    the model prices the work there is, and a mask that keeps nothing takes
    the plain grid. ``BF16_ROWS`` and ``BF16_PERSISTENT`` fix either choice.
    At head dim 128 the rows and keys are ``BF16_PLAN_D128``'s.
    """
    keys = bf16_key_tile(head_dim)
    n_tiles = -(-Tk // keys)
    best = None
    if head_dim == 128:
        choices = (BF16_PLAN_D128[1],)
    else:
        choices = (BF16_ROWS,) if BF16_ROWS else (128, 192)
    for rows in choices:
        blocks = -(-Tq // rows) * num_heads * B
        counts = None if tiles is None else tiles.counts[rows, keys]
        units = blocks * n_tiles if counts is None else blocks // len(counts) * sum(counts)
        ways = (False, True) if BF16_PERSISTENT is None else (BF16_PERSISTENT,)
        for persistent in ways if units else (False,):
            ctas = min(sm_count, units) if persistent else blocks
            cost = _plan_cost(blocks, n_tiles, rows, ctas, persistent, sm_count, counts)
            if best is None or cost < best[0]:
                best = (cost, rows, ctas)
    return best[1:]


def bf16_drop_tile(bh: int, row0: int, k0: int, rate: float, seed: int,
                   key_tile: int = KEY_TILE_BF16) -> torch.Tensor:
    """The plain twin of the bf16 kernel's dropout of one consumer
    warpgroup's tile (csrc/flash_mha.cu ``drop_tile``): query rows ``row0`` ..
    ``row0 + 63`` against keys ``k0`` .. ``k0 + key_tile - 1`` of batch-head
    ``bh`` -> ``(4, 32, key_tile // 2)`` bool, True where lane (4 g + c) of
    warp w zeroes its element ``e``: row ``row0 + 16 w + g + 8 ((e >> 1) &
    1)``, key ``k0 + 8 (e >> 2) + 2c + (e & 1)`` (the S accumulator's layout).
    The arithmetic is the kernel's: each lane's two row terms, the tile's
    column terms as the producer warpgroup writes them into the stage (one
    per key) and as a lane reads them (the pair of keys 8 j + 2c, + 1), what
    stays of murmur3's finalizer, and the compare ``x >= t << 8``, t =
    ceil(rate 2^24) (``csrc/attention_dropout.cuh``)."""
    M = 0xFFFFFFFF
    salt = (_seed32(rate, seed) + bh * 0x27D4EB2F) & M
    limit = math.ceil(torch.tensor(rate, dtype=torch.float32).item() * 2.0 ** 24) << 8
    e = torch.arange(key_tile // 2, dtype=torch.int64)
    w = torch.arange(4, dtype=torch.int64)[:, None, None]
    lane = torch.arange(32, dtype=torch.int64)[None, :, None]
    g, c = lane // 4, lane % 4
    r = _mul32(row0 + 16 * w + g + 8 * ((e >> 1) & 1), 0x9E3779B1) ^ salt
    rt = r ^ (r >> 16)
    k = _mul32(k0 + torch.arange(key_tile, dtype=torch.int64), 0x85EBCA77)
    cols = k ^ (k >> 16)  # the stage's column terms, key k0 + q at q
    x = rt ^ cols[8 * (e >> 2) + 2 * c + (e & 1)]
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x < limit).expand(4, 32, key_tile // 2)


def bf16_schedule(blocks: int, n_tiles: int, ctas: int, counts: tuple | None = None) -> list:
    """The persistent schedule of csrc/flash_mha.cu (``Schedule``): the
    ``blocks x n_tiles`` (row block, key tile) units, row block by row block,
    cut into ``ctas`` contiguous ranges (:func:`_ranges`). Returns, per row
    block, its runs of key tiles ``[(t0, t1), ...]`` in key order, one per
    range that takes part of it; a row block of more than one run is merged
    from their partial sums. ``counts``: under a mask, each row block's units
    of its tile map (by x, :func:`tile_map`), and a run ``(i0, i1)`` holds
    the row block's units i0 .. i1 - 1 (its listed tiles, in key order); an
    empty row block has no run. ``ctas == blocks`` is the plain grid: each
    row block one run of all its units."""
    if counts is None:
        counts = (n_tiles,)
    n_x = len(counts)
    units = [counts[r % n_x] for r in range(blocks)]
    if ctas == blocks:
        return [[(0, n)] if n else [] for n in units]
    starts = _starts(tuple(counts), blocks // n_x)
    lo = _ranges(sum(units), ctas)
    runs: list = [[] for _ in range(blocks)]
    for c in range(ctas):
        u = lo[c]
        while u < lo[c + 1]:
            r = bisect.bisect_right(starts, u) - 1  # the row block that holds u (never an empty one)
            end = min(lo[c + 1], starts[r] + units[r])
            runs[r].append((u - starts[r], end - starts[r]))
            u = end
    return runs


def tile_classes(mask: np.ndarray, rows: int, keys: int) -> np.ndarray:
    """The class of each (row block of ``rows`` query rows, tile of ``keys``
    keys) unit of a boolean keep-mask ``(Tq, Tk)``: 0 empty (no score kept),
    2 full (every score of its rows below Tq kept, and the tile inside Tk), 1
    partial (the rest: a tile that runs past Tk is partial). ``(n_x,
    n_tiles)`` int8."""
    Tq, Tk = mask.shape
    n_x, n_t = -(-Tq // rows), -(-Tk // keys)
    kept = np.zeros((n_x * rows, n_t * keys), bool)
    kept[:Tq, :Tk] = mask
    some = kept.reshape(n_x, rows, n_t, keys).any(axis=(1, 3))
    kept[Tq:, :Tk] = True  # rows past Tq do not count against a full tile
    every = kept.reshape(n_x, rows, n_t, keys).all(axis=(1, 3))
    return np.where(every, 2, np.where(some, 1, 0)).astype(np.int8)


def tile_map(mask: np.ndarray, rows: int, keys: int) -> dict:
    """The plain twin of the kernels' tile map (csrc/flash_mha.cu, above
    ``mask_rows``) of a keep-mask for a plan: ``classes``
    (:func:`tile_classes`), ``counts`` (each row block's non-empty units),
    ``off`` (each row block's first in ``ent``), ``ent`` (the non-empty units,
    row block by row block in key order, as ``tile << 1 | partial``),
    ``empty`` (the row blocks with none), and ``map``, the int32 array the
    kernels read: ``[nnz, n_empty, off, ent, empty]``."""
    classes = tile_classes(mask, rows, keys)
    counts = (classes > 0).sum(1)
    off = np.concatenate([[0], np.cumsum(counts)])
    xs, ts = np.nonzero(classes)
    ent = ts << 1 | (classes[xs, ts] == 1)
    empty = np.flatnonzero(counts == 0)
    flat = np.concatenate([[len(ent), len(empty)], off, ent, empty]).astype(np.int32)
    return dict(classes=classes, counts=tuple(int(c) for c in counts), off=off, ent=ent,
                empty=empty, map=flat)


def pack_mask_bits(mask: np.ndarray) -> np.ndarray:
    """A boolean keep-mask ``(Tq, Tk)`` packed for the kernels: uint32
    ``(ceil(Tk / 128), Tq_pad, 4)`` (Tq_pad: Tq rounded up to MASK_ROW_PAD),
    word c of (group w, row r) holding key ``128 w + 8 j + 2 c + b`` at bit
    ``2 j + b``, the keys lane c of a warp holds of row r in the S
    accumulator; 0 past Tk and past Tq."""
    Tq, Tk = mask.shape
    n_w, pad = -(-Tk // 128), -(-Tq // MASK_ROW_PAD) * MASK_ROW_PAD
    kept = np.zeros((pad, n_w * 128), bool)
    kept[:Tq, :Tk] = mask
    # (row, group, j, c, b) -> (group, row, c, bit 2 j + b)
    lanes = kept.reshape(pad, n_w, 16, 4, 2).transpose(1, 0, 3, 2, 4).reshape(n_w, pad, 4, 32)
    return np.packbits(lanes, axis=-1, bitorder="little").view("<u4")[..., 0]


def unpack_mask_bits(words: np.ndarray, Tq: int, Tk: int, keys: int = 128) -> np.ndarray:
    """The inverse of :func:`pack_mask_bits` as the kernels read it: lane c
    of tile t (``keys`` keys) takes word c of its row in group ``t * keys //
    128``, shifted right by 16 (t & 1) at 64 keys and by 8 (t & 3) at 32, and
    keeps element e's key
    ``k0 + 8 (e >> 2) + 2 c + (e & 1)`` where bit ``2 (e >> 2) + (e & 1)`` is
    set. Returns the ``(Tq, n_tiles * keys)`` boolean mask so read."""
    n_t = -(-Tk // keys)
    out = np.zeros((Tq, n_t * keys), bool)
    e = np.arange(keys // 2)
    bit = 2 * (e >> 2) + (e & 1)
    for t in range(n_t):
        w = words[t * keys // 128, :Tq].astype(np.int64)  # (Tq, 4)
        if keys < 128:
            w = w >> (keys // 4 * (t % (128 // keys)))
        for c in range(4):
            key = t * keys + 8 * (e >> 2) + 2 * c + (e & 1)
            out[:, key] = (w[:, c, None] >> bit) & 1
    return out


def bwd_walk_masked(x: int, classes: np.ndarray, stagger: bool = True) -> list:
    """The query tiles key block ``x`` walks in the masked backward: its
    walk (:func:`bwd_walk`) restricted to the tiles it keeps a score of
    (``classes``: the backward's ``(n_kb, n_qt)`` unit classes,
    :func:`bwd_tile_map`)."""
    n_kb, n_qt = classes.shape
    return [t for t in bwd_walk(x, n_qt, n_kb, stagger) if classes[x, t]]


def bwd_order_masked(classes: np.ndarray, stagger: bool = True) -> list:
    """Per query tile, the key blocks that visit it in the order they add
    their parts of dQ in the masked deterministic backward: the unmasked order
    (:func:`bwd_order`) restricted to them, so no block waits on one that
    skips the tile. With no empty unit it is :func:`bwd_order`."""
    n_kb, n_qt = classes.shape
    return [[x for x in blocks if classes[x, t]]
            for t, blocks in enumerate(bwd_order(n_qt, n_kb, stagger))]


def bwd_tile_map(mask: np.ndarray, keys: int, qt: int) -> dict:
    """The plain twin of the backward's tile map of a keep-mask ``(Tq, Tk)``
    for a plan of ``keys`` keys a block and ``qt`` queries a tile
    (csrc/flash_mha_bwd.cuh, above ``mask_rows``): ``classes`` ``(n_kb,
    n_qt)``, the forward's classes of ``(qt, keys)`` transposed (0 empty, 2
    full: every score of its queries below Tq kept and the block inside Tk,
    1 partial; keys past Tk make a unit partial, queries past Tq do not);
    ``counts`` (each key block's units); ``off`` (each block's first in
    ``ent``); ``ent`` (the non-empty units, block by block in tile order, as
    ``tile << 1 | partial``); ``rot`` (the entry that starts each block's
    staggered walk, :func:`bwd_walk_masked`); ``turn_s``, ``turn_p`` (each
    unit's place in its tile's order, :func:`bwd_order_masked`, staggered and
    plain); and ``map``, the int32 array the kernels read: ``[nnz, n_kb,
    off, ent, rot, turn_s, turn_p]``."""
    classes = tile_classes(mask, qt, keys).T
    n_kb, n_qt = classes.shape
    counts = (classes > 0).sum(1)
    off = np.concatenate([[0], np.cumsum(counts)])
    xs, ts = np.nonzero(classes)
    ent = ts << 1 | (classes[xs, ts] == 1)
    starts = np.arange(n_kb) * n_qt // n_kb  # each walk's first tile (Walk::o)
    rot = np.array([int((ts[off[x]:off[x + 1]] < starts[x]).sum()) % max(int(counts[x]), 1)
                    for x in range(n_kb)], dtype=np.int64)
    turns = []
    for stagger in (True, False):
        place = np.zeros((n_kb, n_qt), np.int64)
        for t, blocks in enumerate(bwd_order_masked(classes, stagger)):
            place[blocks, t] = np.arange(len(blocks))
        turns.append(place[xs, ts])
    flat = np.concatenate([[len(ent), n_kb], off, ent, rot, *turns]).astype(np.int32)
    return dict(classes=classes, counts=tuple(int(c) for c in counts), off=off, ent=ent,
                rot=rot, turn_s=turns[0], turn_p=turns[1], map=flat)


def pack_mask_bits_bwd(mask: np.ndarray, qt: int) -> np.ndarray:
    """A keep-mask ``(Tq, Tk)`` packed for the backward's tiles of ``qt``
    (32 or 64) queries: ``(n_qt, Tk_pad, 4)`` of qt / 4 bits (uint8 at 32,
    uint16 at 64; Tk_pad: Tk rounded up to MASK_ROW_PAD), element c of
    (tile t, key j) holding query ``t qt + 8 i + 2 c + b`` at bit ``2 i + b``:
    the queries lane c holds of key j in S^T. That is :func:`pack_mask_bits`
    of the transposed mask (keys as rows), word c of (group t qt // 128, key
    j) shifted right by qt / 4 (t % (128 / qt)); 0 past Tq and past Tk."""
    if qt not in (32, 64):
        raise ValueError(f"the backward's query tiles hold 32 or 64 queries, got {qt}")
    words = pack_mask_bits(np.ascontiguousarray(mask.T))  # (ceil(Tq / 128), Tk_pad, 4)
    t = np.arange(-(-mask.shape[0] // qt))
    per = 128 // qt
    shift = (qt // 4 * (t % per)).astype(np.uint32)[:, None, None]
    part = (words[t // per] >> shift) & np.uint32((1 << qt // 4) - 1)
    return part.astype(np.uint8 if qt == 32 else np.uint16)


def unpack_mask_bits_bwd(bits: np.ndarray, Tq: int, Tk: int, keys: int, qt: int) -> np.ndarray:
    """The inverse of :func:`pack_mask_bits_bwd` as the backward's lanes read
    it: for key block x (``keys`` keys) and query tile t, the block's
    elements of tile t (one bulk copy, ``keys x 4``); lane c of the thread
    holding key j takes element ``(j, c)`` and keeps query ``t qt + 8 (e >>
    2) + 2 c + (e & 1)`` of element e where bit ``2 (e >> 2) + (e & 1)`` is
    set. Returns the ``(n_kb keys, n_qt qt)`` boolean transposed mask so
    read."""
    n_kb, n_qt = -(-Tk // keys), -(-Tq // qt)
    out = np.zeros((n_kb * keys, n_qt * qt), bool)
    e = np.arange(qt // 2)
    bit = 2 * (e >> 2) + (e & 1)
    for x in range(n_kb):
        for t in range(n_qt):
            stage = bits[t, x * keys:(x + 1) * keys].astype(np.int64)  # (keys, 4)
            for c in range(4):
                query = t * qt + 8 * (e >> 2) + 2 * c + (e & 1)
                out[x * keys:(x + 1) * keys, query] = (stage[:, c, None] >> bit) & 1
    return out


def mask_pieces(Tq: int) -> list:
    """The query rows ``[(r0, r1), ...]`` of each launch of the bf16 route
    under a mask of ``Tq`` rows: pieces of MASK_PIECE_ROWS rows in order, the
    last shorter, covering every row once."""
    return [(r0, min(r0 + MASK_PIECE_ROWS, Tq)) for r0 in range(0, Tq, MASK_PIECE_ROWS)]


class MaskTiles:
    """A keep-mask as K3's kernels read it on ``device``: the packed bits
    (:func:`pack_mask_bits`) and, for each plan of :data:`MASK_PLANS`, the
    tile map (:func:`tile_map`) and its row blocks' unit counts; for the
    backward, for each plan of :data:`BWD_PLANS` its tile map
    (:func:`bwd_tile_map`) and, for each query tile size, its bits
    (:func:`pack_mask_bits_bwd`); past MASK_PIECE_ROWS query rows, ``pieces``:
    each of :func:`mask_pieces`'s rows ``(r0, r1)`` with the forward's
    MaskTiles of those rows (``piece=True``: no backward maps, no pieces);
    all built from ``mask``, its boolean host copy, at once (so a later
    launch, a CUDA graph's capture or a backward included, builds
    nothing)."""

    def __init__(self, mask: np.ndarray, device, piece: bool = False):
        self.shape = mask.shape
        with torch.inference_mode(False):
            self.bits = torch.from_numpy(pack_mask_bits(mask).view(np.int32)).to(device)
            self.maps, self.counts = {}, {}
            for rows, keys in MASK_PLANS:
                tm = tile_map(mask, rows, keys)
                self.maps[rows, keys] = torch.from_numpy(tm["map"]).to(device)
                self.counts[rows, keys] = tm["counts"]
            self.bwd_maps, self.bwd_bits = {}, {}
            self.pieces = [] if piece or mask.shape[0] <= MASK_PIECE_ROWS else [
                (r0, r1, MaskTiles(mask[r0:r1], device, piece=True))
                for r0, r1 in mask_pieces(mask.shape[0])]
            for keys, qt in () if piece else BWD_PLANS:
                self.bwd_maps[keys, qt] = torch.from_numpy(
                    bwd_tile_map(mask, keys, qt)["map"]).to(device)
            for qt in () if piece else sorted({qt for _, qt in BWD_PLANS}):
                packed = np.ascontiguousarray(pack_mask_bits_bwd(mask, qt))
                self.bwd_bits[qt] = torch.from_numpy(packed.reshape(-1).view(np.uint8)).to(device)

    def launch(self, rows: int, keys: int) -> tuple:
        """The (tile map, bits) pointers of a launch of this plan."""
        return self.maps[rows, keys].data_ptr(), self.bits.data_ptr()

    def bwd_launch(self, keys: int, qt: int) -> tuple:
        """The (tile map, bits) pointers of a backward launch of this plan."""
        return self.bwd_maps[keys, qt].data_ptr(), self.bwd_bits[qt].data_ptr()


_TILES: dict = {}  # id(mask) -> (weakref to mask, its version, device, MaskTiles)


def _version(mask: torch.Tensor):
    return None if mask.is_inference() else mask._version


def register_mask_tiles(mask: torch.Tensor, host: np.ndarray, device=None) -> MaskTiles:
    """Build the :class:`MaskTiles` of ``mask`` (a ``(Tq, Tk)`` keep-mask)
    on ``device`` (the mask's own by default) from ``host``, its boolean copy
    on the host, and keep them for :func:`mask_tiles` as long as ``mask``
    lives unmodified."""
    device = mask.device if device is None else torch.device(device)
    tiles = MaskTiles(np.asarray(host, bool), device)
    key = id(mask)

    def forget(ref, key=key):
        if key in _TILES and _TILES[key][0] is ref:
            del _TILES[key]

    _TILES[key] = (weakref.ref(mask, forget), _version(mask), device, tiles)
    return tiles


def mask_tiles(mask: torch.Tensor, device=None) -> MaskTiles:
    """The :class:`MaskTiles` of a keep-mask for launches on ``device`` (the
    mask's own by default): those registered with it (``ops/sparse.py``'s
    cached masks are, when built), else built now from its host copy and
    kept with it. Building needs the mask on the host, which a CUDA graph's
    capture forbids: there it raises (build it before the capture, as
    ``keep_mask`` does)."""
    device = mask.device if device is None else torch.device(device)
    hit = _TILES.get(id(mask))
    if (hit is not None and hit[0]() is mask and hit[1] == _version(mask)
            and hit[2] == device):
        return hit[3]
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("flash_mha: a keep-mask's tile map cannot be built inside a CUDA "
                           "graph's capture; run the masked call once before capturing")
    with torch.inference_mode(False):
        host = mask.detach().to("cpu", torch.bool).numpy()
    return register_mask_tiles(mask, host, device)


def _tiles(mask, keep) -> MaskTiles | None:
    """The launch's :class:`MaskTiles` (None without a mask), for ``keep``'s
    device."""
    return None if mask is None else mask_tiles(mask, keep.device)


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
    return _node(q, k, v, num_heads, d, keep, _tiles(mask, keep), float(dropout), seed)


def _forward_bf16(q, k, v, num_heads: int, tiles, rate: float, seed: int, want_lse: bool,
                  head_dim: int | None = None, row0: int = 0):
    """One launch of the bf16 route at the instance of q's head dim (and its
    merge kernel where the plan splits a row block) -> (o, lse or None);
    ``tiles``: the mask's :class:`MaskTiles`, or None (past MASK_PIECE_ROWS
    queries, a launch per piece of its rows, :func:`mask_pieces`);
    ``head_dim`` as for :func:`_forward_f32`; ``row0``: a piece's first
    global query row, which its dropout hashes from."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    D = C // num_heads
    if tiles is not None and tiles.pieces:
        return _forward_bf16_pieces(q, k, v, num_heads, tiles, rate, seed, want_lse, head_dim)
    rows, ctas = bf16_plan(B, Tq, Tk, num_heads, _sm_count(q.device.index or 0), tiles, D)
    keys = bf16_key_tile(D)
    n_tiles = -(-Tk // keys)
    blocks = -(-Tq // rows) * num_heads * B
    out = torch.empty_like(q)
    tmap, bits = (None, None) if tiles is None else tiles.launch(rows, keys)
    if tiles is None:
        split = _splits(_ranges(blocks * n_tiles, ctas), n_tiles)
    else:
        split = ctas != blocks and _masked_splits(tiles.counts[rows, keys], num_heads * B, ctas)
    # two slots per range: rows x (o, then the scaled max and the sum)
    part = torch.empty(2 * ctas * rows * (D + 2), device=q.device) if split else None
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), tmap, bits, out.data_ptr(),
            None if part is None else part.data_ptr(), None if lse is None else lse.data_ptr(),
            B, Tq, Tk, num_heads, D, q_scale(head_dim or D), keys, rows, ctas, rate,
            _int32(seed))
    status = _lib().flash_mha_bf16(*args, row0, _build.stream_ptr(q.device))
    _check_launch(status, "flash_mha_bf16")
    flash_mha_bf16.launches += 1
    flash_mha_bf16.launches_by_instance[_instance_key(D, tiles, rate)] += 1
    return out, lse


def _forward_bf16_pieces(q, k, v, num_heads: int, tiles, rate: float, seed: int,
                         want_lse: bool, head_dim: int | None):
    """The bf16 route under a mask past MASK_PIECE_ROWS queries: a launch per
    piece of its rows (``tiles.pieces``: each piece's rows and their
    :class:`MaskTiles`), each within the masked kernel's MASK_ROW_BLOCKS row
    blocks, given its first global row (the dropout's hash counts global
    query rows, so the pieces drop what one launch would)."""
    B, Tq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    for r0, r1, piece in tiles.pieces:
        o, piece_lse = _forward_bf16(q[:, r0:r1].contiguous(), k, v, num_heads, piece, rate, seed,
                                     want_lse, head_dim, r0)
        out[:, r0:r1] = o
        if lse is not None:
            lse[:, r0:r1] = piece_lse
    return out, lse


flash_mha.launches = 0
flash_mha_bwd.launches = 0
flash_mha_bf16.launches = 0
# each route's forward launches by instance: head dim, masked or not, dropout or
# not ("D=128", "D=128 masked dropout"; inference/engine.py counts them through
# graph replays as "flash_mha D=128", ...)
flash_mha.launches_by_instance = dict.fromkeys(
    [f"D={D}{m}{r}" for D in HEAD_DIMS for m in ("", " masked") for r in ("", " dropout")], 0)
flash_mha_bf16.launches_by_instance = dict(flash_mha.launches_by_instance)
flash_mha_bwd_bf16.launches = 0
flash_mha_bwd.masked_launches = 0
flash_mha_bwd_bf16.masked_launches = 0
# each route's backward launches by instance (_bwd_instance_key: "D=128",
# "D=128 masked deterministic", ...)
flash_mha_bwd.launches_by_instance = dict.fromkeys(
    [f"D={D}{m}{o}" for D in HEAD_DIMS for m in ("", " masked") for o in ("", " deterministic")],
    0)
flash_mha_bwd_bf16.launches_by_instance = dict(flash_mha_bwd.launches_by_instance)


def bf16_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               p: torch.Tensor) -> tuple:
    """Bring-up check of the bf16 route's two products alone, on the card:
    bf16 ``q (64, d)``, ``k, v (n, d)`` and fp32 ``p (64, n)``, d an instance
    head dim (:data:`HEAD_DIMS`), n = 64 or 128 keys -> fp32 ``(Q K^T,
    bf16(P) V)`` by one warpgroup's ``wgmma`` s through the kernel's
    tensor-map copies, swizzled tile image, descriptors and fragment maps (a
    wrong one gives wrong numbers, no error)."""
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
