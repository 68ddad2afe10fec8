"""Tensor parallelism for HTDemucs's cross-transformer (port of
``demucs_tpu/parallel/tp.py``).

The JAX package annotates the transformer's projections with Megatron-style
``PartitionSpec`` s over a ``tp`` mesh axis (:data:`TP_LEAF_SPECS`, its
``_TP_LEAF_SPECS``) and lets GSPMD insert the collectives. Here each rank of
a process group holds its shard of a copy of the module and the collectives
are explicit:

- the attention is split by heads: a rank keeps the q, k and v rows of its
  ``H / tp`` heads (taken from each third of the packed ``in_proj_weight``,
  never as raw rows of the packed matrix, which would hand a rank q rows of
  one head and k rows of another) and the matching columns of ``out_proj``;
  K3 runs on the rank's heads;
- the feed-forward is split by hidden units: rows of ``linear1``, columns of
  ``linear2``;
- ``out_proj`` and ``linear2`` give partial sums, all-reduced before their
  (replicated) bias is added; the inputs of each sharded region pass through
  an identity whose gradient is all-reduced, so every replicated parameter
  gets the whole gradient on every rank.

Every other parameter is replicated. :func:`tp_forward` runs a forward;
``train/step.py::train_step(..., group=dp_group, tp_group=tp_group)`` a step
on a 2-D (dp x tp) grid of ranks (:func:`tp_groups`; the JAX package's
``tests/test_tp.py:56``): the batch over dp, the shards over tp, the norm
from :func:`global_norm`. Dropout is refused under TP (each rank would draw
for its own heads and hidden units, not the whole layer's).
"""

from __future__ import annotations

import copy
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["TP_LEAF_SPECS", "transformer_tp_specs", "shard_module", "tp_forward",
           "tp_groups", "global_norm", "gather_state"]

# Megatron split: rows of the q/k/v in-projection and the FFN up-projection,
# columns of the attention out-projection and the FFN down-projection
TP_LEAF_SPECS: tp.Dict[str, tp.Tuple[tp.Optional[str], ...]] = {
    "in_proj_weight": ("tp", None),
    "in_proj_bias": ("tp",),
    "linear1.weight": ("tp", None),
    "linear1.bias": ("tp",),
    "out_proj.weight": (None, "tp"),
    "linear2.weight": (None, "tp"),
}


def _spec(name: str) -> tp.Tuple[tp.Optional[str], ...]:
    parts = name.split(".")
    if "crosstransformer" not in parts:
        return ()
    return TP_LEAF_SPECS.get(parts[-1]) or TP_LEAF_SPECS.get(".".join(parts[-2:])) or ()


def transformer_tp_specs(names: tp.Iterable[str]) -> tp.Dict[str, tp.Tuple]:
    """Each dotted parameter name's split (a ``PartitionSpec`` as a tuple):
    the transformer's projections over ``tp``, everything else ``()``."""
    return {name: _spec(name) for name in names}


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Leave(torch.autograd.Function):
    """The partial sums summed over the group; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TPComm:
    """What a sharded attention or layer calls (``models/transformer.py``)."""

    def __init__(self, group):
        self.group = group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(x, self.group)


def _rows(total: int, rank: int, world: int) -> slice:
    if total % world:
        raise ValueError(f"{total} rows do not split over {world} tensor-parallel ranks")
    n = total // world
    return slice(rank * n, (rank + 1) * n)


def shard_module(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """A copy of an HTDemucs ``module`` holding this rank's shard of its
    cross-transformer (module docstring), its collectives over ``group``."""
    from demucs_tpu_torch.models.transformer import Attention, _Layer

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    shard = copy.deepcopy(module)
    comm = TPComm(group)
    transformer = getattr(shard, "crosstransformer", None)
    if transformer is None:
        raise ValueError("tensor parallelism shards HTDemucs's cross-transformer; this "
                         "model has none")

    def keep(param: torch.nn.Parameter, index) -> torch.nn.Parameter:
        return torch.nn.Parameter(param.detach()[index].clone(), param.requires_grad)

    with torch.no_grad():
        for mod in transformer.modules():
            if isinstance(mod, Attention):
                if mod.num_heads % world:
                    raise ValueError(f"{mod.num_heads} heads do not split over {world} ranks")
                dim = mod.out_proj.weight.shape[0]
                mine = _rows(dim, rank, world)
                rows = torch.cat([torch.arange(dim)[mine] + j * dim for j in range(3)])
                mod.in_proj_weight = keep(mod.in_proj_weight, rows)
                mod.in_proj_bias = keep(mod.in_proj_bias, rows)
                mod.out_proj.weight = keep(mod.out_proj.weight, (slice(None), mine))
                mod.num_heads //= world
                mod.tp_comm = comm
            elif isinstance(mod, _Layer):
                mine = _rows(mod.linear1.weight.shape[0], rank, world)
                mod.linear1.weight = keep(mod.linear1.weight, mine)
                mod.linear1.bias = keep(mod.linear1.bias, mine)
                mod.linear2.weight = keep(mod.linear2.weight, (slice(None), mine))
                mod.tp_comm = comm
    return shard


_SHARDS: tp.Dict[tuple, tuple] = {}


def _cached_shard(module: torch.nn.Module, group) -> torch.nn.Module:
    """:func:`shard_module`, kept while ``module`` is unchanged."""
    from demucs_tpu_torch.inference.engine import _module_state

    key = (id(module), id(group), dist.get_rank(group))
    state = _module_state(module)
    entry = _SHARDS.get(key)
    if entry is None or entry[0] != state:
        entry = _SHARDS[key] = (state, shard_module(module, group))
    return entry[1]


def tp_forward(model, mix, group=None) -> np.ndarray:
    """The forward of ``model`` (an HTDemucs ``Model``) on ``mix (B, C, L)``
    with its cross-transformer sharded over the ranks of ``group`` (default:
    all), on the model's device -> the stems ``(B, S, C, L)`` as numpy, the
    same on every rank. The shard is kept between calls."""
    shard = _cached_shard(model.module, group)
    x = torch.as_tensor(np.asarray(mix, np.float32), device=model.device)
    with torch.inference_mode():
        out = shard.eval()(x)
    return out.float().cpu().numpy()


def tp_groups(tp_size: int):
    """The 2-D grid of every rank: ``(dp_group, tp_group)`` of this rank, tp
    the fast axis (ranks ``d * tp_size + t``). Every rank creates every group,
    as ``torch.distributed.new_group`` asks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp_size:
        raise ValueError(f"{world} ranks do not form a grid with tp = {tp_size}")
    dp_size = world // tp_size
    tp_group = dp_group = None
    for d in range(dp_size):
        g = dist.new_group([d * tp_size + t for t in range(tp_size)])
        if rank // tp_size == d:
            tp_group = g
    for t in range(tp_size):
        g = dist.new_group([d * tp_size + t for d in range(dp_size)])
        if rank % tp_size == t:
            dp_group = g
    return dp_group, tp_group


def global_norm(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                tp_group=None) -> torch.Tensor:
    """The global norm of the gradients of ``optimizer`` on a sharded
    ``module``: the replicated parameters' squares (every rank holds their
    whole gradient) plus the shards' squares summed over ``tp_group``. A
    parameter without a gradient counts as zeros."""
    sharded = {id(p) for n, p in module.named_parameters() if _spec(n)}
    square = torch.zeros(2, device=next(module.parameters()).device)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                square[int(id(p) in sharded)] += p.grad.float().pow(2).sum()
    shard_square = square[1:].clone()
    dist.all_reduce(shard_square, group=tp_group)
    return (square[0] + shard_square[0]).sqrt()


def gather_state(module: torch.nn.Module, group=None) -> tp.Dict[str, torch.Tensor]:
    """The whole ``{name: tensor}`` state of a sharded module (its shards
    gathered over ``group`` and put back in place; on the CPU, so Gloo's
    ``all_gather`` takes them), to compare with an unsharded module."""
    world = dist.get_world_size(group)
    out = {}
    for name, param in module.named_parameters():
        value = param.detach().float().cpu().contiguous()
        spec = _spec(name)
        if spec:
            parts = [torch.empty_like(value) for _ in range(world)]
            dist.all_gather(parts, value, group=group)
            axis = spec.index("tp")
            if name.endswith("in_proj_weight") or name.endswith("in_proj_bias"):
                # each rank's rows are its q, k and v thirds: regroup by third
                value = torch.cat([torch.cat([p.chunk(3)[j] for p in parts]) for j in range(3)])
            else:
                value = torch.cat(parts, dim=axis)
        out[name] = value
    return out
