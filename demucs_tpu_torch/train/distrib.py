"""Ranks for test-set evaluation (the part of ``demucs_tpu/train/distrib.py``
that ``evaluate`` needs; the rest comes with the parallelism slice of the
port).

Behavioral reference: ``demucs/distrib.py``. The processes are those of
``torch.distributed`` where it is initialized (Gloo on the CPU, NCCL on the
card: the caller initializes it), else this one process is the only rank.
"""

from __future__ import annotations

import typing as tp

import torch.distributed as dist

__all__ = ["world_size", "rank", "share", "shard_indices"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def share(obj: tp.Any = None, src: int = 0) -> tp.Any:
    """Broadcast a picklable object from rank ``src`` to every rank
    (distrib.py:61-81); every rank calls it with the same ``src``."""
    if world_size() == 1:
        return obj
    box = [obj if rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_indices(n: int) -> range:
    """Round-robin share of ``range(n)`` for this rank (evaluate.py:94)."""
    return range(rank(), n, world_size())
