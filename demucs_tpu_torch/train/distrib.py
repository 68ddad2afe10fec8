"""Ranks and the batch loader (the parts of ``demucs_tpu/train/distrib.py``
that evaluation and one-process training need; training on several processes
comes with the parallelism slice of the port).

Behavioral reference: ``demucs/distrib.py``. The processes are those of
``torch.distributed`` where it is initialized (Gloo on the CPU, NCCL on the
card: the caller initializes it), else this one process is the only rank.
"""

from __future__ import annotations

import typing as tp

import torch.distributed as dist

__all__ = ["world_size", "rank", "share", "shard_indices", "DataLoader"]


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



class DataLoader:
    """Batches of a map-style dataset as stacked numpy arrays, for one process
    (the reference's DataLoader, distrib.py:84-100): a shuffle seeded by
    ``seed + epoch`` (``set_epoch``, passed on to a dataset that has one: the
    repitch augment's draws); with ``num_workers`` the items of a batch load
    on a thread pool."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                 num_workers: int = 0, seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        import numpy as np

        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle
                 else np.arange(n))
        batches = [[int(i) for i in order[k: k + self.batch_size]]
                   for k in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                for ids in batches:
                    yield np.stack(list(pool.map(self.dataset.__getitem__, ids)))
        else:
            for ids in batches:
                yield np.stack([self.dataset[i] for i in ids])
