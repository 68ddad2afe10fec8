"""Ranks, collectives and the rank-sharded batch loader (port of
``demucs_tpu/train/distrib.py``; behavioral reference ``demucs/distrib.py``).

The processes are those of ``torch.distributed``. :func:`init` starts the
process group from the environment, as the reference's ``dora run -d`` and
the JAX package's ``jax.distributed`` do:

- from ``python -m demucs_tpu_torch.launcher`` or ``torchrun``: ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
- from a multi-task Slurm step (``SLURM_STEP_NUM_TASKS > 1``, set by
  ``srun`` per step): ``SLURM_PROCID``, ``SLURM_STEP_NUM_TASKS``,
  ``SLURM_LOCALID`` and the step's first node. A plain ``python`` inside an
  sbatch script (``SLURM_NTASKS`` inherited, no step of several tasks) stays
  one process.

Each rank's device is ``cuda:LOCAL_RANK``, or the CPU where
``DEMUCS_TORCH_PLATFORM=cpu`` (the launcher's ``--platform cpu``);
``DEMUCS_TORCH_DEVICE`` names it explicitly (two ranks on one card). The
backend is NCCL on a card and Gloo on the CPU; ``DEMUCS_TORCH_BACKEND`` (or
``init(backend=...)``) picks another, e.g. Gloo on CUDA tensors, which is what
two ranks on one card need (NCCL refuses two ranks on one device). A card that
is not there raises; nothing falls back to the CPU or from NCCL to Gloo.

Without a process group this one process is the only rank and every helper
takes its one-process path, so the whole port runs single-process unchanged.
"""

from __future__ import annotations

import datetime
import inspect
import os
import re
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init", "device", "initialized", "world_size", "rank", "average", "barrier", "share",
           "shard_indices", "all_reduce_mean", "DataLoader", "loader", "PLATFORM_ENV",
           "DEVICE_ENV", "BACKEND_ENV", "INIT_METHOD_ENV"]

PLATFORM_ENV = "DEMUCS_TORCH_PLATFORM"  # "cpu": CPU ranks under Gloo
DEVICE_ENV = "DEMUCS_TORCH_DEVICE"  # this rank's device, e.g. "cuda:0"
BACKEND_ENV = "DEMUCS_TORCH_BACKEND"  # "nccl" or "gloo"
INIT_METHOD_ENV = "DEMUCS_TORCH_INIT_METHOD"  # e.g. "file:///tmp/rdv" (default env://)
_DEVICE: tp.Optional[torch.device] = None
# gradient buckets of at most this many fp32 elements (64 MiB)
BUCKET_ELEMENTS = 1 << 24


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _first_node(nodelist: str) -> str:
    """The first host of a Slurm node list: ``"gpu[03-05,09],cpu1"`` -> ``"gpu03"``."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if m is None:
        raise ValueError(f"cannot read the Slurm node list {nodelist!r}")
    prefix, ranges = m.groups()
    return prefix if ranges is None else prefix + ranges.split(",")[0].split("-")[0]


def _slurm_env() -> tp.Optional[tp.Dict[str, str]]:
    """The process group's environment of a multi-task Slurm step, else None."""
    tasks = int(os.environ.get("SLURM_STEP_NUM_TASKS", "1") or 1)
    if tasks <= 1:
        return None
    job = int(os.environ.get("SLURM_JOB_ID", "0") or 0)
    nodes = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get("SLURM_NODELIST", "")
    return {"RANK": os.environ["SLURM_PROCID"], "WORLD_SIZE": str(tasks),
            "LOCAL_RANK": os.environ.get("SLURM_LOCALID", "0"),
            "MASTER_ADDR": os.environ.get("MASTER_ADDR") or _first_node(nodes or "localhost"),
            "MASTER_PORT": os.environ.get("MASTER_PORT") or str(20000 + job % 20000)}


def _rank_device(local_rank: int) -> torch.device:
    """This rank's device (module docstring); a card that is not there raises."""
    name = os.environ.get(DEVICE_ENV)
    if not name:
        name = "cpu" if os.environ.get(PLATFORM_ENV) == "cpu" else f"cuda:{local_rank}"
    dev = torch.device(name)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else local_rank
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if index >= count:
            raise RuntimeError(f"rank device {dev} asked for, but this machine has {count} "
                               "CUDA device(s); nothing falls back to the CPU")
        dev = torch.device("cuda", index)
    return dev


def init(backend: tp.Optional[str] = None, init_method: tp.Optional[str] = None,
         timeout_s: float = 1800.0) -> torch.device:
    """Start the process group from the environment (module docstring) and
    return this rank's device. A launched rank (``RANK`` set, as the launcher
    and torchrun set it) joins a group even at world size 1, so one card runs
    the collectives on NCCL; a plain process (no ``RANK``, no multi-task
    Slurm step) starts none, and its device is the platform's default
    (``cuda`` unless ``DEMUCS_TORCH_PLATFORM=cpu``). Idempotent."""
    global _DEVICE
    env = dict(os.environ)
    slurm = _slurm_env() if "RANK" not in env else None
    if slurm is not None:
        env.update(slurm)
        os.environ.update(slurm)  # env:// rendezvous reads them
    world = int(env.get("WORLD_SIZE", "1") or 1)
    local_rank = int(env.get("LOCAL_RANK", "0") or 0)
    if _initialized():
        return device()
    if world <= 1 and "RANK" not in env:
        _DEVICE = _rank_device(0) if (env.get(DEVICE_ENV) or env.get(PLATFORM_ENV)) else None
        return device()
    dev = _rank_device(local_rank)
    backend = backend or env.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device for every rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = dev  # binds the communicator to the rank's card at once
    dist.init_process_group(backend, init_method=init_method or env.get(INIT_METHOD_ENV)
                            or "env://", world_size=world, rank=int(env["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _DEVICE = dev
    return dev


def device() -> torch.device:
    """This rank's device as :func:`init` chose it (``cuda`` unless the
    platform is the CPU when no rank device was named)."""
    if _DEVICE is not None:
        return _DEVICE
    return torch.device("cpu" if os.environ.get(PLATFORM_ENV) == "cpu" else "cuda")


def initialized() -> bool:
    """Whether this process is a rank of a process group (of any size)."""
    return _initialized()


def world_size(group=None) -> int:
    """The number of ranks of ``group`` (default: all), 1 without a process group."""
    return dist.get_world_size(group) if _initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (default: all), 0 without a process group."""
    return dist.get_rank(group) if _initialized() else 0


def _all_gather_obj(obj: tp.Any) -> tp.List[tp.Any]:
    out: tp.List[tp.Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def average(metrics: tp.Mapping[str, float], count: float = 1.0) -> tp.Dict[str, float]:
    """Weighted average of metrics over the ranks (distrib.py:32-42). Ranks
    may carry different keys (one that drew no valid batch): each key
    averages over the ranks that have it, weighted by their ``count``."""
    if world_size() == 1:
        return dict(metrics)
    sums: tp.Dict[str, float] = {}
    counts: tp.Dict[str, float] = {}
    for m, c in _all_gather_obj((dict(metrics), float(count))):
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v) * c
            counts[k] = counts.get(k, 0.0) + c
    return {k: sums[k] / counts[k] for k in sums}


def barrier() -> None:
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


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


def all_reduce_mean(tensors: tp.Sequence[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over the ranks of ``group`` (default: all):
    flattened into fp32 buckets of at most ``BUCKET_ELEMENTS``, one
    ``all_reduce`` (sum) each, divided by the group's size. Gloo and NCCL both
    take CUDA tensors for ``all_reduce``."""
    if not (_initialized() and tensors):
        return
    n = world_size(group)
    bucket: tp.List[torch.Tensor] = []
    size = 0
    for t in list(tensors) + [None]:
        if t is not None and (not bucket or size + t.numel() <= BUCKET_ELEMENTS):
            bucket.append(t)
            size += t.numel()
            continue
        flat = torch.cat([b.reshape(-1).float() for b in bucket])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for b in bucket:
            b.copy_(flat[offset: offset + b.numel()].view_as(b))
            offset += b.numel()
        if t is not None:
            bucket, size = [t], t.numel()


class DataLoader:
    """Batches of a map-style dataset as stacked numpy arrays, sharded over
    the ranks (the reference's DataLoader + DistributedSampler,
    distrib.py:84-100): a shuffle seeded by ``seed + epoch`` (``set_epoch``,
    passed on to a dataset that has one: the repitch augment's draws), padded
    with wrapped-around indices to a multiple of the world size so that every
    rank draws the same number of batches, then strided by rank; with
    ``num_workers`` the items of a batch load on a thread pool."""

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

    def _per_rank(self) -> int:
        # DistributedSampler's padding: unequal counts would leave one rank in
        # the step's gradient all-reduce while the others gather metrics
        return -(-len(self.dataset) // world_size())

    def __len__(self) -> int:
        n = self._per_rank()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        """This rank's item indices of the epoch, in order."""
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle
                 else np.arange(n))
        world = world_size()
        total = self._per_rank() * world
        if total > n:
            order = np.concatenate([order, order[: total - n]])
        return order[rank()::world]

    def __iter__(self):
        mine = self.indices()
        batches = [[int(i) for i in mine[k: k + self.batch_size]]
                   for k in range(0, len(mine), self.batch_size)]
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


def loader(dataset, batch_size: int, shuffle: bool = False, **kw) -> DataLoader:
    """A rank-sharded loader (distrib.py:84-100)."""
    return DataLoader(dataset, batch_size, shuffle=shuffle, **kw)
