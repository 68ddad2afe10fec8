"""Training entry point: config -> model, optimizer, datasets -> Solver
(port of ``demucs_tpu/train/train.py``; behavioral reference ``demucs/train.py``).

    python -m demucs_tpu_torch.train model=htdemucs dset.wav=/path epochs=2 [device=cpu]
    python -m demucs_tpu_torch.launcher -n 4 -- model=htdemucs dset.wav=/path
    torchrun --nproc-per-node 4 -m demucs_tpu_torch.train model=htdemucs dset.wav=/path
    srun --ntasks-per-node 4 python -m demucs_tpu_torch.train model=htdemucs ...

Overrides are ``key=value`` tokens of :class:`~demucs_tpu_torch.train.config.TrainArgs`
(``dset=NAME`` selects a dataset preset); ``device=`` (not part of the
config, default ``cuda``) picks the device. The reference's defaults train
as they are (the repitch augment at 0.2), and so do ``svd.penalty``,
``quant.diffq`` and ``quant.qat``. XP folders are
``{out_dir}/xps/{signature}``, resumed from their checkpoint when one is
there.

On several processes (``distrib.init`` reads the launcher's, torchrun's or
Slurm's environment) the run is data-parallel, as the JAX package's: each
rank trains on its device (``cuda:LOCAL_RANK``, the CPU under the launcher's
``--platform cpu``) with ``batch_size / world`` items a step, and the step
averages the gradients; rank 0 builds the datasets' metadata and writes the
XP folder. :func:`check_supported` refuses what the JAX package's
multi-process path refuses, or what would train another function here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from pathlib import Path

import numpy as np

from demucs_tpu_torch import resolve_device
from demucs_tpu_torch.models.registry import FAMILIES, Model
from demucs_tpu_torch.train import distrib
from demucs_tpu_torch.train.config import (TrainArgs, apply_overrides, expand_presets,
                                           parse_cli_overrides, xp_signature)
from demucs_tpu_torch.train.solver import Solver
from demucs_tpu_torch.train.step import make_optimizer
from demucs_tpu_torch.train.wav import get_musdb_wav_datasets, get_wav_datasets

__all__ = ["check_supported", "get_model", "get_datasets", "get_solver", "main"]

logger = logging.getLogger(__name__)


def _world() -> int:
    """The processes of this run: the process group's, else the launcher's
    environment (``WORLD_SIZE``) or a multi-task Slurm step's, read before
    :func:`distrib.init`."""
    if distrib.world_size() > 1:
        return distrib.world_size()
    env = int(os.environ.get("WORLD_SIZE", "1") or 1)
    return max(env, int(os.environ.get("SLURM_STEP_NUM_TASKS", "1") or 1))


def check_supported(args: TrainArgs) -> None:
    """Raise ``ValueError`` where several processes cannot train ``args``: a
    global batch that the processes do not split evenly (the JAX package's
    train.py:159-160), and remix groups that would straddle two processes
    (JAX permutes a group's sources over the global array; a rank here holds
    only its rows; ``group_size`` 0, the whole batch, straddles them all)."""
    world = _world()
    if world <= 1:
        return
    if args.batch_size % world:
        raise ValueError(f"batch_size {args.batch_size} does not split evenly over {world} "
                         "processes")
    group = args.augment.remix.group_size
    per_process = args.batch_size // world
    # group_size 0 remixes the whole (global) batch: one group over every process
    if args.augment.remix.proba and (group == 0 or per_process % group):
        raise ValueError(f"remix groups of {group or args.batch_size} would straddle processes "
                         f"holding {per_process} items each: make the per-process batch "
                         "a multiple of augment.remix.group_size")


def get_model(args: TrainArgs, device="cuda") -> Model:
    """The model of ``args.model`` with its extras (train.py:57-72), seeded
    random weights, on ``device``, with ``args.remat``. Every parameter is
    fp32: an HTDemucs with bf16 stages (``compute_dtype="bfloat16"`` or
    ``bf16_stages`` in ``model_args``) casts them on each forward, as the
    JAX package trains, so gradients, optimizer state and checkpoints are
    fp32."""
    kw = dict(args.model_args)
    kw.update(sources=tuple(args.dset.sources), audio_channels=args.dset.channels,
              samplerate=args.dset.samplerate,
              segment=args.model_segment or 4 * args.dset.segment)
    try:
        cfg_cls, _ = FAMILIES[args.model]
    except KeyError:
        raise ValueError(f"Unknown model {args.model}") from None
    cfg = cfg_cls(**kw)
    kw = {}
    if args.model == "htdemucs":
        from demucs_tpu_torch.models.htdemucs import init_htdemucs as init

        kw["fp32_masters"] = True
    elif args.model == "hdemucs":
        from demucs_tpu_torch.models.hdemucs import init_hdemucs as init
    else:
        from demucs_tpu_torch.models.demucs import init_demucs as init
    module = init(cfg, seed=args.seed, **kw)
    module.remat = args.remat
    return Model(args.model, cfg, module.to(resolve_device(device)))


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = [d for d in datasets if len(d)]
        self.lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, index):
        for d, n in zip(self.datasets, self.lengths):
            if index < n:
                return d[index]
            index -= n
        raise IndexError(index)


class Subset:
    """A lazy index view: items load when read."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        return self.dataset[self.indices[index]]


def random_subset(dataset, max_samples: int, seed: int = 42):
    """At most ``max_samples`` items of ``dataset``, drawn from ``seed`` (utils.py:113-119)."""
    if max_samples >= len(dataset):
        return dataset
    perm = np.random.default_rng(seed).permutation(len(dataset))
    return Subset(dataset, [int(i) for i in perm[:max_samples]])


def get_datasets(args: TrainArgs):
    """The train and valid sets (train.py:109-148)."""
    train_set: list = []
    valid_set: list = []
    if args.dset.use_musdb and args.dset.musdb:
        train_set, valid_set = get_musdb_wav_datasets(args.dset)
    if args.dset.wav:
        extra_train, extra_valid = get_wav_datasets(args.dset)
        if len(args.dset.sources) <= 4 and train_set:
            train_set = ConcatDataset([train_set, extra_train])
            valid_set = ConcatDataset([valid_set, extra_valid])
        else:
            train_set, valid_set = extra_train, extra_valid
    if args.dset.wav2:
        extra_train, extra_valid = get_wav_datasets(args.dset, "wav2")
        weight = args.dset.wav2_weight
        reps = 1
        if weight is not None:
            reps = max(1, round(len(extra_train) / len(train_set) * (1 / weight - 1)))
        train_set = ConcatDataset([train_set] * reps + [extra_train])
        if args.dset.wav2_valid:
            if weight is not None:
                kept = int(round(weight * len(valid_set) / (1 - weight)))
                extra_valid = random_subset(extra_valid, kept)
            valid_set = ConcatDataset([valid_set, extra_valid])
    if args.dset.valid_samples is not None:
        valid_set = random_subset(valid_set, args.dset.valid_samples)
    if not (len(train_set) and len(valid_set)):
        raise ValueError("empty train or valid set: give dset.musdb or dset.wav")
    return train_set, valid_set


def get_solver(args: TrainArgs, model_only: bool = False, device=None) -> Solver:
    """(train.py:151-204). ``device``: one process's device (default: the
    platform's, ``cuda``); on several processes each rank's own
    (:func:`distrib.init`), and ``device`` may only name its type."""
    check_supported(args)
    rank_device = distrib.init()
    if distrib.world_size() > 1:
        if device is not None and resolve_device(device).type != rank_device.type:
            raise ValueError(f"device={device} on a rank whose device is {rank_device}")
        device = rank_device
    device = device if device is not None else rank_device
    per_process_batch = args.batch_size // distrib.world_size()
    model = get_model(args, device)
    optimizer = make_optimizer(args, model)
    folder = Path(args.out_dir) / "xps" / xp_signature(args)
    if model_only:
        return Solver({}, model, optimizer, args, folder)
    train_set, valid_set = get_datasets(args)
    repitch = args.augment.repitch
    if repitch.proba:  # train.py:170-180
        from demucs_tpu_torch.train.repitch import RepitchedWrapper

        sources = list(args.dset.sources)
        train_set = RepitchedWrapper(train_set, proba=repitch.proba,
                                     max_tempo=repitch.max_tempo,
                                     vocals=[sources.index("vocals")] if "vocals" in sources
                                     else [], samplerate=args.dset.samplerate, seed=args.seed)
        logger.info("repitch augment: proba %s, backend %s", repitch.proba,
                    train_set.backend)
    logger.info("train/valid set size: %d %d", len(train_set), len(valid_set))
    workers = args.misc.num_workers
    loaders = {
        "train": distrib.loader(train_set, per_process_batch, shuffle=True,
                                num_workers=workers, seed=args.seed),
        "valid": distrib.loader(valid_set, 1 if args.dset.full_cv else per_process_batch,
                                drop_last=not args.dset.full_cv, num_workers=workers)}
    return Solver(loaders, model, optimizer, args, folder)


def main(argv=None) -> Solver:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    argv = sys.argv[1:] if argv is None else argv
    bad = [a for a in argv if "=" not in a]
    if bad:
        raise SystemExit(f"arguments must be key=value overrides, got: {bad}")
    overrides = expand_presets(parse_cli_overrides(argv))
    device = overrides.pop("device", None)
    args = apply_overrides(TrainArgs(), overrides)
    logger.info("XP signature: %s", xp_signature(args))
    logger.info("config: %s", dataclasses.asdict(args))
    solver = get_solver(args, device=device)
    solver.train()
    return solver


if __name__ == "__main__":
    main()
