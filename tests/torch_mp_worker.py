"""Ranks of the port's multi-process tests: Gloo CPU processes that import
only the port (never JAX), started by :func:`run_ranks` from the pytest
process, which computes the references (JAX's or the port's one-process
runs) and compares.

    python tests/torch_mp_worker.py TASK DIR

with ``RANK``, ``WORLD_SIZE`` and ``DEMUCS_TORCH_INIT_METHOD`` (a rendezvous
file under ``DIR``, so that xdist workers never race for a port) set by
:func:`run_ranks`. A task reads ``DIR/in.npz`` (and ``DIR/in.json``) where it
needs inputs and writes ``DIR/rank<r>.npz``.
"""

import json
import os
import random
import subprocess
import sys
import typing as tp
from pathlib import Path

import numpy as np

SMALL_HTDEMUCS = dict(channels=8, nfft=1024, depth=4, t_layers=2, t_heads=4, segment=0.25,
                      samplerate=8000, use_train_segment=True)  # tests/mp_worker.py's
RANK_TIMEOUT_S = 120


def run_ranks(task: str, folder: Path, world: int, timeout: float = RANK_TIMEOUT_S,
              extra_env: tp.Optional[dict] = None) -> tp.List[dict]:
    """Run ``world`` ranks of ``task`` on the CPU, each within ``timeout``
    seconds, and return each rank's outputs (``rank<r>.npz``)."""
    folder.mkdir(parents=True, exist_ok=True)
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEMUCS_TORCH_", "MASTER_", "SLURM_"))}
    env.update(WORLD_SIZE=str(world), DEMUCS_TORCH_PLATFORM="cpu", OMP_NUM_THREADS="1",
               DEMUCS_TORCH_INIT_METHOD=f"file://{folder / 'rendezvous'}",
               PYTHONPATH=os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p))
    env.update(extra_env or {})
    procs = [subprocess.Popen([sys.executable, __file__, task, str(folder)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n\n".join(f"=== rank {r} (exit {p.returncode}) ===\n{log[-4000:]}"
                                   for r, (p, log) in enumerate(zip(procs, logs)))
    return [dict(np.load(folder / f"rank{r}.npz")) for r in range(world)]


def task_distrib(folder: Path, rank: int) -> dict:
    """The collectives of ``train/distrib.py`` on the ranks: ``share`` from
    every rank, ``average`` of metrics with keys that differ by rank,
    ``all_reduce_mean`` over buckets, ``barrier``, and the loader's shards."""
    import torch

    from demucs_tpu_torch.train import distrib

    world = distrib.world_size()
    merged: dict = {}
    for src in range(world):
        merged.update(distrib.share({f"r{rank}": rank}, src))
    assert merged == {f"r{r}": r for r in range(world)}, merged
    metrics = {"loss": float(rank), f"only{rank}": 10.0 + rank}
    avg = distrib.average(metrics, count=rank + 1)
    distrib.BUCKET_ELEMENTS = 5  # several buckets, one tensor larger than a bucket
    tensors = [torch.full((3,), float(rank)), torch.full((7,), 2.0 * rank), torch.ones(2)]
    distrib.all_reduce_mean(tensors)
    distrib.barrier()
    loader = distrib.DataLoader(list(range(11)), batch_size=2, shuffle=True, seed=3)
    loader.set_epoch(1)
    return {"avg_keys": np.array(sorted(avg)), "avg_loss": avg["loss"],
            "avg_only0": avg["only0"], "avg_only1": avg["only1"],
            "reduced": torch.cat(tensors).numpy(), "indices": loader.indices(),
            "batches": np.array(len(loader))}


def task_auto_devices(folder: Path, rank: int) -> dict:
    """``auto_devices`` on a rank of a group of several, on a machine that
    reports four cards (the CUDA queries stubbed): None, so that each rank
    separates on its own card and takes none of the others'."""
    from unittest import mock

    import torch

    from demucs_tpu_torch.parallel import sharded

    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: 4):
        auto = sharded.auto_devices("cuda:0")
    return {"auto_is_none": np.array(auto is None)}


def _small_model(seed: int, **kw):
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model

    cfg = HTDemucsConfig(**dict(SMALL_HTDEMUCS, **kw))
    return Model("htdemucs", cfg, init_htdemucs(cfg, seed=seed).eval())


def bag_inputs():
    """The 4-member bag and the track of ``tests/mp_infer_worker.py``."""
    from demucs_tpu_torch.models.registry import BagOfModels

    bag = BagOfModels([_small_model(s) for s in range(4)])
    length = int(2.6 * SMALL_HTDEMUCS["segment"] * SMALL_HTDEMUCS["samplerate"])
    mix = (np.random.default_rng(7).standard_normal((1, 2, length)) * 0.1).astype(np.float32)
    return bag, mix


def task_bag(folder: Path, rank: int) -> dict:
    """The bag fanned out over the ranks, shifts 0 and 1."""
    import torch.distributed as dist

    from demucs_tpu_torch.inference.engine import device_apply_model

    bag, mix = bag_inputs()
    world = dist.group.WORLD
    return {"shifts0": device_apply_model(bag, mix, shifts=0, group=world),
            "shifts1": device_apply_model(bag, mix, shifts=1, rng=random.Random(5), group=world)}


def step_model(flat: dict, cfg_kw: dict):
    """The port's HTDemucs of ``cfg_kw`` holding the weights ``flat``, fp32, in
    train mode."""
    from demucs_tpu_torch.models.htdemucs import HTDemucs, HTDemucsConfig
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.zoo.convert import load_flat_state

    cfg = HTDemucsConfig(**cfg_kw)
    module = load_flat_state(HTDemucs(cfg).float(), flat).train()
    return Model("htdemucs", cfg, module)


def one_step(model, sources, *, loss="l1", lr=0.0, augment=None, seed=0, group=None,
             clip_grad=0.0):
    """One ``train_step`` at learning rate ``lr`` -> its metrics, the
    gradients and the weights after it, as numpy."""
    import torch

    from demucs_tpu_torch.train import config, step

    args = config.TrainArgs()
    args.optim.lr = lr
    optimizer = step.make_optimizer(args, model)
    m = step.train_step(model, optimizer, torch.from_numpy(sources), loss=loss,
                        weights=(1.0, 2.0, 0.5, 1.0), generator=torch.Generator().manual_seed(seed),
                        augment=augment, clip_grad=clip_grad, group=group)
    out = {"loss": m["loss"].numpy(), "reco": m["reco"].numpy(),
           "grad_norm": m["grad_norm"].numpy()}
    for name, p in model.module.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
        out[f"param/{name}"] = p.detach().numpy().copy()
    return out


def step_augment():
    from demucs_tpu_torch.train.augment import AugmentConfig, make_augment

    return make_augment(AugmentConfig(shift=400, remix_group_size=2), full=True)


def task_step(folder: Path, rank: int) -> dict:
    """Each rank's rows of the global batch in ``in.npz``: an l1 and an mse
    step at lr 0 (the averaged gradients), and a step with dropout and the
    full augment pipeline at lr 1e-3."""
    import torch.distributed as dist

    inputs = dict(np.load(folder / "in.npz"))
    cfg_kw = json.loads((folder / "in.json").read_text())
    flat = {k[2:]: v for k, v in inputs.items() if k.startswith("w/")}
    world = dist.get_world_size()
    sources = inputs["sources"]
    per = sources.shape[0] // world
    mine = sources[rank * per: (rank + 1) * per]
    out = {}
    for loss in ("l1", "mse"):
        got = one_step(step_model(flat, cfg_kw), mine, loss=loss)
        out.update({f"{loss}/{k}": v for k, v in got.items()})
    sources = inputs["sources_aug"]  # 400 samples longer: the augment's shift
    mine = sources[rank * per: (rank + 1) * per]
    drop = step_model(flat, dict(cfg_kw, t_dropout=0.1))
    got = one_step(drop, mine, lr=1e-3, augment=step_augment(), seed=3, clip_grad=0.5)
    out.update({f"dropout/{k}": v for k, v in got.items()})
    return out


def task_tp(folder: Path, rank: int) -> dict:
    """``tp_forward`` of the weights in ``in.npz`` over every rank; then, on
    four ranks, a dp x tp (2 x 2) step of the global batch, its weights
    gathered."""
    import torch
    import torch.distributed as dist

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.parallel import tp as tpar
    from demucs_tpu_torch.train import config, step

    inputs = dict(np.load(folder / "in.npz"))
    cfg_kw = json.loads((folder / "in.json").read_text())
    flat = {k[2:]: v for k, v in inputs.items() if k.startswith("w/")}
    model = step_model(flat, cfg_kw)
    model.module.eval()
    out = {"forward": tpar.tp_forward(model, inputs["mix"])}
    if dist.get_world_size() == 4:
        dp_group, tp_group = tpar.tp_groups(2)
        shard = Model("htdemucs", model.cfg, tpar.shard_module(model.module, tp_group).train())
        args = config.TrainArgs()
        args.optim.lr = 1e-3
        optimizer = step.make_optimizer(args, shard)
        sources = inputs["sources"]
        per = sources.shape[0] // 2
        d = rank // 2
        m = step.train_step(shard, optimizer, torch.from_numpy(sources[d * per:(d + 1) * per]),
                            group=dp_group, tp_group=tp_group, clip_grad=0.5,
                            weights=(1.0, 2.0, 0.5, 1.0))
        out.update(loss=m["loss"].numpy(), grad_norm=m["grad_norm"].numpy())
        out.update({f"param/{k}": v.numpy() for k, v in
                    tpar.gather_state(shard.module, tp_group).items()})
    return out


def solver_overrides(folder: Path) -> tp.List[str]:
    """tests/mp_worker.py's Demucs v2 solver run, augments off (``dset.shift=0``:
    no shift, windows a segment apart), on the MusdbHQ-shaped folder
    :func:`write_musdb` made."""
    return [f"dset.musdb={folder / 'musdb'}", f"dset.metadata={folder / 'metadata'}",
            "dset.samplerate=8000", "dset.segment=1", "dset.shift=0",
            "dset.valid_tracks=[ValTrack]", "epochs=1", "batch_size=4", "max_batches=2",
            "model=demucs", "augment.repitch.proba=0", "augment.flip=false",
            "augment.scale.proba=0", "augment.remix.proba=0", "test.every=99", "test.sdr=false",
            "misc.num_workers=0", f"out_dir={folder / 'outputs'}",
            "model_args={channels: 4, depth: 2, resample: false, dconv_mode: 0, "
            "lstm_layers: 0}"]


def write_musdb(root: Path, sr: int = 8000, seconds: float = 8.0) -> None:
    from demucs_tpu_torch import audio

    rng = np.random.default_rng(0)
    for subset, name in [("train", "TrackA"), ("train", "TrackB"), ("train", "ValTrack"),
                         ("test", "TestTrack")]:
        folder = root / subset / name
        folder.mkdir(parents=True, exist_ok=True)
        stems = []
        for source in ("drums", "bass", "other", "vocals"):
            wav = (rng.standard_normal((2, int(seconds * sr))) * 0.05).astype(np.float32)
            audio.write_wav(folder / f"{source}.wav", wav, sr, as_float=True)
            stems.append(wav)
        audio.write_wav(folder / "mixture.wav", sum(stems), sr, as_float=True)


def task_solver(folder: Path, rank: int) -> dict:
    """One epoch of the entry point's Solver; counts each rank's writes."""
    from demucs_tpu_torch.train import config, distrib
    from demucs_tpu_torch.train.solver import Solver
    from demucs_tpu_torch.train.train import get_solver

    writes = {"serialize": 0, "history": 0}

    def counted(name, fn):
        def wrapper(self, *a, **kw):
            writes[name] += 1
            return fn(self, *a, **kw)
        return wrapper

    Solver._serialize = counted("serialize", Solver._serialize)
    Solver._push_history = counted("history", Solver._push_history)
    args = config.apply_overrides(config.TrainArgs(),
                                  config.parse_cli_overrides(solver_overrides(folder)))
    solver = get_solver(args, device="cpu")
    assert solver.loaders["train"].batch_size == 4 // distrib.world_size()
    solver.train()
    last = solver.history[-1]
    return {"train_loss": np.float64(last["train"]["loss"]),
            "valid_loss": np.float64(last["valid"]["loss"]),
            "nsdr": np.float64(last["valid"]["nsdr"]),
            "serialize": np.int64(writes["serialize"]), "history": np.int64(writes["history"])}


def main() -> None:
    import torch

    from demucs_tpu_torch.train import distrib

    task, folder = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    distrib.init()
    rank = distrib.rank()
    out = globals()[f"task_{task}"](folder, rank)
    assert "jax" not in sys.modules and "demucs_tpu" not in sys.modules
    np.savez(folder / f"rank{rank}.npz", **out)
    distrib.barrier()


if __name__ == "__main__":
    main()
