"""Ranks, collectives and the rank-sharded loader of the port
(demucs_tpu_torch.train.distrib) against the JAX package's
``demucs_tpu/train/distrib.py``: the loader's shards and DistributedSampler
padding index for index, ``average`` with keys that differ by rank, ``share``,
``barrier`` and ``all_reduce_mean`` on two Gloo CPU processes
(``tests/torch_mp_worker.py``), and ``init`` from the launcher's, torchrun's
and a multi-task Slurm step's environments (two ranks of the probe each)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from demucs_tpu.train import distrib as jdistrib
from demucs_tpu_torch.train import distrib

import torch_mp_worker as W

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n,world,batch,drop_last", [
    (11, 2, 2, True), (11, 3, 2, False), (8, 2, 4, True), (5, 4, 1, False), (7, 1, 3, False)])
def test_loader_shards_match_jax(monkeypatch, n, world, batch, drop_last):
    dataset = [np.full((2,), i, np.float32) for i in range(n)]
    seen = []
    for rank in range(world):
        for mod in (distrib, jdistrib):
            monkeypatch.setattr(mod, "world_size", lambda group=None, w=world: w)
            monkeypatch.setattr(mod, "rank", lambda group=None, r=rank: r)
        ours = distrib.DataLoader(dataset, batch, shuffle=True, drop_last=drop_last, seed=5)
        theirs = jdistrib.DataLoader(dataset, batch, shuffle=True, drop_last=drop_last, seed=5)
        ours.set_epoch(2)
        theirs.set_epoch(2)
        got = [b[:, 0].tolist() for b in ours]
        assert got == [b[:, 0].tolist() for b in theirs]
        assert len(ours) == len(theirs) == len(got)
        seen += [int(i) for i in ours.indices()]
    assert set(seen) == set(range(n)) and len(seen) == -(-n // world) * world


def test_average_with_keys_that_differ_by_rank(monkeypatch):
    ranks = [({"loss": 1.0, "a": 2.0}, 1.0), ({"loss": 3.0, "b": 5.0}, 3.0)]
    monkeypatch.setattr(distrib, "world_size", lambda group=None: 2)
    monkeypatch.setattr(distrib, "_all_gather_obj", lambda obj: ranks)
    monkeypatch.setattr(jdistrib, "world_size", lambda: 2)
    monkeypatch.setattr(jdistrib, "_allgather_obj", lambda obj: ranks)
    got = distrib.average({"loss": 1.0}, 1.0)
    assert got == jdistrib.average({"loss": 1.0}, 1.0)
    assert got == {"loss": 2.5, "a": 2.0, "b": 5.0}


def test_one_process_without_a_group():
    assert distrib.world_size() == 1 and distrib.rank() == 0
    assert distrib.average({"x": 1.0}, 3) == {"x": 1.0}
    distrib.barrier()
    distrib.all_reduce_mean([np.zeros(1)])  # nothing to reduce


def test_collectives_on_two_ranks(tmp_path):
    ranks = W.run_ranks("distrib", tmp_path, world=2)
    for got in ranks:
        assert got["avg_keys"].tolist() == ["loss", "only0", "only1"]
        assert got["avg_loss"] == pytest.approx((0 * 1 + 1 * 2) / 3)
        assert got["avg_only0"] == 10.0 and got["avg_only1"] == 11.0
        np.testing.assert_array_equal(got["reduced"], [0.5] * 3 + [1.0] * 7 + [1.0] * 2)
        assert int(got["batches"]) == 3
    both = np.concatenate([r["indices"] for r in ranks]).tolist()
    # 11 items padded to 12 with one wrapped-around index: 6 a rank, all covered
    assert len(ranks[0]["indices"]) == len(ranks[1]["indices"]) == 6
    assert set(both) == set(range(11)) and len(both) == 12


def test_first_node_of_a_slurm_node_list():
    assert distrib._first_node("gpu[03-05,09],cpu1") == "gpu03"
    assert distrib._first_node("node7") == "node7"
    assert distrib._first_node("a[1,4]") == "a1"


def _probe_env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_",
                                "DEMUCS_TORCH_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["DEMUCS_TORCH_PLATFORM"] = "cpu"
    env.update(kw)
    return env


def _two_ranks(envs):
    procs = [subprocess.Popen([sys.executable, "-m", "demucs_tpu_torch.distprobe"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=W.RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.mark.parametrize("style", ["torchrun", "slurm"])
def test_init_from_the_environment(style, tmp_path):
    from demucs_tpu_torch.launcher import _free_port

    port = str(_free_port())
    if style == "torchrun":
        envs = [_probe_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port) for r in range(2)]
    else:  # a multi-task srun step (SLURM_NTASKS alone would not start a group)
        envs = [_probe_env(SLURM_STEP_NUM_TASKS="2", SLURM_NTASKS="2", SLURM_PROCID=str(r),
                           SLURM_LOCALID=str(r), SLURM_STEP_NODELIST="localhost",
                           SLURM_JOB_ID="77", MASTER_PORT=port) for r in range(2)]
    codes, outs = _two_ranks(envs)
    assert codes == [0, 0], outs
    for r, out in enumerate(outs):
        assert f"DISTPROBE_OK {r}/2 device=cpu backend=gloo" in out, out


def test_a_plain_process_in_an_allocation_stays_one(tmp_path):
    out = subprocess.run([sys.executable, "-m", "demucs_tpu_torch.distprobe"],
                         env=_probe_env(SLURM_NTASKS="4", SLURM_PROCID="0"),
                         capture_output=True, text=True, timeout=W.RANK_TIMEOUT_S)
    assert out.returncode == 0 and "DISTPROBE_OK 0/1 device=cpu backend=none" in out.stdout


def test_a_missing_card_raises(monkeypatch):
    monkeypatch.delenv("DEMUCS_TORCH_PLATFORM", raising=False)
    monkeypatch.setenv("DEMUCS_TORCH_DEVICE", "cuda:3")
    monkeypatch.setattr(distrib.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nothing falls back to the CPU"):
        distrib._rank_device(0)
