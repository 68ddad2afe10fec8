"""The port's launcher (demucs_tpu_torch.launcher): each rank's environment,
a two-rank probe, a failing rank's code propagated (the other rank stopped),
a missing card refused rather than run on the CPU, and the entry point
trained one epoch on two CPU ranks: equal losses on both ranks, one
checkpoint, written by rank 0. A ``sitecustomize`` on the children's path
records whether JAX was imported: ``--platform cpu`` children import none.
Each launch runs within ``RANK_TIMEOUT_S`` (120 s)."""

import json
import re
import textwrap

import numpy as np
import pytest

from demucs_tpu_torch import launcher
from demucs_tpu_torch.train import distrib

import torch_mp_worker as W

SITECUSTOMIZE = textwrap.dedent('''
    import atexit, os, sys

    def _record():
        folder = os.environ.get("JAX_RECORD_DIR")
        if folder:
            with open(os.path.join(folder, f"{os.getpid()}.txt"), "w") as f:
                f.write(str(sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib", "demucs_tpu"))))

    atexit.register(_record)
''')


@pytest.fixture
def recorded(tmp_path, monkeypatch):
    """Children's imports of JAX, recorded at their exit."""
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(SITECUSTOMIZE)
    (tmp_path / "record").mkdir()
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "site"))
    monkeypatch.setenv("JAX_RECORD_DIR", str(tmp_path / "record"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)

    def imports():
        files = sorted((tmp_path / "record").glob("*.txt"))
        return [f.read_text() for f in files]

    return imports


def test_child_env():
    env = launcher.child_env(1, 4, 12345, "cpu", base={"PATH": "/bin"})
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"]) == ("1", "4", "1")
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("127.0.0.1", "12345")
    assert env[distrib.PLATFORM_ENV] == "cpu" and env[distrib.DEVICE_ENV] == "cpu"
    assert distrib.BACKEND_ENV not in env and env["PATH"] == "/bin"
    env = launcher.child_env(0, 2, 1, "cuda:0", backend="gloo", init_method="file:///r",
                             base={distrib.PLATFORM_ENV: "cpu"})
    assert distrib.PLATFORM_ENV not in env and env[distrib.DEVICE_ENV] == "cuda:0"
    assert env[distrib.BACKEND_ENV] == "gloo" and env[distrib.INIT_METHOD_ENV] == "file:///r"


def test_cuda_device_count_matches_torch():
    import torch

    if not torch.cuda.is_available():
        assert launcher.cuda_device_count() == 0
    else:
        assert launcher.cuda_device_count() == torch.cuda.device_count()


def test_rank_devices():
    assert launcher.rank_devices(3, "cpu") == ["cpu"] * 3
    assert launcher.rank_devices(2, devices=["cpu", "cpu"]) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="2 devices named for 3 ranks"):
        launcher.rank_devices(3, devices=["cpu", "cpu"])


def test_a_missing_card_raises_instead_of_running_on_the_cpu(monkeypatch):
    monkeypatch.setattr(launcher, "_free_port", lambda: pytest.fail("nothing may start"))
    monkeypatch.setattr(launcher, "cuda_device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="nothing falls back to the CPU"):
        launcher.launch("demucs_tpu_torch.distprobe", [], n=2)
    with pytest.raises(RuntimeError, match="cuda:0"):
        launcher.main(["-n", "2", "--devices", "cuda:0,cuda:0", "--backend", "gloo",
                       "--module", "demucs_tpu_torch.distprobe"])


def test_two_rank_probe_imports_no_jax(recorded, capsys):
    rc = launcher.main(["-n", "2", "--platform", "cpu", "--module",
                        "demucs_tpu_torch.distprobe"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for r in range(2):
        assert f"[rank {r}] DISTPROBE_OK {r}/2 device=cpu backend=gloo" in out, out
    assert recorded() == ["[]", "[]"]


def test_failing_rank_code_propagates(tmp_path, monkeypatch):
    """Rank 1 exits 3 while rank 0 waits for it in a barrier: the launcher
    returns 3 and stops rank 0 (well inside rank 0's 1800 s timeout)."""
    import time

    (tmp_path / "failing_rank.py").write_text(textwrap.dedent('''
        import os, sys
        from demucs_tpu_torch.train import distrib
        distrib.init()
        if distrib.rank() == 1:
            sys.exit(3)
        distrib.barrier()
    '''))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    start = time.monotonic()
    assert launcher.launch("failing_rank", [], n=2, platform="cpu") == 3
    assert time.monotonic() - start < W.RANK_TIMEOUT_S


def test_entry_point_trains_an_epoch_on_two_cpu_ranks(recorded, tmp_path, capsys):
    from test_torch_train import _wav_folder

    root = _wav_folder(tmp_path / "wav", seconds=3.0)
    overrides = [f"dset.wav={root}", "dset.use_musdb=false", "dset.segment=0.5",
                 "dset.shift=0.25", "dset.samplerate=8000", f"dset.metadata={tmp_path / 'meta'}",
                 "batch_size=4", "epochs=1", "max_batches=1", "augment.repitch.proba=0",
                 "augment.remix.group_size=2", f"out_dir={tmp_path / 'out'}",
                 "model_args={channels: 8, depth: 2, nfft: 512, t_layers: 2, t_heads: 2}"]
    rc = launcher.main(["-n", "2", "--platform", "cpu", "--"] + overrides)
    out = capsys.readouterr().out
    assert rc == 0, out[-4000:]
    summaries = {r: re.findall(rf"\[rank {r}\] .*Train Summary \| Epoch 1 \| (.*)", out)
                 for r in range(2)}
    assert summaries[0] and summaries[0] == summaries[1], out[-4000:]
    valid = {r: re.findall(rf"\[rank {r}\] .*Valid Summary \| Epoch 1 \| (.*)", out)
             for r in range(2)}
    assert valid[0] and valid[0] == valid[1]
    assert out.count("Checkpoint written: epoch 1") == 1
    assert "[rank 0] " in out.split("Checkpoint written: epoch 1")[0].splitlines()[-1]
    xps = list((tmp_path / "out" / "xps").iterdir())
    history = json.loads((xps[0] / "history.json").read_text())
    assert len(xps) == 1 and len(history) == 1 and np.isfinite(history[0]["train"]["loss"])
    assert (xps[0] / "checkpoint.pkl").is_file()
    assert recorded() == ["[]", "[]"]
