"""The port's experiment grids (demucs_tpu_torch.grids) against the JAX
package's (demucs_tpu.grids): every grid resolves to the same entries with
the same XP signatures, and the launcher's ``--run``, ``--status`` and
``--sbatch`` work as ``tests/test_grids.py:75-148`` holds JAX's, with a stub
runner (nothing trains)."""

import json
import shlex

import pytest

from demucs_tpu import grids as jgrids
from demucs_tpu.train import config as jconfig
from demucs_tpu_torch import grids
from demucs_tpu_torch.train.config import (TrainArgs, apply_overrides, parse_cli_overrides,
                                           xp_signature)


def test_the_same_grids():
    assert sorted(grids.GRIDS) == sorted(jgrids.GRIDS)
    assert grids.SBATCH_DEFAULTS["time"] == jgrids.SBATCH_DEFAULTS["time"]


@pytest.mark.parametrize("name", sorted(jgrids.GRIDS))
def test_grid_equals_jax_entry_for_entry(name):
    extra = {"dset.musdb": "/data/musdbhq"}
    want = jgrids.resolve(name, extra)
    got = grids.resolve(name, extra)
    assert got == want
    sigs = [xp_signature(apply_overrides(TrainArgs(), dict(o))) for o in got]
    jsigs = [jconfig.xp_signature(jconfig.apply_overrides(jconfig.TrainArgs(), dict(o)))
             for o in want]
    assert sigs == jsigs and len(set(sigs)) == len(sigs)


def test_run_invokes_the_ports_train(monkeypatch, capsys):
    captured = {}

    def fake_train_main(argv):
        from demucs_tpu_torch.train.config import expand_presets

        captured["overrides"] = expand_presets(parse_cli_overrides(argv))

    import demucs_tpu_torch.train.train as train_mod

    monkeypatch.setattr(train_mod, "main", fake_train_main)
    grids.main(["sdx23", "--run", "1", "dset.musdb=/data/musdb"])
    got = captured["overrides"]
    assert got["dset.use_musdb"] is False
    assert got["dset.wav"] == "<MOISESDB23_LABELNOISE>"
    assert got["dset.musdb"] == "/data/musdb"
    assert "launching grid entry [1]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="out of range"):
        grids.main(["sdx23", "--run", "5"])


def test_run_all_with_jobs_and_failures(capsys):
    launched = []

    def runner(overrides):
        launched.append(dict(overrides))
        return 1 if overrides["dset.wav"] == "<MOISESDB23_BLEEDING>" else 0

    with pytest.raises(SystemExit):
        grids.main(["sdx23", "--run", "all", "--jobs", "2"], runner=runner)
    assert {ov["dset.wav"] for ov in launched} == {"<MOISESDB23_BLEEDING>",
                                                   "<MOISESDB23_LABELNOISE>"}
    captured = capsys.readouterr()
    assert "1/2 ok" in captured.out and "FAILED [0]" in captured.err


def test_subprocess_runner_runs_the_ports_entry_point(monkeypatch):
    calls = []

    class Done:
        returncode = 0

    monkeypatch.setattr("subprocess.run", lambda cmd: calls.append(cmd) or Done())
    assert grids._run_subprocess({"dset.musdb": "/d", "epochs": 2}) == 0
    assert calls[0][1:3] == ["-m", "demucs_tpu_torch.train"]
    assert calls[0][3:] == ['dset.musdb="/d"', "epochs=2"]


def test_status(tmp_path, capsys):
    entries = grids.resolve("sdx23", {"out_dir": str(tmp_path)})
    sig = xp_signature(apply_overrides(TrainArgs(), dict(entries[0])))
    folder = tmp_path / "xps" / sig
    folder.mkdir(parents=True)
    (folder / "history.json").write_text(json.dumps([
        {"train": {"loss": 0.5}, "valid": {"loss": 0.4, "best": 0.4}},
        {"train": {"loss": 0.3}, "valid": {"loss": 0.35, "best": 0.35}}]))
    grids.main(["sdx23", "--status", f"out_dir={tmp_path}"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and sig in out[0]
    assert "epoch 2/320" in out[0] and "train 0.3000" in out[0] and "best 0.3500" in out[0]
    assert "not started" in out[1]


def test_sbatch_runs_the_ports_entry_point_under_srun(tmp_path, capsys):
    grids.main(["mmi", "--sbatch", str(tmp_path), "slurm.partition=gpu",
                "slurm.ntasks-per-node=8", "slurm.gpus-per-node=8",
                "dset.musdb=/data/musdbhq"])
    assert "sbatch" in capsys.readouterr().out
    scripts = sorted(tmp_path.glob("mmi_*.sbatch"))
    grid = grids.resolve("mmi", parse_cli_overrides(["dset.musdb=/data/musdbhq"]))
    assert len(scripts) == len(grid)
    for path, overrides in zip(scripts, grid):
        text = path.read_text()
        sig = xp_signature(apply_overrides(TrainArgs(), dict(overrides)))
        assert f"--job-name=demucs_mmi_{sig}" in text
        for line in ("#SBATCH --partition=gpu", "#SBATCH --ntasks-per-node=8",
                     "#SBATCH --gpus-per-node=8", "#SBATCH --time=4320"):
            assert line in text
        assert path.stat().st_mode & 0o100
        tokens = shlex.split(text.split("srun python -m demucs_tpu_torch.train")[1])
        parsed = parse_cli_overrides([t for t in tokens if "=" in t])
        assert xp_signature(apply_overrides(TrainArgs(), parsed)) == sig
