"""The port's test-set evaluation (demucs_tpu_torch.evaluate, train/distrib.py,
run_sdr.py) against demucs_tpu.evaluate.

nsdr and eval_track on the same numpy inputs: the same float64 formulas
(1e-9 dB). evaluate() on a synthetic MusdbHQ folder (2 tracks x 3 s, 16-bit
WAVs written here) with the small HTDemucs of test_torch_apply.py on the
same weights, shifts=0: the separations agree to the forward's fp32 rounding
(1e-5 x peak), so the nsdr within 1e-3 dB. The JAX side is driven as
tests/test_train_smoke.py::test_evaluate_pretrained_flow drives it, with a
TrainArgs shim.
"""

import types

import numpy as np
import pytest

from demucs_tpu import evaluate as jev
from demucs_tpu.train.config import TrainArgs, apply_overrides
from demucs_tpu_torch import evaluate as tev
from demucs_tpu_torch import run_sdr
from demucs_tpu_torch.audio import write_wav
from demucs_tpu_torch.train import distrib

from test_torch_apply import _pair, one_torch_thread  # noqa: F401 (autouse fixture)

SR = 8000
SOURCES = ("drums", "bass", "other", "vocals")


def _stems(seed, seconds=3.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    stems = []
    for i in range(len(SOURCES)):
        tone = 0.2 * np.sin(2 * np.pi * (110 * (i + 1)) * t + i)
        stems.append(np.stack([tone, 0.7 * tone]) + 0.03 * rng.standard_normal((2, t.size)))
    return np.stack(stems).astype(np.float32)


@pytest.fixture(scope="module")
def musdb(tmp_path_factory):
    root = tmp_path_factory.mktemp("musdbhq")
    for i, name in enumerate(("Artist A - One", "Artist B - Two")):
        folder = root / "test" / name
        folder.mkdir(parents=True)
        stems = _stems(i)
        for source, wav in zip(SOURCES, stems):
            write_wav(folder / f"{source}.wav", wav, SR)
        write_wav(folder / "mixture.wav", stems.sum(0), SR)
    return root


def test_new_sdr_and_eval_track_match_jax():
    refs = _stems(3)
    ests = refs + 0.05 * np.random.default_rng(4).standard_normal(refs.shape).astype(np.float32)
    assert np.abs(tev.new_sdr(refs[None], ests[None]) - jev.new_sdr(refs[None], ests[None])
                  ).max() <= 1e-9
    got_bss, got_nsdr = tev.eval_track(refs, ests, SR, SR, flen=64)
    want_bss, want_nsdr = jev.eval_track(refs, ests, SR, SR, flen=64)
    assert np.abs(got_nsdr - want_nsdr).max() <= 1e-9
    for g, w in zip(got_bss, want_bss):
        assert g.shape == w.shape == (4, 3)
        assert np.abs(g - w).max() <= 1e-9
    assert tev.eval_track(refs, ests, SR, SR, compute_sdr=False)[0] is None


def _solver(model, musdb, folder, args):
    return types.SimpleNamespace(args=args, model=model, folder=folder)


def test_evaluate_matches_jax(musdb, tmp_path):
    jm, tm = _pair(7)
    jargs = apply_overrides(TrainArgs(), {"dset.musdb": str(musdb), "test.shifts": 0,
                                          "test.workers": 0, "misc.num_workers": 0})
    want = jev.evaluate(_solver(jm, musdb, tmp_path / "jax", jargs), compute_sdr=False)
    targs = run_sdr.eval_args(musdb, shifts=0, workers=0)
    targs.test.save = True
    got = tev.evaluate(_solver(tm, musdb, tmp_path / "port", targs), compute_sdr=False)
    assert set(got) == set(want)
    assert {"nsdr", "nsdr_med"} | {f"nsdr_{s}" for s in SOURCES} <= set(got)
    for key, value in want.items():
        assert np.isfinite(got[key]) and abs(got[key] - value) <= 1e-3, key
    assert (tmp_path / "port" / "wav" / "Artist A - One" / "vocals.wav").exists()


def test_evaluate_with_bss_eval(musdb, tmp_path):
    """compute_sdr: the BSS-eval metrics of each source (museval is not
    installed here: the port's own bss_eval_images), aggregated as the JAX
    package does; the nsdr as without them."""
    _, tm = _pair(7)
    args = run_sdr.eval_args(musdb, shifts=0, workers=0)
    plain = tev.evaluate(_solver(tm, musdb, tmp_path, args), compute_sdr=False)
    full = tev.evaluate(_solver(tm, musdb, tmp_path, args), compute_sdr=True)
    for metric in ("sdr", "sir", "isr", "sar"):
        assert metric in full and f"{metric}_med" in full
        assert all(f"{metric}_{s}" in full for s in SOURCES)
    assert np.isfinite(full["sdr"]) and full["nsdr"] == plain["nsdr"]


def test_distrib_is_one_rank_without_a_process_group():
    assert distrib.world_size() == 1 and distrib.rank() == 0
    obj = {"track": {"drums": {"nsdr": [1.5]}}}
    assert distrib.share(obj) is obj and distrib.share(obj, 0) is obj
    assert list(distrib.shard_indices(5)) == [0, 1, 2, 3, 4]
    assert list(distrib.shard_indices(0)) == []


def test_run_sdr_verdict(musdb, tmp_path, monkeypatch):
    """The runbook's verdict and gate (a local model stands in for the zoo)."""
    _, tm = _pair(7)
    monkeypatch.setattr("demucs_tpu_torch.zoo.pretrained.get_model",
                        lambda name, repo=None, device="cuda": tm)
    out = tmp_path / "verdict.json"
    argv = ["--musdb", str(musdb), "-n", "tiny", "--nsdr-only", "--shifts", "0",
            "--workers", "0", "-d", "cpu", "--out", str(out)]
    verdict = run_sdr.main(argv + ["--gate", "-100"])
    assert verdict["pass"] and verdict["metric"] == "nsdr" and out.exists()
    assert verdict["value"] == verdict["scores"]["nsdr"]
    with pytest.raises(SystemExit) as exc:
        run_sdr.main(argv + ["--gate", "100"])
    assert exc.value.code == 1
    assert run_sdr.PUBLISHED_SDR["htdemucs_ft"] == 9.00
