"""The TF and TFLite exports' entry points on the CPU with seeded random
weights (``python -m demucs_tpu_torch.export.tf --random -d cpu --out D``,
``python -m demucs_tpu_torch.export.tflite --random -d cpu --out F``): the
artifacts against the same seeded model's eager core (TF_RTOL = 1e-5 x
peak, tests/test_torch_export_tf.py), and the flatbuffer replayed by
tools/inspect_debug_pack.py's interpreter. Also the flatbuffer of a core
with static sparse attention (the SavedModel's is in
tests/test_torch_export_tf.py)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from demucs_tpu_torch.export import tf as etf
from demucs_tpu_torch.export import tflite as etfl
from demucs_tpu_torch.models import htdemucs as tht

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_export_tf import SPARSE, _cfg, _eager  # noqa: E402 (it puts tools/ on the path)
from test_torch_htdemucs import _port_model, _rel_err, _test_params  # noqa: E402

tf = pytest.importorskip("tensorflow")

TF_RTOL = 1e-5


def test_tf_cli_random(tmp_path):
    """``python -m demucs_tpu_torch.export.tf --random -d cpu``: the default
    config's seeded weights at a short segment; the SavedModel against that
    model's eager core."""
    out = tmp_path / "cli_tf"
    etf.main(["--random", "-d", "cpu", "--segment", "0.25", "--out", str(out)])
    cfg = tht.HTDemucsConfig(segment=0.25)
    model = tht.init_htdemucs(cfg, seed=0).eval()
    mag, mix = etf.sample_inputs(cfg, seed=5)
    got = tf.saved_model.load(str(out)).signatures["serving_default"](
        mag=tf.constant(mag), mix=tf.constant(mix))
    for key, e in zip(("spec_out", "time_out"), _eager(model, mag, mix)):
        assert _rel_err(np.asarray(got[key]), e) <= TF_RTOL
    assert json.loads((out / "meta.json").read_text())["segment"] == 0.25


def test_tflite_cli_random(tmp_path):
    """The TFLite entry point's --random: the JAX tool's reduced config,
    seeded weights; its flatbuffer through the debug-pack replay's
    interpreter against that model's eager core, and its meta."""
    from inspect_debug_pack import run_tflite

    out = tmp_path / "core.tflite"
    etfl.main(["--random", "-d", "cpu", "--out", str(out)])
    cfg = tht.HTDemucsConfig(**etfl.RANDOM_CFG)
    model = tht.init_htdemucs(cfg, seed=0).eval()
    mag, mix = etf.sample_inputs(cfg, seed=6)
    for g, e in zip(run_tflite(out, mag, mix), _eager(model, mag, mix)):
        assert _rel_err(g, e) <= TF_RTOL
    meta = json.loads(out.with_suffix(".meta.json").read_text())
    assert meta["artifact"] == "core.tflite" and meta["samplerate"] == 8000
    assert meta["inputs"] == {"mag": list(mag.shape), "mix": list(mix.shape)}


def test_static_sparse_mask_tflite(tmp_path):
    jcfg = _cfg(**SPARSE)
    model = _port_model(jcfg, _test_params(jcfg, 6))
    _, errs = etfl.export_tflite_core(model, tmp_path / "sparse.tflite",
                                      etf.sample_inputs(model.cfg, seed=3))
    assert max(errs.values()) <= TF_RTOL
