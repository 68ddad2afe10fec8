"""The port's TFLite flatbuffer of the HTDemucs core
(demucs_tpu_torch/export/tflite.py) against its eager core and the JAX
package's tools/export_tflite.py, on the CPU at the small config of
tests/common.py (the JAX tool's own --random config) with unit LayerScales
and random norms; replayed through tools/inspect_debug_pack.py as the web
shell's debug packs are.

Tolerances: the interpreter against the port's eager ``forward_core``
TF_RTOL = 1e-5 x peak (TFLite's fp32 kernels summing in their own order),
against JAX's flatbuffer JAX_RTOL = 2e-4 x peak
(tests/test_torch_export.py's bound).
"""

import base64
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from demucs_tpu_torch.export import tf as etf
from demucs_tpu_torch.export import tflite as etfl

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_export_tf import _cfg  # noqa: E402 (it puts tools/ on the path)
from test_torch_htdemucs import _port_model, _rel_err, _test_params  # noqa: E402

pytest.importorskip("tensorflow")

TF_RTOL = 1e-5
JAX_RTOL = 2e-4


@pytest.fixture(scope="module")
def flatbuffers(tmp_path_factory):
    """Each side's flatbuffer of the same weights, and what each
    interpreter gave on the same seeded inputs."""
    from export_tflite import export_tflite_core as jax_export_tflite_core

    jcfg = _cfg()
    params = _test_params(jcfg, 5)
    model = _port_model(jcfg, params)
    inputs = etf.sample_inputs(model.cfg, seed=2)
    folder = tmp_path_factory.mktemp("tflite")
    (folder / "port").mkdir()
    (folder / "jax").mkdir()
    got, errs = etfl.export_tflite_core(model, folder / "port" / "core.tflite", inputs)
    want, _ = jax_export_tflite_core(params, jcfg, folder / "jax" / "core.tflite",
                                     sample_inputs=inputs)
    return jcfg, model, inputs, folder, got, errs, want


def test_tflite_matches_eager_and_jax(flatbuffers):
    _, _, _, _, got, errs, want = flatbuffers
    assert max(errs.values()) <= TF_RTOL
    by_shape = {w.shape: w for w in want.values()}
    for g in got:
        assert _rel_err(g, by_shape[g.shape]) < JAX_RTOL


def test_tflite_meta_holds_jax_keys(flatbuffers):
    """``<out>.meta.json`` holds the JAX tool's keys with its values, plus
    the precision, the compute dtype and the format."""
    *_, folder, _, _, _ = flatbuffers
    port, jax_ = (json.loads((folder / side / "core.meta.json").read_text())
                  for side in ("port", "jax"))
    assert {k: port[k] for k in jax_} == jax_
    assert set(port) - set(jax_) == {"matmul_precision", "compute_dtype", "format"}
    assert port["format"] == "tflite" and port["compute_dtype"] == "float32"


def test_debug_pack_replay(flatbuffers, tmp_path):
    """A browser debug pack made from the port's flatbuffer (the JSON schema
    web/index.html ?debug=1 downloads) replays through
    tools/inspect_debug_pack.py: rc 0."""
    from inspect_debug_pack import main as inspect_main

    jcfg, _, _, folder, _, _, _ = flatbuffers
    flatbuffer = folder / "port" / "core.tflite"
    mag, mix = etf.sample_inputs(_port_model(jcfg, _test_params(jcfg, 5)).cfg, seed=9)
    spec, time_out = etfl.run_interpreter(flatbuffer.read_bytes(), mag, mix)

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()

    F, T = mag.shape[-2:]
    pack = {"meta": {"nfft": jcfg.nfft, "seg": jcfg.training_length, "C": 2, "S": 4, "F": F,
                     "T": T, "off": 0, "chunkLen": jcfg.training_length},
            "mag": b64(mag), "mix": b64(mix), "spec_out": b64(spec), "time_out": b64(time_out)}
    path = tmp_path / "debug_pack.json"
    path.write_text(json.dumps(pack))
    assert inspect_main(["--pack", str(path), "--tflite", str(flatbuffer), "--tol", "1e-5"]) == 0


@pytest.mark.parametrize("stages", [dict(bf16_stages=("transformer",)),
                                    dict(compute_dtype="bfloat16")])
def test_bf16_stages_refused(stages, tmp_path):
    """TFLite's converter cannot legalise a bf16 core (the JAX tool fails
    on one too): the port refuses it by name before converting."""
    jcfg = _cfg(**stages)
    model = _port_model(jcfg, _test_params(jcfg, 7))
    with pytest.raises(ValueError, match="refuses bf16 stages"):
        etfl.export_tflite_core(model, tmp_path / "bf16.tflite")
    assert not (tmp_path / "bf16.tflite").exists()
