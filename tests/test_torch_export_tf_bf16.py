"""The port's TensorFlow SavedModel of an HTDemucs core with bf16 stages
(demucs_tpu_torch/export/tf.py) against its eager bf16 core and the JAX
package's tools/export_tf.py, which exports bf16 stages too (its TFLite
tool does not: tests/test_torch_export_tflite.py).

Tolerance: BF16_RTOL = 2**-6 x peak against the port's eager bf16 core and
against JAX's bf16 SavedModel, a few bf16 steps of the output: TF's bf16
ops round in their own places.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from demucs_tpu_torch.export import tf as etf

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_export_tf import _cfg, _eager  # noqa: E402 (it puts tools/ on the path)
from test_torch_htdemucs import _port_model, _rel_err, _test_params  # noqa: E402

tf = pytest.importorskip("tensorflow")

BF16_RTOL = 2.0 ** -6


@pytest.mark.parametrize("stages", [dict(bf16_stages=("transformer",)),
                                    dict(compute_dtype="bfloat16")],
                         ids=["transformer", "every_stage"])
def test_bf16_stages_saved_model(stages, tmp_path):
    """The JAX tool exports bf16 stages, so the port does: the variables of
    a bf16 stage in bf16, the outputs float32, within BF16_RTOL of the eager
    bf16 core and (every stage) of JAX's bf16 SavedModel."""
    jcfg = _cfg(**stages)
    params = _test_params(jcfg, 7)
    model = _port_model(jcfg, params)
    inputs = etf.sample_inputs(model.cfg, seed=4)
    got = etf.export_tf_core(model, tmp_path / "port", inputs)
    assert all(g.dtype == np.float32 for g in got)
    loaded = tf.saved_model.load(str(tmp_path / "port"))
    dtypes = {k: v.dtype for k, v in loaded._vars.items()}
    assert dtypes["crosstransformer.layers.0.linear1.weight"] == tf.bfloat16
    assert dtypes["encoder.0.conv.weight"] == (
        tf.bfloat16 if "compute_dtype" in stages else tf.float32)
    for g, e in zip(got, _eager(model, *inputs)):
        assert _rel_err(g, e) <= BF16_RTOL
    if "compute_dtype" in stages:
        from export_tf import export_tf_core as jax_export_tf_core

        want = jax_export_tf_core(params, jcfg, tmp_path / "jax", sample_inputs=inputs)
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= BF16_RTOL
