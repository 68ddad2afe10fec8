"""The port's TensorFlow SavedModel of the HTDemucs core
(demucs_tpu_torch/export/tf.py) against its eager core and the JAX
package's tools/export_tf.py, on the CPU at the small config of
tests/common.py with unit LayerScales and random norms (every branch
counts).

Tolerances: against the port's eager ``forward_core`` TF_RTOL = 1e-5 x peak
(the same function, TF's fp32 kernels summing in their own order); against
JAX's SavedModel and ``forward_core`` JAX_RTOL = 2e-4
x peak (tests/test_torch_export.py's bound). The bf16 stages are in
tests/test_torch_export_tf_bf16.py, the CLIs in tests/test_torch_export_cli.py.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import htdemucs as jht
from demucs_tpu_torch.export import tf as etf

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(REPO / "tools"))
from common import SOURCES, small_htdemucs_kwargs  # noqa: E402
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_htdemucs import _port_model, _rel_err, _test_params  # noqa: E402

tf = pytest.importorskip("tensorflow")

TF_RTOL = 1e-5
JAX_RTOL = 2e-4
SPARSE = dict(t_sparse_self_attn=True, t_sparse_cross_attn=True, t_sparse_attn_window=2,
              t_global_window=1)


def _cfg(**extra) -> jht.HTDemucsConfig:
    return jht.HTDemucsConfig(sources=tuple(SOURCES), **dict(small_htdemucs_kwargs(), **extra))


def _eager(model, mag, mix) -> list:
    with torch.inference_mode():
        return [t.float().numpy() for t in model.forward_core(torch.from_numpy(mag),
                                                               torch.from_numpy(mix))]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """JAX params, the port's model on them, each side's SavedModel of the
    core and what each gave on the same seeded inputs."""
    from export_tf import export_tf_core as jax_export_tf_core

    jcfg = _cfg()
    params = _test_params(jcfg, 5)
    model = _port_model(jcfg, params)
    inputs = etf.sample_inputs(model.cfg, seed=2)
    folder = tmp_path_factory.mktemp("tf")
    got = etf.export_tf_core(model, folder / "port", inputs)
    want = jax_export_tf_core(params, jcfg, folder / "jax", sample_inputs=inputs)
    return jcfg, params, model, inputs, folder, got, want


def test_saved_model_matches_eager_and_jax(saved):
    jcfg, params, model, (mag, mix), _, got, want = saved
    jax_core = jax.jit(jht.forward_core, static_argnames=("cfg",))(
        params, jnp.asarray(mag), jnp.asarray(mix), jcfg)
    for g, e, w, j in zip(got, _eager(model, mag, mix), want, jax_core):
        assert _rel_err(g, e) <= TF_RTOL
        assert _rel_err(g, w) < JAX_RTOL
        assert _rel_err(g, np.asarray(j)) < JAX_RTOL


def test_saved_model_names_signature_and_meta_equal_jax(saved):
    """The variables' names, the serving signature's inputs and outputs, and
    meta.json are the JAX tool's."""
    *_, folder, _, _ = saved
    port, jax_ = (tf.saved_model.load(str(folder / side)) for side in ("port", "jax"))
    names = [{k: v.name for k, v in m._vars.items()} for m in (port, jax_)]
    assert names[0] == names[1]
    assert all(v == k.replace(".", "/") + ":0" for k, v in names[0].items())
    sigs = [m.signatures["serving_default"] for m in (port, jax_)]
    assert sigs[0].structured_input_signature == sigs[1].structured_input_signature
    assert sigs[0].structured_outputs.keys() == sigs[1].structured_outputs.keys() == {
        "spec_out", "time_out"}
    for key in ("spec_out", "time_out"):
        assert sigs[0].structured_outputs[key].shape == sigs[1].structured_outputs[key].shape
    metas = [json.loads((folder / side / "meta.json").read_text()) for side in ("port", "jax")]
    assert metas[0] == metas[1]


def test_static_sparse_mask_saved_model(tmp_path):
    """Static sparse attention: the mask a constant of the graph, the scores
    it drops at -inf; against the eager core and JAX's forward_core."""
    jcfg = _cfg(**SPARSE)
    params = _test_params(jcfg, 6)
    model = _port_model(jcfg, params)
    mag, mix = etf.sample_inputs(model.cfg, seed=3)
    got = etf.export_tf_core(model, tmp_path / "sparse", (mag, mix))
    want = jax.jit(jht.forward_core, static_argnames=("cfg",))(
        params, jnp.asarray(mag), jnp.asarray(mix), jcfg)
    for g, e, w in zip(got, _eager(model, mag, mix), want):
        assert _rel_err(g, e) <= TF_RTOL
        assert _rel_err(g, np.asarray(w)) < JAX_RTOL


def test_uncovered_node_refused_by_name():
    class Odd(torch.nn.Module):
        def forward(self, x):
            return torch.sin(x) + 1

    program = torch.export.export(Odd(), (torch.zeros(3),))
    with pytest.raises(NotImplementedError, match="aten.sin.default"):
        etf.Lowered(program)


def test_lowered_ops_match_torch():
    """The transposed convolutions' crops and output padding, a strided,
    padded and dilated convolution, uneven chunks and PyTorch's slice
    bounds, each against torch on the same values; what the lowering does
    not take raises."""
    g = torch.Generator().manual_seed(0)
    x1, x2 = torch.randn(2, 6, 17, generator=g), torch.randn(2, 6, 9, 11, generator=g)
    w1, w2 = torch.randn(6, 4, 5, generator=g), torch.randn(6, 4, 3, 4, generator=g)
    b = torch.randn(4, generator=g)
    t = [tf.constant(a.numpy()) for a in (x1, x2, w1, w2, b)]
    F = torch.nn.functional
    cases = [
        (etf.conv_transpose1d(t[0], t[2], t[4], 3, 2, 1), F.conv_transpose1d(x1, w1, b, 3, 2, 1)),
        (etf.conv_transpose2d(t[1], t[3], None, (2, 3), (1, 0), (1, 2)),
         F.conv_transpose2d(x2, w2, None, (2, 3), (1, 0), (1, 2))),
        (etf.conv1d(t[0], tf.transpose(t[2], [1, 0, 2]), None, 2, 3, 2),
         F.conv1d(x1, w1.permute(1, 0, 2), None, 2, 3, 2)),
        (etf.pad(t[0], [1, 3]), F.pad(x1, [1, 3])),
    ]
    for got, want in cases:
        np.testing.assert_allclose(np.asarray(got), want.numpy(), atol=1e-5, rtol=1e-5)
    for got, want in zip(etf.chunk(t[0], 3, -1), torch.chunk(x1, 3, -1)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    np.testing.assert_array_equal(np.asarray(etf.slice_tensor(t[0], 2, 2, 2 ** 63 - 1)),
                                  x1[..., 2:].numpy())
    np.testing.assert_array_equal(np.asarray(etf.slice_tensor(t[0], -1, 2, -2)),
                                  x1[..., 2:-2].numpy())
    with pytest.raises(NotImplementedError, match="one group"):
        etf.conv1d(t[0], t[2][:, :3], None, 1, 0, 1, 2)
    with pytest.raises(NotImplementedError, match="reflect"):
        etf.pad(t[0], [1, 1], "reflect")


def test_package_imports_without_tensorflow():
    """tensorflow is imported inside the export functions only: with it
    hidden the package and both export modules import, and an export says
    what it needs."""
    code = ("import sys; sys.modules['tensorflow'] = None\n"
            "import demucs_tpu_torch, demucs_tpu_torch.export.tf as t, "
            "demucs_tpu_torch.export.tflite, demucs_tpu_torch.automix\n"
            "try:\n    t._tf()\nexcept ImportError as e:\n    print('REFUSED', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "REFUSED" in out.stdout and "tensorflow" in out.stdout
