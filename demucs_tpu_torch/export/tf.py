"""Export of the HTDemucs core as a TensorFlow SavedModel (counterpart of
``tools/export_tf.py``).

The boundary is the core of ``export/core.py``: the complex-as-channels
spectrogram ``mag (1, 2C, nfft/2, frames)`` and the waveform ``mix (1, C,
training_length)`` in, ``(spec_out, time_out)`` out, at the training length.
:func:`lower` walks the ``torch.export`` program of that core
(``export/core.py::export_program``) node by node and emits TensorFlow ops
for each inside a ``tf.function``; K3 (``demucs_tpu_torch::flash_mha``)
becomes the math of ``kernels/attention.py::flash_mha_plain`` with the
keep-mask as ``where(mask, s, -inf)``. A node whose target the lowering does
not cover raises ``NotImplementedError`` naming it.

The SavedModel has the JAX tool's shape: every weight a ``tf.Variable``
named ``name.replace(".", "/")``, the signature ``serving_default(mag,
mix) -> {"spec_out", "time_out"}``, and ``meta.json`` inside the folder.
The graph is device-free: weights and constants go to numpy, whatever
device the model was traced on. ``tensorflow`` is imported inside the
functions, so the package imports without it; the card's machine has none,
so this export runs on the host.

    python -m demucs_tpu_torch.export.tf -n NAME [--repo DIR] --out DIR [--segment S]
    python -m demucs_tpu_torch.export.tf --random --out DIR [--segment S] [-d cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import operator
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch.export import core as ecore
from demucs_tpu_torch.models import htdemucs as ht

__all__ = ["lower", "Lowered", "save_tf_core", "export_tf_core", "sample_inputs",
           "model_from_args", "cli_parser", "main"]

_aten = torch.ops.aten


def _tf():
    import tensorflow as tf

    return tf


def _tf_dtype(dtype: torch.dtype):
    tf = _tf()
    table = {torch.float32: tf.float32, torch.float64: tf.float64, torch.bfloat16: tf.bfloat16,
             torch.float16: tf.float16, torch.int64: tf.int64, torch.int32: tf.int32,
             torch.uint8: tf.uint8, torch.bool: tf.bool}
    if dtype not in table:
        raise NotImplementedError(f"the TF lowering has no dtype for {dtype}")
    return table[dtype]


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bf16 as float32 (numpy has no bf16, the
    variable or constant casts back)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _perm(rank: int, a: int, b: int) -> list:
    p = list(range(rank))
    p[a], p[b] = p[b], p[a]
    return p


def _dim(x, d: int) -> int:
    return d % len(x.shape)


# ---- the ops (NCHW as PyTorch; TF's CPU convolutions take NHWC only) ----

def _conv(x, w, b, stride, padding, dilation, groups, nd: int):
    """conv1d / conv2d: channels to the last axis, explicit zero padding, a
    VALID convolution, channels back."""
    tf = _tf()
    if groups != 1:
        raise NotImplementedError("the TF lowering takes convolutions of one group")
    stride, padding, dilation = ([v] * nd if isinstance(v, int) else list(v)
                                 for v in (stride, padding, dilation))
    if nd == 1:  # as a 2-D convolution of height 1
        x, w = tf.expand_dims(x, 2), tf.expand_dims(w, 2)
        stride, padding, dilation = [1] + stride, [0] + padding, [1] + dilation
    x = tf.transpose(x, [0, 2, 3, 1])
    x = tf.pad(x, [[0, 0], [padding[0]] * 2, [padding[1]] * 2, [0, 0]])
    w = tf.transpose(w, [2, 3, 1, 0])  # (out, in, kh, kw) -> (kh, kw, in, out)
    y = tf.nn.conv2d(x, w, strides=[1, *stride, 1], padding="VALID", dilations=[1, *dilation, 1])
    if b is not None:
        y = y + b
    y = tf.transpose(y, [0, 3, 1, 2])
    return y[:, :, 0] if nd == 1 else y


def _conv_transpose(x, w, b, stride, padding, output_padding, groups, dilation, nd: int):
    """conv_transpose1d / 2d: the full (VALID) transposed convolution, then
    PyTorch's crop of ``padding`` at each end and ``output_padding`` kept
    at the far end."""
    tf = _tf()
    stride, padding, output_padding, dilation = (
        [v] * nd if isinstance(v, int) else list(v)
        for v in (stride, padding, output_padding, dilation))
    if groups != 1 or any(d != 1 for d in dilation):
        raise NotImplementedError("the TF lowering takes transposed convolutions of one group "
                                  "and no dilation")
    if nd == 1:
        x, w = tf.expand_dims(x, 2), tf.expand_dims(w, 2)
        stride, padding, output_padding = [1] + stride, [0] + padding, [0] + output_padding
    n, _, h, wd = x.shape
    k = w.shape[2:]
    full = [(h - 1) * stride[0] + k[0], (wd - 1) * stride[1] + k[1]]
    x = tf.transpose(x, [0, 2, 3, 1])
    filt = tf.transpose(w, [2, 3, 1, 0])  # (in, out, kh, kw) -> (kh, kw, out, in)
    y = tf.nn.conv2d_transpose(x, filt, [n, *full, w.shape[1]], strides=[1, *stride, 1],
                               padding="VALID")
    out = [full[i] - 2 * padding[i] + output_padding[i] for i in range(2)]
    extra = [max(0, padding[i] + out[i] - full[i]) for i in range(2)]
    if any(extra):
        y = tf.pad(y, [[0, 0], [0, extra[0]], [0, extra[1]], [0, 0]])
    y = y[:, padding[0]:padding[0] + out[0], padding[1]:padding[1] + out[1]]
    if b is not None:
        y = y + b
    y = tf.transpose(y, [0, 3, 1, 2])
    return y[:, :, 0] if nd == 1 else y


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv(x, w, b, stride, padding, dilation, groups, 1)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv(x, w, b, stride, padding, dilation, groups, 2)


def conv_transpose1d(x, w, b=None, stride=1, padding=0, output_padding=0, groups=1, dilation=1):
    return _conv_transpose(x, w, b, stride, padding, output_padding, groups, dilation, 1)


def conv_transpose2d(x, w, b=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1):
    return _conv_transpose(x, w, b, stride, padding, output_padding, groups, dilation, 2)


def _moments(x, axes):
    tf = _tf()
    mean = tf.reduce_mean(x, axis=axes, keepdims=True)
    return mean, tf.reduce_mean(tf.square(x - mean), axis=axes, keepdims=True)


def group_norm(x, groups, weight=None, bias=None, eps=1e-5, cudnn_enabled=True):
    tf = _tf()
    shape = tf.shape(x)
    g = tf.reshape(x, [x.shape[0], groups, -1])
    mean, var = _moments(g, [2])
    y = tf.reshape((g - mean) * tf.math.rsqrt(var + eps), shape)
    affine = [x.shape[1]] + [1] * (len(x.shape) - 2)
    if weight is not None:
        y = y * tf.reshape(weight, affine)
    if bias is not None:
        y = y + tf.reshape(bias, affine)
    return y


def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5, cudnn_enable=True):
    tf = _tf()
    axes = list(range(len(x.shape) - len(normalized_shape), len(x.shape)))
    mean, var = _moments(x, axes)
    y = (x - mean) * tf.math.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def mean_dim(x, dims, keepdim=False):
    return _tf().reduce_mean(x, axis=list(dims), keepdims=keepdim)


def var_mean_correction(x, dims=None, correction=1, keepdim=False):
    """``(var, mean)`` over ``dims`` with ``correction`` (1: unbiased)."""
    tf = _tf()
    dims = list(range(len(x.shape))) if dims is None else [_dim(x, d) for d in dims]
    n = math.prod(x.shape[d] for d in dims)
    mean = tf.reduce_mean(x, axis=dims, keepdims=True)
    var = tf.reduce_sum(tf.square(x - mean), axis=dims, keepdims=keepdim) / (n - correction)
    return var, mean if keepdim else tf.squeeze(mean, dims)


def std_correction(x, dims=None, correction=1, keepdim=False):
    return _tf().sqrt(var_mean_correction(x, dims, correction, keepdim)[0])


def linear(x, w, b=None):
    """``x @ w.T + b`` as one 2-D product over the flattened leading axes."""
    tf = _tf()
    lead = tf.shape(x)[:-1]
    y = tf.matmul(tf.reshape(x, [-1, x.shape[-1]]), w, transpose_b=True)
    if b is not None:
        y = y + b
    return tf.reshape(y, tf.concat([lead, [w.shape[0]]], axis=0))


def gelu(x, approximate="none"):
    return _tf().nn.gelu(x, approximate=approximate == "tanh")


def glu(x, dim=-1):
    a, b = _tf().split(x, 2, axis=_dim(x, dim))
    return a * _tf().sigmoid(b)


def chunk(x, chunks, dim=0):
    """PyTorch's chunks: each ``ceil(size / chunks)`` long, the last shorter."""
    size = x.shape[_dim(x, dim)]
    step = -(-size // chunks)
    sizes = [step] * (size // step) + ([size % step] if size % step else [])
    return _tf().split(x, sizes, axis=_dim(x, dim))


def pad(x, pad, mode="constant", value=None):
    """``F.pad``'s constant padding (``pad``: last axis first, (left, right)
    pairs, none negative)."""
    if mode != "constant" or min(pad) < 0:
        raise NotImplementedError(f"the TF lowering takes constant padding of no negative "
                                  f"width, got {mode!r} {list(pad)}")
    pairs = [[0, 0] for _ in x.shape]
    for i in range(len(pad) // 2):
        pairs[len(x.shape) - 1 - i] = [pad[2 * i], pad[2 * i + 1]]
    return _tf().pad(x, pairs, constant_values=0.0 if value is None else value)


def slice_tensor(x, dim=0, start=None, end=None, step=1):
    """PyTorch's slice: ``start``/``end`` clamped to the axis, negatives from
    its end."""
    d = _dim(x, dim)
    size = x.shape[d]
    lo, hi, _ = slice(start, end, step).indices(size)
    index = [slice(None)] * len(x.shape)
    index[d] = slice(lo, hi, step)
    return x[tuple(index)]


def arange(end, dtype=None, layout=None, device=None, pin_memory=None):
    """``torch.arange(end)``: int64 unless ``dtype`` says otherwise."""
    return _tf().range(end, dtype=_tf_dtype(dtype or torch.int64))


def flash_mha(q, k, v, num_heads, mask=None):
    """K3's function as ``kernels/attention.py::flash_mha_plain`` computes it:
    per head, ``softmax(q k^T / sqrt(d))`` with masked scores at -inf, times
    v; q, k, v ``(B, T, H d)``, ``mask (Tq, Tk)`` nonzero where kept."""
    tf = _tf()
    B, Tq, C = q.shape
    d = C // num_heads

    def heads(t):
        return tf.transpose(tf.reshape(t, [B, t.shape[1], num_heads, d]), [0, 2, 1, 3])

    scale = 1.0 / math.sqrt(d)
    if q.dtype != tf.float32:  # the plain version's scale in the inputs' type
        scale = float(torch.tensor(scale, dtype=torch.bfloat16))
    qh, kh, vh = heads(q) * tf.cast(scale, q.dtype), heads(k), heads(v)
    scores = tf.matmul(tf.cast(qh, tf.float32), tf.cast(kh, tf.float32), transpose_b=True)
    if mask is not None:
        keep = tf.not_equal(tf.cast(mask, tf.int32), 0)
        scores = tf.where(keep, scores, tf.constant(-np.inf, tf.float32))
    weights = tf.cast(tf.nn.softmax(scores, axis=-1), vh.dtype)
    out = tf.cast(tf.matmul(tf.cast(weights, tf.float32), tf.cast(vh, tf.float32)), q.dtype)
    return tf.reshape(tf.transpose(out, [0, 2, 1, 3]), [B, Tq, C])


def _to_dtype(x, dtype, non_blocking=False, copy=False, memory_format=None):
    return _tf().cast(x, _tf_dtype(dtype))


_OPS: tp.Dict[tp.Any, tp.Callable] = {
    operator.getitem: operator.getitem,
    _aten._assert_tensor_metadata.default: lambda *a, **k: None,
    _aten.add.Tensor: operator.add,
    _aten.sub.Tensor: operator.sub,
    _aten.mul.Tensor: operator.mul,
    _aten.div.Tensor: operator.truediv,
    _aten.to.dtype: _to_dtype,
    _aten.arange.default: arange,
    _aten.chunk.default: chunk,
    _aten.conv1d.default: conv1d,
    _aten.conv2d.default: conv2d,
    _aten.conv_transpose1d.default: conv_transpose1d,
    _aten.conv_transpose2d.input: conv_transpose2d,
    _aten.group_norm.default: group_norm,
    _aten.layer_norm.default: layer_norm,
    _aten.mean.dim: mean_dim,
    _aten.std.correction: std_correction,
    _aten.var_mean.correction: var_mean_correction,
    _aten.neg.default: lambda x: -x,
    _aten.exp.default: lambda x: _tf().exp(x),
    _aten.rsqrt.default: lambda x: _tf().math.rsqrt(x),
    _aten.reciprocal.default: lambda x: _tf().math.reciprocal(x),
    _aten.special_erfc.default: lambda x: _tf().math.erfc(x),
    _aten.linear.default: linear,
    _aten.gelu.default: gelu,
    _aten.glu.default: glu,
    _aten.embedding.default: lambda w, idx, *a: _tf().gather(w, idx),
    _aten.pad.default: pad,
    _aten.permute.default: lambda x, dims: _tf().transpose(x, list(dims)),
    _aten.transpose.int: lambda x, a, b: _tf().transpose(
        x, _perm(len(x.shape), _dim(x, a), _dim(x, b))),
    _aten.t.default: lambda x: _tf().transpose(x),
    _aten.reshape.default: lambda x, shape: _tf().reshape(x, list(shape)),
    _aten.unsqueeze.default: lambda x, dim: _tf().expand_dims(x, dim),
    _aten.slice.Tensor: slice_tensor,
    torch.ops.demucs_tpu_torch.flash_mha.default: flash_mha,  # K3, registered by export.core
}


class Lowered:
    """The TF function of an exported core: ``lowered(variables, mag, mix) ->
    (spec_out, time_out)``, ``variables`` a ``{dotted name: tf.Variable}`` of
    :attr:`weights` (numpy, the program's parameters and buffers), the
    program's constant tables held as TF constants."""

    def __init__(self, program: torch.export.ExportedProgram):
        from torch.export.graph_signature import InputKind

        self.graph = program.graph
        self.weights: tp.Dict[str, np.ndarray] = {}
        self.dtypes: tp.Dict[str, torch.dtype] = {}
        self._inputs: tp.List[tp.Tuple[str, str, tp.Any]] = []  # (node, kind, key)
        state = program.state_dict
        users = 0
        for spec in program.graph_signature.input_specs:
            name = spec.arg.name
            if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
                self.weights[spec.target] = _numpy(state[spec.target])
                self.dtypes[spec.target] = state[spec.target].dtype
                self._inputs.append((name, "weight", spec.target))
            elif spec.kind == InputKind.CONSTANT_TENSOR:
                self._inputs.append((name, "constant", program.constants[spec.target]))
            elif spec.kind == InputKind.USER_INPUT:
                self._inputs.append((name, "user", users))
                users += 1
            else:
                raise NotImplementedError(f"the TF lowering takes no {spec.kind} input")
        for node in self.graph.nodes:
            if node.op == "call_function" and node.target not in _OPS:
                raise NotImplementedError(f"the TF lowering does not cover {node.target}")

    def variable_dtype(self, name: str):
        return _tf_dtype(self.dtypes[name])

    def __call__(self, variables: tp.Mapping[str, tp.Any], *user):
        tf = _tf()
        env: tp.Dict[str, tp.Any] = {}
        for node, kind, key in self._inputs:
            if kind == "weight":
                env[node] = variables[key]
            elif kind == "constant":
                env[node] = tf.constant(_numpy(key), dtype=_tf_dtype(key.dtype))
            else:
                env[node] = user[key]

        def value(a):
            if isinstance(a, torch.fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(value(x) for x in a)
            return a

        for node in self.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "output":
                return tuple(value(node.args[0]))
            env[node.name] = _OPS[node.target](*value(node.args),
                                               **{k: value(v) for k, v in node.kwargs.items()})
        raise ValueError("the program has no output node")


def lower(model, device=None) -> Lowered:
    """The TF lowering of ``model``'s core (a ``Model`` or an ``HTDemucs`` in
    eval mode; ``export/core.py::export_program`` on ``device``)."""
    return Lowered(ecore.export_program(model, device))


def sample_inputs(cfg: ht.HTDemucsConfig, seed: int = 0) -> tp.Tuple[np.ndarray, np.ndarray]:
    """A seeded ``(mag, mix)`` pair of the core's shapes: 0.1 x a normal
    draw as ``mix``, its spectrogram packed as ``mag`` (the port's STFT on
    the CPU)."""
    from demucs_tpu_torch.ops.spec import cac_pack, demucs_spec

    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((1, cfg.audio_channels, cfg.training_length)) * 0.1
           ).astype(np.float32)
    mag = cac_pack(demucs_spec(torch.from_numpy(mix), cfg.nfft)).numpy()
    return mag, mix


def save_tf_core(model, out: tp.Union[str, Path], device=None) -> None:
    """Lower ``model``'s core and save it as a SavedModel at ``out``, with
    ``meta.json`` inside (the JAX tool's keys)."""
    tf = _tf()
    cfg = getattr(model, "module", model).cfg
    if not cfg.cac:
        raise ValueError("the TF core export takes the complex-as-channels HTDemucs (cac=True)")
    lowered = lower(model, device)
    mag_shape, mix_shape = ecore.core_shapes(cfg)
    tf_vars = {k: tf.Variable(tf.cast(v, lowered.variable_dtype(k)), name=k.replace(".", "/"))
               for k, v in lowered.weights.items()}
    module = tf.Module()
    module._vars = tf_vars

    @tf.function(autograph=False, input_signature=[
        tf.TensorSpec(mag_shape, tf.float32, name="mag"),
        tf.TensorSpec(mix_shape, tf.float32, name="mix")])
    def serve(mag, mix):
        spec_out, time_out = lowered(module._vars, mag, mix)
        return {"spec_out": spec_out, "time_out": time_out}

    module.serve = serve
    out = Path(out)
    tf.saved_model.save(module, str(out), signatures={"serving_default": serve})
    meta = {
        "samplerate": cfg.samplerate,
        "channels": cfg.audio_channels,
        "nfft": cfg.nfft,
        "cac": True,
        "segment": float(cfg.segment),
        "sources": list(cfg.sources),
        "inputs": {"mag": list(mag_shape), "mix": list(mix_shape)},
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1))


def export_tf_core(model, out: tp.Union[str, Path], inputs=None, device=None):
    """:func:`save_tf_core`, then the SavedModel reloaded and ``inputs``
    (``(mag, mix)`` numpy; default zeros) run through ``serving_default``.
    Returns its ``(spec_out, time_out)`` as numpy."""
    tf = _tf()
    save_tf_core(model, out, device)
    if inputs is None:
        inputs = tuple(np.zeros(s, np.float32)
                       for s in ecore.core_shapes(getattr(model, "module", model).cfg))
    reloaded = tf.saved_model.load(str(out))
    got = reloaded.signatures["serving_default"](
        mag=tf.constant(np.asarray(inputs[0], np.float32)),
        mix=tf.constant(np.asarray(inputs[1], np.float32)))
    return np.asarray(got["spec_out"]), np.asarray(got["time_out"])


def model_from_args(args, random_cfg: tp.Optional[dict] = None):
    """The CLI's model: seeded random weights (``--random``: the config's
    defaults, or ``random_cfg``) or ``-n NAME`` from ``--repo``, on ``-d``'s
    device, in eval mode, at ``--segment``."""
    from demucs_tpu_torch import resolve_device
    from demucs_tpu_torch.models.registry import BagOfModels, Model, reconfigured

    device = resolve_device(args.device)
    if args.random:
        kw = dict(random_cfg or {})
        kw["segment"] = args.segment or kw.get("segment", 7.8)
        cfg = ht.HTDemucsConfig(**kw)
        return Model("htdemucs", cfg, ht.init_htdemucs(cfg, seed=0).eval().to(device))
    from demucs_tpu_torch.zoo.pretrained import get_model

    model = get_model(args.name, repo=args.repo, device=device)
    if isinstance(model, BagOfModels):
        model = model.models[0]
    if model.kind != "htdemucs":
        raise ValueError(f"the core export takes an HTDemucs, {args.name} is {model.kind}")
    return reconfigured(model, segment=args.segment) if args.segment else model


def cli_parser(description: str, default_out: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-n", "--name", default="htdemucs")
    parser.add_argument("--repo", type=Path, default=None)
    parser.add_argument("--random", action="store_true",
                        help="seeded random weights at the config's defaults (no zoo needed)")
    parser.add_argument("--out", type=Path, default=Path(default_out))
    parser.add_argument("--segment", type=float, default=None)
    parser.add_argument("-d", "--device", default="cuda",
                        help="where the model is traced: cuda (default) or cpu")
    return parser


def main(argv=None) -> None:
    args = cli_parser("Export the HTDemucs core as a TensorFlow SavedModel",
                      "htdemucs_tf").parse_args(argv)
    model = model_from_args(args)
    start = time.perf_counter()
    spec_out, time_out = export_tf_core(model, args.out)
    size = sum(f.stat().st_size for f in args.out.rglob("*") if f.is_file())
    print(f"exported TF SavedModel: {args.out} ({size / 2**20:.1f} MB, "
          f"{time.perf_counter() - start:.1f} s)")
    print(f"  spec_out {spec_out.shape}, time_out {time_out.shape}")


if __name__ == "__main__":
    main()
