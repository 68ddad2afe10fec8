"""K3 at any head dim up to 128 (demucs_tpu_torch.kernels.attention): the
kernels' instances are 32, 48, 64 and 128, and a head between them runs on
the next one up, q, k and v padded with zero channels, the softmax scale the
true head dim's, the output cropped. Here, on the CPU, that path's plain
version (``flash_mha_padded_plain``) and the wrappers' own pad, crop and
autograd node with the plain versions in the kernels' place, against JAX's
``flash_mha`` (the Pallas kernel, interpret mode) and ``multihead_attention``
and its autodiff, gradients and dropout up to head dim 128 included;
HTDemucs at head dims 128 and 16 against JAX's; the refusal of head dims
past 128, which no instance computes.

Tolerances: forwards atol 2e-5, rtol 1e-4 (tests/test_torch_attention.py:
fp32 softmax and products summed in another order); gradients 1e-4 x each
gradient's peak (tests/test_torch_attention_train.py); HTDemucs 2e-4 x the
output's peak (tests/test_golden.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import htdemucs as jht
from demucs_tpu.ops.attention import multihead_attention as jax_mha
from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu_torch.kernels import _build
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.models import transformer as ttr

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_htdemucs import (RELEASED, RTOL, SOURCES, _forward, _golden_cfg, _jax_forward,
                                 _port_model, _rel_err, _test_params)

TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_RTOL = 1e-4
DIMS = (8, 16, 24, 40, 56, 96, 128)
SHAPES = {"self": (2, 150, 150), "cross": (1, 70, 150),  # (B, Tq, Tk), ragged
          "one query": (3, 1, 70)}
H = 2


def _inputs(d, shape, masked, seed=0):
    B, Tq, Tk = SHAPES[shape]
    rng = np.random.default_rng(seed + d)
    q, k, v = (rng.standard_normal((B, T, H * d)).astype(np.float32) for T in (Tq, Tk, Tk))
    mask = None
    if masked:
        mask = rng.random((Tq, Tk)) > 0.5
        mask[:, 0] = True  # every row keeps a key
        mask[:, 64:96] = False  # a masked band across tiles
    return q, k, v, mask


def _jax(q, k, v, mask):
    jm = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H)
    dense = np.asarray(jax_mha(*args, mask=jm))
    flash = np.asarray(jax_flash_mha(*args, mask=jm, block_q=128, block_k=128, interpret=True))
    return dense, flash


def test_instance_dims():
    """Each head dim up to 128 runs on the smallest instance at least as wide."""
    assert K.HEAD_DIMS == (32, 48, 64, 128) and K.TRAIN_HEAD_DIM == 128
    for d in range(1, 129):
        D = K.instance_dim(d)
        assert D in K.HEAD_DIMS and D >= d
        assert all(E < d for E in K.HEAD_DIMS if E < D)


@pytest.mark.parametrize("d", [1, 16, 40, 96, 128])
def test_pad_and_crop_heads(d):
    """Each head's channels, then zeros to the instance's width; the crop
    gives them back."""
    x = torch.arange(2 * 3 * H * d, dtype=torch.float32).reshape(2, 3, H * d)
    D = K.instance_dim(d)
    padded = K.pad_heads(x, H, D)
    assert padded.shape == (2, 3, H * D) and padded.is_contiguous()
    heads = padded.view(2, 3, H, D)
    torch.testing.assert_close(heads[..., :d], x.view(2, 3, H, d), rtol=0, atol=0)
    assert not heads[..., d:].any()
    torch.testing.assert_close(K.crop_heads(padded, H, d), x, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", DIMS)
def test_padded_plain_matches_jax(d, shape, masked):
    """The padded path's plain version against JAX's dense attention and the
    Pallas kernel at the same head dim: zero channels leave every score as it
    was, the scale is the true head dim's."""
    q, k, v, mask = _inputs(d, shape, masked)
    dense, flash = _jax(q, k, v, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    got = K.flash_mha_padded_plain(*(torch.from_numpy(a) for a in (q, k, v)), H, mask=tm).numpy()
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


def _cpu_launches(monkeypatch, mask):
    """The wrappers' own path on CPU tensors, the kernels' launches replaced
    by the plain attention at the instance's head dim (each launch checked
    to be at one) with the scale of ``head_dim``; records the launches."""
    launched = []

    def checked(q, k, v, num_heads, m, dtype):
        d = q.shape[-1] // num_heads
        K.instance_dim(d)
        return q.shape[0], q.shape[1], k.shape[1], d, None if m is None else m.to(torch.uint8)

    def route(q, k, v, num_heads, tiles, rate, seed, want_lse, head_dim=None):
        D = q.shape[-1] // num_heads
        assert D in K.HEAD_DIMS and (head_dim is None or head_dim <= D)
        assert (tiles is None) == (mask is None)
        launched.append((D, head_dim))
        out = K.flash_mha_plain(q, k, v, num_heads, mask=mask, head_dim=head_dim, dropout=rate,
                                dropout_seed=seed)
        return out, torch.zeros(q.shape[0] * num_heads, q.shape[1])

    monkeypatch.setattr(K, "_checked", checked)
    monkeypatch.setattr(K, "_forward_f32", route)
    monkeypatch.setattr(K, "_forward_bf16", route)
    return launched


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_registered_op_pads_to_the_instance(monkeypatch, d, masked):
    """The registered op's CUDA kernel (what the exported core runs) pads to
    the instance, launches there with the true head dim's scale, and crops."""
    q, k, v, mask = _inputs(d, "cross", masked, seed=1)
    tm = None if mask is None else torch.from_numpy(mask)
    launched = _cpu_launches(monkeypatch, tm)
    dense, _ = _jax(q, k, v, mask)
    got = K._flash_mha_op_cuda(*(torch.from_numpy(a) for a in (q, k, v)), H, tm)
    assert launched == [(K.instance_dim(d), d)]
    assert got.shape == dense.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), dense, **TOL)


def _jax_grads(q, k, v, do, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(jax_mha(q, k, v, H, mask=jm) * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _grad_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 40, 96, 128])
def test_gradients_through_the_pad_match_jax(monkeypatch, d, masked):
    """The autograd node on the padded tensors (its forward at the instance,
    its backward the backward formula at the instance with the true head
    dim's scale, as the card's backward kernel gets it), the pad and the crop
    differentiable around it: the gradients of q, k and v, cropped, against
    JAX's autodiff of its dense attention; and autograd through the padded
    plain version."""
    q, k, v, mask = _inputs(d, "self", masked, seed=2)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    want = _jax_grads(q, k, v, do, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    launched = _cpu_launches(monkeypatch, tm)
    seen = []
    backward = K.flash_mha_bwd

    def bwd(*args, **kw):
        seen.append((args[0].shape[-1] // H, kw["head_dim"]))
        return backward(*args, **kw)

    monkeypatch.setattr(K, "flash_mha_bwd", bwd)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    keep = None if tm is None else tm.to(torch.uint8)
    tiles = None if tm is None else K.mask_tiles(tm)
    out = K._node(*ts, H, d, keep, tiles, 0.0, 0)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    D = K.instance_dim(d)
    assert launched == [(D, d)] and seen == [(D, d)]
    _grad_close([g.numpy() for g in got], want)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(K.flash_mha_padded_plain(*ts, H, mask=tm), ts, torch.from_numpy(do))
    _grad_close([g.numpy() for g in got], want)


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("d", [16, 40, 96])
def test_backward_wrapper_takes_instance_dims(monkeypatch, d, padded):
    """flash_mha_bwd's launch takes heads at an instance's dim: on heads
    padded to it (as the autograd node hands them) with ``head_dim`` the
    true dim, one launch at the instance with the true dim's scales and
    gradients at the instance's width; on heads between instances it raises
    (the node is the one place that pads)."""

    class Lib:
        calls = []

        def flash_mha_bwd_f32(self, *args):
            self.calls.append(args)
            return 0

    lib = Lib()
    monkeypatch.setattr(K, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_checked", lambda q, k, v, h, m, dt: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h, None))
    B, Tq, Tk = 2, 70, 50
    D = K.instance_dim(d)
    width = D if padded else d
    q, o, do = (torch.ones(B, Tq, H * width) for _ in range(3))
    k, v = (torch.ones(B, Tk, H * width) for _ in range(2))
    call = lambda: K._launch_bwd("flash_mha_bwd_f32", torch.float32, q, k, v, o, do, H,  # noqa: E731
                                 torch.zeros(B * H, Tq), None, 0.0, 0,
                                 head_dim=d if padded else None)
    if not padded:
        with pytest.raises(ValueError, match=f"head dim {d} is no instance's"):
            call()
        assert lib.calls == []
        return
    grads = call()
    (args,) = lib.calls
    assert args[17] == D  # the instance's head dim, then the keys a block and the scales
    assert args[19] == pytest.approx(K.q_scale(d)) and args[20] == pytest.approx(d ** -0.5)
    assert [tuple(g.shape) for g in grads] == [(B, Tq, H * D), (B, Tk, H * D), (B, Tk, H * D)]


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [96, 128])
def test_dropout_at_the_d128_instance_matches_pallas(monkeypatch, d, masked, rate):
    """A forward with dropout at head dim 128 (and 96, padded to it)
    through the autograd node's launch path (the launch the plain version at
    the instance, with the rate and seed the kernel gets), against JAX's
    ``flash_mha`` (the Pallas kernel, interpret mode) with the same seed: the
    hashed pattern is the Pallas kernel's, the zero channels change no
    score."""
    q, k, v, mask = _inputs(d, "cross", masked, seed=3)
    seed = 424242
    tm = None if mask is None else torch.from_numpy(mask)
    launched = _cpu_launches(monkeypatch, tm)
    want = np.asarray(jax_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
        mask=None if mask is None else jnp.asarray(mask), dropout=rate,
        dropout_seed=jnp.int32(seed), block_q=64, block_k=64, interpret=True))
    keep = None if tm is None else tm.to(torch.uint8)
    tiles = None if tm is None else K.mask_tiles(tm)
    got = K._node(*(torch.from_numpy(a) for a in (q, k, v)), H, d, keep, tiles, rate, seed)
    assert launched == [(128, d)]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    undropped, _ = _jax(q, k, v, mask)
    assert np.abs(got.numpy() - undropped).max() > 0.05  # the drop is there


@pytest.mark.parametrize("case", ["released width, 4 heads (d = 128)",
                                  "channels 8, 4 heads (d = 16)",
                                  "channels 8, 4 heads (d = 16), padded path"])
def test_htdemucs_at_other_head_dims_matches_jax(monkeypatch, case):
    """HTDemucs whose transformer width and head count give head dim 128 (the
    released width with t_heads=4, 1.0 s segment) and 16 (channels 8),
    against JAX's HTDemucs on the same weights (carried by zoo/convert.py);
    the last case with the transformer's attention on the padded path's
    plain version, the path a CUDA tensor takes at d = 16."""
    if case.startswith("released"):
        jcfg = jht.HTDemucsConfig(sources=SOURCES, segment=1.0, **dict(RELEASED, t_heads=4))
        length = 44100
    else:
        jcfg = dataclasses.replace(_golden_cfg(), channels=8)
        length = jcfg.training_length
    heads = jcfg.t_heads
    width = jcfg.bottom_channels or jcfg.channels * jcfg.growth ** (jcfg.depth - 1)
    assert width // heads == (128 if case.startswith("released") else 16)
    params = _test_params(jcfg, 5)
    mix = (np.random.default_rng(4).standard_normal((1, 2, length)) * 0.1).astype(np.float32)
    want = np.asarray(_jax_forward(params, mix, jcfg))
    model = _port_model(jcfg, params)
    if case.endswith("padded path"):
        calls = []

        def padded(q, k, v, num_heads, mask=None, **kw):
            calls.append(q.shape[-1] // num_heads)
            return K.flash_mha_padded_plain(q, k, v, num_heads, mask=mask)

        monkeypatch.setattr(ttr, "flash_mha", padded)
    got = _forward(model, mix)
    if case.endswith("padded path"):
        assert calls and set(calls) == {16}
    assert _rel_err(got, want) < RTOL


def test_refusals(monkeypatch):
    """What no instance computes raises, naming the ROADMAP item: a head dim
    past 128 (forward, op, a gradient or dropout, the backward). A gradient
    and dropout at 64 < d <= 128 are taken now: the node launches the D =
    128 instance on either route."""
    with pytest.raises(ValueError, match="head dims up to 128.*ROADMAP Queue C"):
        K.instance_dim(129)
    q = torch.zeros(1, 8, 144)
    with pytest.raises(ValueError, match="head dims up to 128"):
        K._flash_mha_op_cuda(q, q, q, 1)
    launched = _cpu_launches(monkeypatch, None)
    for kw in (dict(rate=0.0, grad=True), dict(rate=0.1, grad=False)):
        x = q.clone().requires_grad_(kw["grad"])
        with pytest.raises(ValueError, match="head dims up to 128.*ROADMAP Queue C"):
            K._node(x, q, q, 1, 144, None, None, kw["rate"], 7)
    with pytest.raises(ValueError, match="head dims up to 128.*ROADMAP Queue C"):
        K._launch_bwd("flash_mha_bwd_f32", torch.float32, q, q, q, q, q, 1, torch.zeros(1, 8),
                      None, 0.0, 0)
    assert launched == []
    for d in (96, 128):
        x = torch.ones(1, 8, d)
        for dtype in (torch.float32, torch.bfloat16):
            xs = [x.to(dtype).requires_grad_() for _ in range(3)]
            K._node(*xs, 1, d, None, None, 0.0, 0).sum().backward()  # the backward's plain twin
            K._node(*(x.to(dtype) for _ in range(3)), 1, d, None, None, 0.1, 7)
    assert launched == [(128, d) for d in (96, 128) for _ in range(4)]
