"""Port's NN primitives (demucs_tpu_torch.ops.nn) against demucs_tpu.ops.nn.

Tolerance: atol 1e-5 — fp32 convolutions and reductions summed in another
order (XLA:CPU against oneDNN/ATen), at unit-scale inputs. A bf16 product on
the CPU is bit-equal to the fp32 product of its bf16 values rounded once
(the port computes it so; oneDNN's bf16 convolution did not, ROADMAP C3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops import nn as J
from demucs_tpu_torch.ops import nn as T

from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5


def _r(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (4, 2, 1, 1), (1, 2, 2, 1), (1, 1, 1, 2)])
def test_conv1d(stride, padding, dilation, groups):
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 4, 37), 0), _r((6, 4 // groups, 3), 1, 0.3),
                                       _r((6,), 2))
    kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    _close(T.conv1d(tx, tw, tb, **kw), J.conv1d(jx, jw, jb, **kw))


@pytest.mark.parametrize("stride,padding", [((4, 1), (2, 0)), (1, (1, 1))])
def test_conv2d(stride, padding):
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 4, 32, 9), 3), _r((6, 4, 3, 3), 4, 0.3),
                                       _r((6,), 5))
    _close(T.conv2d(tx, tw, tb, stride=stride, padding=padding),
           J.conv2d(jx, jw, jb, stride=stride, padding=padding))


@pytest.mark.parametrize("stride,padding,kernel", [(1, 0, 3), (4, 0, 8), (2, 1, 4), (3, 0, 8)])
def test_conv_transpose1d(stride, padding, kernel):
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 5, 13), 6), _r((5, 3, kernel), 7, 0.3),
                                       _r((3,), 8))
    _close(T.conv_transpose1d(tx, tw, tb, stride=stride, padding=padding),
           J.conv_transpose1d(jx, jw, jb, stride=stride, padding=padding))


@pytest.mark.parametrize("stride,padding", [((4, 1), 0), ((2, 2), (1, 0))])
def test_conv_transpose2d(stride, padding):
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 5, 8, 6), 9), _r((5, 3, 8, 1), 10, 0.3),
                                       _r((3,), 11))
    _close(T.conv_transpose2d(tx, tw, tb, stride=stride, padding=padding),
           J.conv_transpose2d(jx, jw, jb, stride=stride, padding=padding))


def test_linear():
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 7, 16), 12), _r((9, 16), 13, 0.3), _r((9,), 14))
    _close(T.linear(tx, tw, tb), J.linear(jx, jw, jb))


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm(groups):
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 8, 5, 7), 15, 3.0) + 1.0, _r((8,), 16),
                                       _r((8,), 17))
    _close(T.group_norm(tx, groups, tw, tb), J.group_norm(jx, groups, jw, jb))


def test_layer_norm():
    (jx, jw, jb), (tx, tw, tb) = _pair(_r((2, 7, 16), 18, 3.0) + 1.0, _r((16,), 19),
                                       _r((16,), 20))
    _close(T.layer_norm(tx, tw, tb), J.layer_norm(jx, jw, jb))


def test_elementwise_and_reductions():
    (jx,), (tx,) = _pair(_r((2, 6, 11), 21, 2.0))
    _close(T.gelu(tx), J.gelu(jx))
    _close(T.glu(tx, axis=1), J.glu(jx, axis=1))
    _close(T.std_unbiased(tx, axis=(1, 2)), J.std_unbiased(jx, axis=(1, 2)))


def test_embedding():
    table = _r((10, 4), 22)
    ids = np.array([0, 3, 9, 3])
    _close(T.embedding(torch.from_numpy(ids), torch.from_numpy(table)),
           J.embedding(jnp.asarray(ids), jnp.asarray(table)))


@pytest.mark.parametrize("op,x_shape,w_shape,kw", [
    ("conv1d", (2, 8, 1000), (16, 8, 8), dict(stride=4, padding=2)),  # C3's tencoder shape
    ("conv1d", (2, 16, 250), (32, 16, 3), dict(padding=2, dilation=2)),
    ("conv2d", (2, 8, 64, 30), (16, 8, 8, 1), dict(stride=(4, 1), padding=(2, 0))),
    ("conv_transpose1d", (2, 16, 100), (16, 8, 8), dict(stride=4)),
    ("conv_transpose2d", (2, 16, 16, 30), (16, 8, 8, 1), dict(stride=(4, 1))),
    ("linear", (2, 50, 64), (32, 64), {})])
def test_bf16_cpu_products_round_once(op, x_shape, w_shape, kw):
    """bf16 on the CPU: the product of the bf16 values in fp32, rounded to bf16
    once, then the bias in bf16 (JAX's rounding points), and its gradients
    those of that fp32 product rounded once (JAX's cast transposes)."""
    x, w, b = (torch.from_numpy(_r(s, i)).bfloat16() for i, s in
               enumerate((x_shape, w_shape, (w_shape[1] if "transpose" in op else w_shape[0],))))
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    got = getattr(T, op)(*leaves, b, **kw)
    ref = [t.float().requires_grad_() for t in (x, w)]
    product = getattr(torch.nn.functional, op)(*ref, **kw)
    shape = (-1,) if op == "linear" else (-1,) + (1,) * (product.dim() - 2)
    want = product.bfloat16() + b.reshape(shape)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ct = torch.from_numpy(_r(tuple(got.shape), 9)).bfloat16()
    got_grads = torch.autograd.grad(got, leaves, ct)
    want_grads = torch.autograd.grad(product, ref, ct.float())
    for g, w_ in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w_.bfloat16(), rtol=0, atol=0)
