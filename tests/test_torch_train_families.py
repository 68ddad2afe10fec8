"""One train step of HDemucs and of Demucs v2 in the port (demucs_tpu_torch.train
.step) against the JAX package's ``make_train_step`` on the CPU, from the
same weights (each port's ``init_*`` draws the JAX package's numbers) and
the same batch: the loss, the gradient's global norm and every parameter's
gradient. HDemucs also with its DConv's BLSTM and LocalState on (from layer
3 of 4; one DConv layer a branch, so JAX compiles the step in about 9 s).
HTDemucs's case is in test_torch_train.py.

Tolerances: loss 1e-6 relative, global norm 1e-4 relative, each gradient
2e-4 x its peak plus 1e-9 (fp32 through every layer, summed in another order
by XLA:CPU and ATen; a bias before a norm has a zero gradient, noise on
either side).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import demucs as jd
from demucs_tpu.models import hdemucs as jh
from demucs_tpu.train.step import TrainConfig, make_train_step
from demucs_tpu.zoo.torch_load import flatten_state
from demucs_tpu_torch.models import demucs as td
from demucs_tpu_torch.models import hdemucs as th
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.train import config as tconfig
from demucs_tpu_torch.train import step as tstep

from common import SOURCES
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_train import _grad_keeper

FAMILIES = {
    "hdemucs": (jh, th, jh.HDemucsConfig, th.HDemucsConfig, jh.init_hdemucs, th.init_hdemucs,
                dict(depth=4, nfft=1024)),
    "demucs": (jd, td, jd.DemucsConfig, td.DemucsConfig, jd.init_demucs, td.init_demucs,
               dict(depth=4)),
    "hdemucs-blstm-localstate": (jh, th, jh.HDemucsConfig, th.HDemucsConfig, jh.init_hdemucs,
                                 th.init_hdemucs, dict(depth=4, nfft=1024, dconv_lstm=3,
                                                       dconv_attn=3, dconv_depth=1)),
}


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_family_train_step_matches_jax(kind):
    jm, _, jcfg_cls, tcfg_cls, jinit, tinit, kw = FAMILIES[kind]
    jcfg = jcfg_cls(sources=tuple(SOURCES), channels=4, samplerate=8000, segment=1.0, **kw)
    params = jinit(jcfg, seed=7)
    module = tinit(tcfg_cls(**dataclasses.asdict(jcfg)), seed=7).train()
    sources = (0.2 * np.random.default_rng(0).standard_normal((2, 4, 2, 8000))
               ).astype(np.float32)
    keeper = _grad_keeper()
    step = jax.jit(make_train_step(jm.forward, jcfg, TrainConfig(), keeper))
    _, want, metrics = step(params, keeper.init(params), jnp.asarray(sources),
                            jax.random.PRNGKey(0))
    want = flatten_state(want)
    model = Model(kind.split("-")[0], module.cfg, module)
    args = tconfig.TrainArgs()
    args.optim.lr = 0.0
    got = tstep.train_step(model, tstep.make_optimizer(args, model), torch.from_numpy(sources))
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= 1e-6 * float(metrics["loss"])
    assert abs(float(got["grad_norm"]) - float(metrics["grad_norm"])) <= (
        1e-4 * float(metrics["grad_norm"]))
    grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = np.asarray(want[n])
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max() + 1e-9, n
