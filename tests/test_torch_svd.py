"""The port's SVD penalty (demucs_tpu_torch.train.svd) against the JAX
package's (demucs_tpu.train.svd) on the same weights: a small HTDemucs and
a small Demucs v2 (its transposed convs at positional names), the exact
penalty and its gradient, the randomized estimators with JAX's probes
injected, and the skip's pattern.

Tolerances:
- exact penalty: 1e-5 relative (fp32 SVDs of the same matrices by two
  LAPACK calls, summed in another order); its gradient per tensor within
  2e-4 x that tensor's peak (the singular vectors' products);
- low-rank SVD and power method with JAX's probes: 1e-4 relative (QR and a
  few products in fp32 in another order);
- the skip pattern and the transposed-conv names: equal.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import demucs as jd
from demucs_tpu.models import htdemucs as jht
from demucs_tpu.train import svd as jsvd
from demucs_tpu.zoo.torch_load import flatten_state, nest_state
from demucs_tpu_torch.models import demucs as td
from demucs_tpu_torch.models import htdemucs as tht
from demucs_tpu_torch.train import svd as tsvd
from demucs_tpu_torch.zoo.convert import load_flat_state

from common import SOURCES
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)

MIN_SIZE = 1e-4  # 26 elements: every conv and linear of the small models
HT = dict(sources=tuple(SOURCES), channels=8, depth=2, nfft=512, t_layers=2, t_heads=2,
          segment=0.5, samplerate=8000)
V2 = dict(sources=tuple(SOURCES), channels=8, depth=3, samplerate=8000, segment=1.0)


def _rel(got, want):
    got = got.item() if isinstance(got, torch.Tensor) else float(got)
    return abs(got - float(want)) / abs(float(want))


def _pair(kind):
    """JAX params (nested) and the port's parameters (a name -> tensor dict
    of leaves that require grad) holding the same seeded weights."""
    if kind == "htdemucs":
        jcfg = jht.HTDemucsConfig(**HT)
        flat = flatten_state(jht.init_htdemucs(jcfg, seed=0))
        module = tht.HTDemucs(tht.HTDemucsConfig(**dataclasses.asdict(jcfg))).float()
    else:
        jcfg = jd.DemucsConfig(**V2)
        flat = flatten_state(jd.init_demucs(jcfg, seed=0))
        module = td.Demucs(td.DemucsConfig(**dataclasses.asdict(jcfg)))
    flat = {k: np.asarray(v) for k, v in flat.items()}
    module = load_flat_state(module, flat)
    return jcfg, nest_state(flat), dict(module.named_parameters()), module.cfg


def _jax_order(params, convtr, conv_only=False, convtr_names=frozenset()):
    """The names of the matrices JAX's walk collects, in its order (the
    index its probes are folded with)."""
    names = []
    for name, p in flatten_state(params).items():
        if p.size / 2**18 < MIN_SIZE or p.ndim == 1 or (p.ndim == 2 and conv_only):
            continue
        if p.ndim in (2, 3, 4):
            names.append(name)
    want = jsvd._collect_matrices(params, MIN_SIZE, convtr, conv_only, convtr_names)
    assert len(want) == len(names)
    return names


@pytest.mark.parametrize("kind,convtr", [("htdemucs", True), ("htdemucs", False),
                                         ("demucs", True)])
def test_exact_penalty_and_gradient_match_jax(kind, convtr):
    jcfg, jparams, params, cfg = _pair(kind)
    names = tsvd.convtr_names_for(kind, cfg)
    assert names == jsvd.convtr_names_for(type("M", (), {"kind": kind, "cfg": jcfg}))

    def jax_total(p):
        return jsvd.svd_total(p, min_size=MIN_SIZE, convtr=convtr, exact=True,
                              convtr_names=names)

    want, want_grads = jax.jit(jax.value_and_grad(jax_total))(jparams)
    got = tsvd.svd_total(params, min_size=MIN_SIZE, convtr=convtr, exact=True,
                         convtr_names=names)
    assert _rel(got, want) <= 1e-5
    got.backward()
    want_grads = flatten_state(want_grads)
    covered = 0
    for name, p in params.items():
        g = np.asarray(want_grads[name])
        if not np.abs(g).max():
            assert p.grad is None or not p.grad.abs().max()
            continue
        covered += 1
        assert np.abs(p.grad.numpy() - g).max() <= 2e-4 * np.abs(g).max(), name
    assert covered == len(tsvd.collect_matrices(params, MIN_SIZE, convtr, False, names))


@pytest.mark.parametrize("kind", ["htdemucs", "demucs"])
@pytest.mark.parametrize("powm,dim,niters,bs", [(False, 1, 2, 1), (False, 3, 3, 1),
                                                (True, 1, 2, 1), (True, 1, 4, 3)])
def test_randomized_estimates_match_jax_with_its_probes(kind, powm, dim, niters, bs):
    jcfg, jparams, params, cfg = _pair(kind)
    names = tsvd.convtr_names_for(kind, cfg)
    key = jax.random.PRNGKey(11)
    kw = dict(min_size=MIN_SIZE, dim=dim, niters=niters, powm=powm, bs=bs, convtr=True,
              convtr_names=names)
    # eagerly: under jit the dict's walk is in sorted key order, which renumbers the probes
    want = jsvd.svd_total(jparams, key=key, **kw)
    order = _jax_order(jparams, True, convtr_names=names)
    mats = dict(tsvd.collect_matrices(params, MIN_SIZE, True, False, names))
    assert set(order) == set(mats)
    probes = {}
    for i, name in enumerate(order):
        m, n = mats[name].shape
        shape = (min(m, n), bs) if powm else (n, dim)
        probes[name] = torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(key, i), shape, dtype=jnp.float32)))
    got = tsvd.svd_total(params, probes=probes, **kw)
    assert _rel(got, want) <= 1e-4
    exact = tsvd.svd_total(params, min_size=MIN_SIZE, exact=True, convtr_names=names)
    assert float(got) <= float(exact) * (1 + 1e-4)  # an estimate from below


def test_generator_draws_are_seeded():
    _, _, params, _ = _pair("htdemucs")
    a = tsvd.svd_total(params, min_size=MIN_SIZE, generator=torch.Generator().manual_seed(1))
    b = tsvd.svd_total(params, min_size=MIN_SIZE, generator=torch.Generator().manual_seed(1))
    c = tsvd.svd_total(params, min_size=MIN_SIZE, generator=torch.Generator().manual_seed(2))
    assert float(a) == float(b) and float(a) != float(c)
    with pytest.raises(ValueError, match="generator"):
        tsvd.svd_total(params, min_size=MIN_SIZE)


@pytest.mark.parametrize("cfg", [dict(), dict(rewrite=False), dict(dconv_mode=0),
                                 dict(dconv_mode=2, depth=4), dict(channels=16, growth=1.5)])
def test_convtr_param_names_match_jax(cfg):
    kw = dict(V2, **cfg)
    want = jd.convtr_param_names(jd.DemucsConfig(**kw))
    tcfg = td.DemucsConfig(**kw)
    got = td.convtr_param_names(tcfg)
    assert got == want
    with torch.device("meta"):
        module = td.Demucs(tcfg)
    assert got == {f"{n}.weight" for n, m in module.named_modules()
                   if isinstance(m, torch.nn.ConvTranspose1d)}


@pytest.mark.parametrize("proba", [0.2, 0.5, 1.0])
def test_skip_pattern_matches_jax(proba):
    """Over 100 steps the port's penalty fires on the same steps as the JAX
    package's, both from a fresh Random(1234); a step that fires is unbiased
    by 1 / proba."""
    _, jparams, params, _ = _pair("htdemucs")
    kw = dict(min_size=0.01, exact=True, proba=proba)
    saved = jsvd.penalty_rng.getstate()
    try:
        jsvd.penalty_rng.seed(1234)
        want = [float(jsvd.svd_penalty(jparams, **kw)) for _ in range(100)]
    finally:
        jsvd.penalty_rng.setstate(saved)
    rng = random.Random(tsvd.PENALTY_SEED)
    with torch.no_grad():
        got = [float(tsvd.svd_penalty(params, rng, **kw)) for _ in range(100)]
    assert [g == 0 for g in got] == [w == 0 for w in want]
    assert np.allclose(got, want, rtol=1e-5)
    rng = random.Random(tsvd.PENALTY_SEED)
    penalty = tsvd.SvdPenalty(weight=1.0, proba=proba)
    assert [penalty.fires(rng) for _ in range(100)] == [w != 0 for w in want]
