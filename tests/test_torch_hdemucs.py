"""Port's HDemucs (demucs_tpu_torch.models.hdemucs) against demucs_tpu's, on the
CPU: the golden output, the JAX forward at the golden config's options and at
the released widths, and the weights of the seeded init.

The port's ``init_hdemucs(cfg, seed)`` draws the JAX package's numbers, so
the golden case runs on the port's own weights. The other comparisons set
every LayerScale to 1.0 and draw every GroupNorm at random
(``layer_scale=1.0, random_norms=True``): at the 1e-4 init the DConv
branches, and the BLSTM and LocalState inside them, reach the output at
about 1e-4 of its size, below the tolerance (tests/test_torch_dconv.py
plants faults that the comparison must then see). The weights go to the JAX
forward through their flat names.

Tolerance: 2e-4 x peak of the output, the bound of tests/test_golden.py
(fp32 on both sides, sums in another order through a deep network). The
released-width case is hdemucs_mmi's shape (tests/common.py:64: channels 48,
depth 6, nfft 4096, BLSTM and LocalState from depth 4) at a 1.0 s segment.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import hdemucs as jh
from demucs_tpu.zoo.torch_load import flatten_state, nest_state
from demucs_tpu_torch.models import hdemucs as th
from demucs_tpu_torch.zoo.convert import flat_state

sys.path.insert(0, str(Path(__file__).parent))
from test_golden import GOLDEN_DIR, SOURCES, _mix  # noqa: E402
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)

RTOL = 2e-4  # x peak of the output
RELEASED = dict(channels=48, depth=6, nfft=4096, samplerate=44100)


def golden_cfg(**kw):
    return jh.HDemucsConfig(**dict(dict(sources=SOURCES, channels=4, samplerate=8000), **kw))


def rel_err(got, want) -> float:
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_forward(module, mix):
    with torch.inference_mode():
        return module.eval()(torch.from_numpy(mix)).numpy()


def jax_forward(forward, module, mix, cfg):
    """The JAX ``forward`` of the family with the port module's weights."""
    params = nest_state(flat_state(module))
    return np.asarray(jax.jit(forward, static_argnames=("cfg",))(params, jnp.asarray(mix), cfg))


def test_golden_hdemucs():
    jcfg = golden_cfg()
    model = th.init_hdemucs(th.HDemucsConfig(**dataclasses.asdict(jcfg)), seed=7)
    want = np.load(GOLDEN_DIR / "hdemucs.npz")["out"]
    assert rel_err(port_forward(model, _mix(8192)), want) < RTOL


def test_init_draws_the_jax_weights():
    """init_hdemucs(cfg, seed) equals the JAX package's, tensor for tensor,
    BLSTM, LocalState and MultiWrap included."""
    jcfg = golden_cfg(nfft=1024, dconv_lstm=2, dconv_attn=3, multi_freqs=(0.25,))
    want = flatten_state(jh.init_hdemucs(jcfg, seed=3))
    got = flat_state(th.init_hdemucs(th.HDemucsConfig(**dataclasses.asdict(jcfg)), seed=3))
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].shape == np.shape(value), name
        assert np.array_equal(got[name], np.asarray(value)), name


@pytest.fixture(scope="module")
def released():
    jcfg = jh.HDemucsConfig(sources=SOURCES, segment=1.0, **RELEASED)
    model = th.init_hdemucs(th.HDemucsConfig(**dataclasses.asdict(jcfg)), seed=5,
                            layer_scale=1.0, random_norms=True)
    mix = (np.random.default_rng(0).standard_normal((1, 2, 44100)) * 0.1).astype(np.float32)
    return jcfg, model, mix, jax_forward(jh.forward, model, mix, jcfg)


def test_released_widths_match_jax_forward(released):
    jcfg, model, mix, want = released
    assert rel_err(port_forward(model, mix), want) < RTOL


@pytest.mark.parametrize("variant", [
    dict(hybrid_old=True),
    dict(hybrid=False),
    dict(cac=False, wiener_iters=0),
    dict(cac=False, wiener_iters=1),
    dict(cac=False, wiener_iters=1, wiener_residual=True),
    dict(cac=False, wiener_iters=-1),
    dict(hybrid_old=True, cac=False, norm_starts=999),  # the MDX-era hybrids' flags
    dict(multi_freqs=(0.25,), nfft=1024),
    dict(dconv_mode=3, channels_time=6, rewrite=False, context_enc=1),
], ids=lambda v: ",".join(f"{k}={v[k]}" for k in v))
def test_options_match_jax(variant):
    jcfg = golden_cfg(**variant)
    model = th.init_hdemucs(th.HDemucsConfig(**dataclasses.asdict(jcfg)), seed=11,
                            layer_scale=1.0, random_norms=True)
    mix = _mix(6000)
    want = jax_forward(jh.forward, model, mix, jcfg)
    assert rel_err(port_forward(model, mix), want) < RTOL


def test_config_fields_and_defaults_equal_jax():
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert fields(th.HDemucsConfig) == fields(jh.HDemucsConfig)
    assert th.HDemucsConfig().hop_length == 1024
    # matmul_precision is ported (tests/test_torch_precision.py); a dot-algorithm
    # name, which JAX's config takes, has no counterpart on the card
    assert th.HDemucs(th.HDemucsConfig(matmul_precision="highest")).cfg.matmul_precision
    with pytest.raises(ValueError, match="dot-algorithm"):
        th.HDemucs(th.HDemucsConfig(matmul_precision="BF16_BF16_F32_X3"))
