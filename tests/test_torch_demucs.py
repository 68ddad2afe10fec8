"""Port's Demucs v2 (demucs_tpu_torch.models.demucs) against demucs_tpu's, on the
CPU: the golden output, the JAX forward at the golden config's options and at
the released widths, valid_length and the seeded init.

As in tests/test_torch_hdemucs.py: the golden case runs on the port's own
seeded weights (the JAX package's numbers); the other comparisons set every
LayerScale to 1.0 and draw every GroupNorm at random, and carry the weights
to the JAX forward by name. Tolerance 2e-4 x peak (tests/test_golden.py).
The released-width case is tests/common.py:65 (channels 64, depth 6, BLSTM
and LocalState from depth 4) at a 1.0 s segment.
"""

import dataclasses

import numpy as np
import pytest

from demucs_tpu.models import demucs as jd
from demucs_tpu.zoo.torch_load import flatten_state
from demucs_tpu_torch.models import demucs as td
from demucs_tpu_torch.models.registry import Model
from demucs_tpu_torch.zoo.convert import flat_state

from test_golden import GOLDEN_DIR, SOURCES, _mix
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_hdemucs import RTOL, jax_forward, port_forward, rel_err


def golden_cfg(**kw):
    kw = dict(dict(channels=4, depth=4, samplerate=8000), **kw)
    return jd.DemucsConfig(sources=SOURCES, **kw)


def port_model(jcfg, seed, **init_kw):
    return td.init_demucs(td.DemucsConfig(**dataclasses.asdict(jcfg)), seed=seed, **init_kw)


def test_golden_demucs():
    model = port_model(golden_cfg(), 7)
    want = np.load(GOLDEN_DIR / "demucs.npz")["out"]
    assert rel_err(port_forward(model, _mix(4096)), want) < RTOL


def test_init_draws_the_jax_weights():
    jcfg = golden_cfg(lstm_layers=2, dconv_mode=3, dconv_lstm=2, dconv_attn=3)
    want = flatten_state(jd.init_demucs(jcfg, seed=3))
    got = flat_state(port_model(jcfg, 3))
    assert set(got) == set(want)
    for name, value in want.items():
        assert np.array_equal(got[name], np.asarray(value)), name


@pytest.mark.parametrize("variant", [
    dict(),
    dict(lstm_layers=2),
    dict(resample=False),
    dict(normalize=False, gelu=False, glu=False),
    dict(dconv_mode=3, rewrite=False, norm_starts=2),
    dict(dconv_lstm=2, dconv_attn=3),
], ids=lambda v: ",".join(f"{k}={v[k]}" for k in v) or "golden")
def test_options_match_jax(variant):
    jcfg = golden_cfg(**variant)
    model = port_model(jcfg, 11, layer_scale=1.0, random_norms=True)
    mix = _mix(5000)  # not a valid length: the forward pads and trims
    want = jax_forward(jd.forward, model, mix, jcfg)
    got = port_forward(model, mix)
    assert got.shape == (1, 4, 2, 5000)
    assert rel_err(got, want) < RTOL


def test_released_widths_match_jax_forward():
    jcfg = jd.DemucsConfig(sources=SOURCES, channels=64, depth=6, samplerate=44100, segment=1.0)
    model = port_model(jcfg, 5, layer_scale=1.0, random_norms=True)
    mix = (np.random.default_rng(0).standard_normal((1, 2, 44100)) * 0.1).astype(np.float32)
    want = jax_forward(jd.forward, model, mix, jcfg)
    assert rel_err(port_forward(model, mix), want) < RTOL


@pytest.mark.parametrize("length", [1, 100, 4096, 44100, 1940400])
@pytest.mark.parametrize("resample", [True, False])
def test_valid_length_equals_jax(length, resample):
    jcfg = jd.DemucsConfig(resample=resample)
    tcfg = td.DemucsConfig(resample=resample)
    assert td.valid_length(tcfg, length) == jd.valid_length(jcfg, length) >= length
    model = Model("demucs", tcfg, td.Demucs(tcfg))
    assert model.valid_length(length) == model.leaf_target(length, 1.0) == \
        jd.valid_length(jcfg, length)


def test_config_fields_and_defaults_equal_jax():
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert fields(td.DemucsConfig) == fields(jd.DemucsConfig)
