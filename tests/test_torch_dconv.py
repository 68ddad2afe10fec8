"""Port's BLSTM, LocalState, DConv and MultiWrap (demucs_tpu_torch.models.hlayers)
against demucs_tpu.models.hlayers' functions, and faults planted in them that
the model comparison must see.

Weights: the port's seeded numpy init (``models/initializers.py``), with
every LayerScale at 1.0 and random GroupNorms, carried to the JAX functions
by name. Inputs: seeded numpy. Tolerances: 1e-5 x peak for one layer (fp32,
sums in another order: the LSTM's 200 recurrent steps accumulate the most),
2e-4 x peak for the model (tests/test_golden.py).

The planted faults run a small HDemucs (nfft 256) whose DConv branches hold
the BLSTM and LocalState from depth 1 on, so that the frequency branch's
BLSTMs see 250 frames and run framed (200 steps at stride 100). A BLSTM
zeroed or a LocalState left out moves the output by more than 10 x the
tolerance; frames stitched one step late by more than 3 x (4.3 x measured:
one step of 250 in the overlap of the frames), and the BLSTM alone then
misses its own comparison by more than 10 x.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.models import hdemucs as jh
from demucs_tpu.models import hlayers as jhl
from demucs_tpu.zoo.torch_load import nest_state
from demucs_tpu_torch.models import hdemucs as th
from demucs_tpu_torch.models import hlayers as hl
from demucs_tpu_torch.models.initializers import Init
from demucs_tpu_torch.zoo.convert import flat_state

from test_golden import _mix
from test_torch_apply import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_hdemucs import RTOL, golden_cfg, jax_forward, port_forward, rel_err

LAYER_RTOL = 1e-5


def _init(module, seed=0):
    init = Init(seed)
    with torch.no_grad():
        init.module(module, 0.1)
        init.finish(module, 1.0, True)
    return module.eval()


def _x(*shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _run(module, *args):
    with torch.inference_mode():
        out = module(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    return (out[0] if isinstance(out, tuple) else out).numpy()


def _params(module):
    return nest_state(flat_state(module))


@pytest.mark.parametrize("length,max_steps,skip", [(90, None, False), (730, 200, True),
                                                   (400, 200, True)])
def test_blstm_matches_jax(length, max_steps, skip):
    module = _init(hl.BLSTM(12, layers=2, max_steps=max_steps, skip=skip))
    x = _x(2, 12, length)
    want = np.asarray(jhl.blstm_forward(_params(module), jnp.asarray(x), layers=2,
                                        max_steps=max_steps, skip=skip))
    assert rel_err(_run(module, x), want) < LAYER_RTOL


def test_unfold_and_stitch_match_jax():
    x = _x(2, 3, 730)
    frames = hl.unfold(torch.from_numpy(x), 200, 100)
    assert np.array_equal(frames.numpy(), np.asarray(jhl.unfold(jnp.asarray(x), 200, 100)))
    # frames that are the signal itself stitch back to it
    stitched = hl._stitch_frames(frames.permute(0, 2, 1, 3), 100, 730)
    assert np.array_equal(stitched.numpy(), x)


@pytest.mark.parametrize("ndecay", [4, 0])
def test_local_state_matches_jax(ndecay):
    module = _init(hl.LocalState(16, heads=4, ndecay=ndecay))
    x = _x(2, 16, 150)
    want = np.asarray(jhl.local_state_forward(_params(module), jnp.asarray(x), heads=4,
                                              ndecay=ndecay))
    assert rel_err(_run(module, x), want) < LAYER_RTOL


@pytest.mark.parametrize("lstm,attn", [(True, True), (True, False), (False, True)])
def test_dconv_matches_jax(lstm, attn):
    spec = hl.DConvSpec(channels=32, compress=4.0, depth=2, lstm=lstm, attn=attn)
    module = _init(hl.DConv(spec))
    assert [type(m).__name__ for m in module.layers[0]][3:5] == (
        ["BLSTM", "LocalState"] if lstm and attn else ["BLSTM" if lstm else "LocalState",
                                                       "Conv1d"])
    x = _x(2, 32, 260)
    jspec = jhl.DConvSpec(**dataclasses.asdict(spec))
    want = np.asarray(jhl.dconv_forward(_params(module), jspec, jnp.asarray(x)))
    assert rel_err(_run(module, x), want) < LAYER_RTOL


def test_multiwrap_matches_jax():
    lay = th.layout(th.HDemucsConfig(channels=6, nfft=1024, multi_freqs=(0.25, 0.5)))
    enc, dec = lay.enc[0], lay.dec[-1]
    assert enc.multi_freqs and dec.multi_freqs
    menc, mdec = _init(hl.enc_layer(enc)), _init(hl.dec_layer(dec), seed=1)
    assert isinstance(menc, hl.MultiWrapEnc) and len(menc.layers) == 3
    x = _x(1, enc.chin, 512, 20)
    jenc = jhl.EncSpec(**{**dataclasses.asdict(enc), "dconv": jhl.DConvSpec(
        **dataclasses.asdict(enc.dconv))})
    want = np.asarray(jhl.multiwrap_enc_forward(_params(menc), jenc, jnp.asarray(x)))
    got = _run(menc, x)
    assert got.shape == want.shape == (1, enc.chout, 128, 20)
    assert rel_err(got, want) < LAYER_RTOL
    y, skip = _x(1, dec.chin, 128, 20, seed=2), _x(1, dec.chin, 128, 20, seed=3)
    jdec = jhl.DecSpec(**{**dataclasses.asdict(dec), "dconv": None})
    want = np.asarray(jhl.multiwrap_dec_forward(_params(mdec), jdec, jnp.asarray(y),
                                                jnp.asarray(skip), 20)[0])
    got = _run(mdec, y, skip, 20)
    assert got.shape == want.shape == (1, dec.chout, 512, 20)
    assert rel_err(got, want) < LAYER_RTOL


@pytest.fixture(scope="module")
def deep_dconv():
    """A small HDemucs (channels 16: LocalState's 4 heads need 4 hidden
    channels; nfft 256: 250 frames) with BLSTM and LocalState from depth 1
    on, and its JAX forward on a 16000-sample mix."""
    jcfg = golden_cfg(channels=16, nfft=256, dconv_lstm=1, dconv_attn=1)
    model = th.init_hdemucs(th.HDemucsConfig(**dataclasses.asdict(jcfg)), seed=2,
                            layer_scale=1.0, random_norms=True)
    mix = _mix(16000)
    return model, mix, jax_forward(jh.forward, model, mix, jcfg)


@pytest.mark.parametrize("fault", ["blstm_zeroed", "local_state_left_out",
                                   "frames_off_by_one"])
def test_planted_fault_fails_the_comparison(deep_dconv, fault, monkeypatch):
    model, mix, want = deep_dconv
    assert rel_err(port_forward(model, mix), want) < RTOL
    calls = []
    if fault == "blstm_zeroed":
        monkeypatch.setattr(hl.BLSTM, "forward", lambda self, x: torch.zeros_like(x))
    elif fault == "local_state_left_out":
        monkeypatch.setattr(hl.LocalState, "forward", lambda self, x: x)
    else:  # every stitched frame read one step late
        stitch = hl._stitch_frames

        def late(frames, stride, length):
            calls.append(length)
            return stitch(frames, stride, length + 1)[..., 1:]

        monkeypatch.setattr(hl, "_stitch_frames", late)
    err = rel_err(port_forward(model, mix), want)
    if fault != "frames_off_by_one":
        assert err > 10 * RTOL
        return
    assert err > 3 * RTOL
    assert calls and min(calls) >= 250  # the framed path ran, in the freq branch too
    module = _init(hl.BLSTM(12, layers=2, max_steps=200, skip=True))
    x = _x(2, 12, 730)
    want = np.asarray(jhl.blstm_forward(_params(module), jnp.asarray(x), layers=2,
                                        max_steps=200, skip=True))
    assert rel_err(_run(module, x), want) > 10 * LAYER_RTOL
