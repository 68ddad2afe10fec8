"""HTDemucs's remaining options in the port against demucs_tpu's forward on the
same weights (carried by load_flat_state): the static sparse attention masks
(through K3's plain version here), LSH sparsity (the dense route, with the
JAX package's projections put into the port), CAPE, sin_random_shift and
dropout at eval, cac=False with each Wiener setting, and multi_freqs.

Every LayerScale at 1.0 and random norm weights, as the other model checks
(tests/test_torch_htdemucs.py). Tolerance 2e-4 x peak of the output, the
golden bound (tests/test_golden.py:73): fp32 on both sides on the CPU, sums
in another order.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.models import htdemucs as jht
from demucs_tpu_torch.models import htdemucs as tht

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_apply import one_torch_thread  # noqa: E402,F401 (autouse fixture)
from test_torch_htdemucs import (RELEASED, RTOL, SOURCES, _forward, _jax_forward,  # noqa: E402
                                 _port_model, _rel_err, _test_params)

# A small HTDemucs whose token counts (128 frequency, 63 time tokens) the
# small windows below leave sparse.
SMALL = dict(sources=SOURCES, channels=8, depth=3, nfft=512, t_layers=2, t_heads=2,
             segment=0.5, samplerate=8000, t_sparse_attn_window=6, t_global_window=8)
BOTH = dict(t_sparse_self_attn=True, t_sparse_cross_attn=True)
CASES = {
    "sparse-self-diag": dict(t_sparse_self_attn=True),
    "sparse-cross-diag": dict(t_sparse_cross_attn=True),
    "sparse-both-diag": BOTH,
    "sparse-both-diag_global": dict(BOTH, t_mask_type="diag_global"),
    "sparse-both-diag_jmask_random": dict(BOTH, t_mask_type="diag_jmask_random"),
    "lsh-self": dict(t_sparse_self_attn=True, t_auto_sparsity=True),
    "lsh-both": dict(BOTH, t_auto_sparsity=True, t_sparsity=0.8),
    "cape-augment": dict(t_emb="cape", t_cape_augment=True),
    "cape-no-augment": dict(t_emb="cape", t_cape_augment=False),
    "cape-no-mean-normalize": dict(t_emb="cape", t_cape_mean_normalize=False),
    "t_sin_random_shift=3": dict(t_sin_random_shift=3),
    "t_dropout=0.1": dict(t_dropout=0.1),
    "cac=False-mixture-phase": dict(cac=False, wiener_iters=-1),
    "cac=False-wiener-0": dict(cac=False, wiener_iters=0),
    "cac=False-wiener-1": dict(cac=False, wiener_iters=1),
    "cac=False-wiener-1-residual": dict(cac=False, wiener_iters=1, wiener_residual=True),
    "multi_freqs": dict(multi_freqs=(0.25, 0.5), nfft=2048),
}


def _with_jax_projections(model, jcfg):
    """The LSH projections the JAX package draws at eval, put into the port."""
    enc = model.crosstransformer
    if enc.lsh_projections is not None:
        d = enc.spec.dim // enc.spec.num_heads
        R = jax.random.normal(jax.random.PRNGKey(jcfg.t_mask_random_seed), (d, 32, 2),
                              jnp.float32)
        enc.set_lsh_projections(np.array(R))
    return model


def _check(jcfg, seed, mix):
    params = _test_params(jcfg, seed)
    want = np.asarray(_jax_forward(params, mix, jcfg))
    got = _forward(_with_jax_projections(_port_model(jcfg, params), jcfg), mix)
    assert np.isfinite(got).all()
    return _rel_err(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax_forward(case):
    jcfg = jht.HTDemucsConfig(**dict(SMALL, **CASES[case]))
    mix = (np.random.default_rng(0).standard_normal((1, 2, jcfg.training_length))
           * 0.1).astype(np.float32)
    assert _check(jcfg, 1, mix) < RTOL


def test_static_sparse_released_widths_match_jax_forward():
    """Released widths (1.0 s segment: 344 frequency, 172 time tokens) with
    static sparse self- and cross-attention at the reference's mask defaults
    (diag, window 500, global 100) and a narrower window that leaves the
    masks sparse at this length."""
    mix = (np.random.default_rng(2).standard_normal((1, 2, 44100)) * 0.1).astype(np.float32)
    jcfg = jht.HTDemucsConfig(sources=SOURCES, segment=1.0, t_sparse_attn_window=40,
                              t_mask_type="diag_jmask_random", **BOTH, **RELEASED)
    assert _check(jcfg, 3, mix) < RTOL


def test_variant_masks_reach_the_attention(monkeypatch):
    """The static masks are K3's input (a cached uint8 table, the same object
    on every call of a shape), and the LSH layers take the dense route."""
    from demucs_tpu_torch.models import transformer as ttr

    seen = []
    real_flash, real_dense = ttr.flash_mha, ttr.multihead_attention

    def flash(q, k, v, heads, *, mask=None):
        seen.append(("k3", mask))
        return real_flash(q, k, v, heads, mask=mask)

    def dense(q, k, v, heads, mask=None):
        seen.append(("dense", mask))
        return real_dense(q, k, v, heads, mask=mask)

    monkeypatch.setattr(ttr, "flash_mha", flash)
    monkeypatch.setattr(ttr, "multihead_attention", dense)
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 4000))
                           .astype(np.float32))
    for extra, route in ((dict(t_sparse_self_attn=True), "k3"),
                         (dict(t_sparse_cross_attn=True, t_auto_sparsity=True), "dense")):
        cfg = tht.HTDemucsConfig(**dict(SMALL, **extra))
        model = tht.init_htdemucs(cfg, seed=0).eval()
        seen.clear()
        with torch.inference_mode():
            model(mix)
            model(mix)
        # 2 layers x 2 branches per forward: layer 0 self, layer 1 cross
        assert len(seen) == 8
        masked = [m for r, m in seen if m is not None]
        assert all(r == route for r, m in seen if m is not None) and len(masked) == 4
        if route == "k3":
            assert all(m.dtype == torch.uint8 and m.is_contiguous() for m in masked)
            assert masked[0] is masked[2] and masked[1] is masked[3]  # cached per shape
        else:
            assert all(m.dtype == torch.bool and m.dim() == 4 for m in masked)


def test_lsh_projections_follow_the_module():
    """The projections move with .to(), survive a bf16 stage unrounded, and
    are not part of the state dict (checkpoints carry none)."""
    cfg = tht.HTDemucsConfig(**dict(SMALL, t_sparse_self_attn=True, t_auto_sparsity=True))
    model = tht.HTDemucs(cfg)
    R = model.crosstransformer.lsh_projections
    assert R.shape == (cfg.channels * 4 // cfg.t_heads, 32, 2) and R.dtype == torch.float32
    assert not any("lsh" in k for k in model.state_dict())
    bf16 = tht.HTDemucs(dataclasses.replace(cfg, bf16_stages=("transformer",)))
    assert bf16.crosstransformer.layers[0].linear1.weight.dtype == torch.bfloat16
    assert torch.equal(bf16.crosstransformer.lsh_projections, R)
    with pytest.raises(ValueError, match="do not fit"):
        model.crosstransformer.set_lsh_projections(np.zeros((3, 32, 2), np.float32))
