"""Port's attention (the plain version of kernel K3, demucs_tpu_torch.ops.attention
and the K3 wrapper on a CPU tensor) against demucs_tpu's multihead_attention
and its Pallas flash_mha (interpret mode), on the cases of
test_pallas_attention.py: aligned, ragged self, ragged cross, the static
sparse masks, and a fully masked first key block.

Tolerance: atol 2e-5, rtol 1e-4, the bound the JAX package holds its own
kernel to (fp32 softmax and products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.attention import multihead_attention
from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu.ops.sparse import get_mask
from demucs_tpu_torch.kernels import attention as K
from demucs_tpu_torch.ops.attention import multihead_attention as port_mha

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(B, Tq, Tk, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, C)).astype(np.float32),
            rng.standard_normal((B, Tk, C)).astype(np.float32),
            rng.standard_normal((B, Tk, C)).astype(np.float32))


def _both_jax(q, k, v, H, mask=None):
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jm = None if mask is None else jnp.asarray(mask)
    dense = np.asarray(multihead_attention(jq, jk, jv, H, mask=jm))
    flash = np.asarray(jax_flash_mha(jq, jk, jv, H, mask=jm, block_q=128, block_k=128,
                                     interpret=True))
    return dense, flash


def _port(q, k, v, H, mask=None):
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    plain = port_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                     mask=tm).numpy()
    wrapped = K.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          H, mask=tm).numpy()
    np.testing.assert_array_equal(wrapped, plain)  # CPU tensors take the plain version
    return plain


@pytest.mark.parametrize(
    "B,Tq,Tk,C,H",
    [
        (2, 256, 256, 64, 4),     # aligned self
        (1, 300, 300, 64, 4),     # ragged self
        (2, 260, 130, 128, 8),    # ragged cross (Tq != Tk)
        (1, 70, 90, 384, 8),      # head dim 48 (bottom_channels=0 at released width)
    ],
)
def test_attention_matches_jax(B, Tq, Tk, C, H):
    q, k, v = _qkv(B, Tq, Tk, C, 0)
    dense, flash = _both_jax(q, k, v, H)
    got = _port(q, k, v, H)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


@pytest.mark.parametrize("mask_type", ["diag", "jmask", "random", "global"])
def test_attention_masks_match_jax(mask_type):
    q, k, v = _qkv(1, 300, 300, 64, 1)
    mask = np.asarray(get_mask(300, 300, mask_type, sparse_attn_window=50,
                               global_window=20, mask_random_seed=42, sparsity=0.9))
    dense, flash = _both_jax(q, k, v, 4, mask)
    got = _port(q, k, v, 4, mask)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


def test_fully_masked_first_block():
    q, k, v = _qkv(1, 256, 256, 64, 2)
    mask = np.ones((256, 256), bool)
    mask[:, :128] = False
    dense, flash = _both_jax(q, k, v, 4, mask)
    got = _port(q, k, v, 4, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flash, **TOL)


def test_fully_masked_row_is_nan():
    """A query row with no kept key gives NaN, as the dense softmax does."""
    q, k, v = _qkv(1, 64, 64, 32, 3)
    mask = np.ones((64, 64), bool)
    mask[5] = False
    dense, _ = _both_jax(q, k, v, 1, mask)
    got = _port(q, k, v, 1, mask)
    assert np.isnan(got[0, 5]).all() and np.isnan(dense[0, 5]).all()
    keep = np.ones(64, bool)
    keep[5] = False
    np.testing.assert_allclose(got[0, keep], dense[0, keep], **TOL)


def test_wrapper_contract_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 64, 4))
    before = K.flash_mha.launches
    K.flash_mha(q, k, v, 2)
    assert K.flash_mha.launches == before  # the plain version launches nothing
    with pytest.raises(NotImplementedError, match="training slice"):
        K.flash_mha(q, k, v, 2, dropout=0.1)
