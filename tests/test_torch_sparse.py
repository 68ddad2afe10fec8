"""The port's sparse attention masks (demucs_tpu_torch.ops.sparse) against
demucs_tpu.ops.sparse on the same inputs.

Static masks: numpy on both sides with the same float32 arithmetic and the
same seeded generator, so they must be bit-equal. LSH masks: the same
projections R on both sides (the JAX draw put into the port); bucket ids may
differ only where the two largest projections of a token lie within 1e-5 of
each other (the einsums sum in another order), and the keep-masks built from
equal buckets must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu.ops import sparse as jsp
from demucs_tpu_torch.ops import sparse as tsp

# (T1 keys, T2 queries): square and both non-square ways, with the windows
# the released HTDemucs uses (500, global 100) and small ones
SHAPES = [(64, 64), (96, 40), (40, 96), (300, 300), (2688, 1344), (1344, 2688)]
ELEMENTARY = ["diag", "jmask", "random", "global"]


@pytest.mark.parametrize("T1,T2", SHAPES)
@pytest.mark.parametrize("kind", ELEMENTARY)
def test_elementary_masks_bit_equal(T1, T2, kind):
    for window, glob in ((500, 100), (7, 5)):
        args = (T1, T2, kind, window, glob, 42, 0.95)
        want = jsp.get_elementary_mask(*args)
        got = tsp.get_elementary_mask(*args)
        assert got.dtype == want.dtype == bool and got.shape == (T2, T1)
        assert np.array_equal(got, want), (kind, window)


@pytest.mark.parametrize("T1,T2", SHAPES)
@pytest.mark.parametrize("mask_type", ["diag_jmask_random", "diag_global", "jmask_global"])
def test_union_masks_bit_equal(T1, T2, mask_type):
    args = (T1, T2, mask_type, 20, 9, 3, 0.9)
    assert np.array_equal(tsp.get_mask(*args), jsp.get_mask(*args))


def test_keep_mask_is_a_cached_uint8_table():
    args = (40, 96, "diag_jmask_random", 7, 5, 42, 0.95)
    with torch.inference_mode():
        got = tsp.keep_mask(*args, device="cpu")
    assert got.dtype == torch.uint8 and got.is_contiguous() and not got.is_inference()
    assert got.shape == (40, 96)
    assert np.array_equal(got.numpy().astype(bool), jsp.get_mask(96, 40, *args[2:]))
    assert tsp.keep_mask(*args, device=torch.device("cpu")) is got  # built once


def test_lsh_projections_are_seeded():
    a, b = tsp.lsh_projections(16, 42), tsp.lsh_projections(16, 42)
    assert a.shape == (16, tsp.N_HASHES, tsp.PROJ_SIZE // 2) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, tsp.lsh_projections(16, 43))


def _near_ties(x, R):
    """Tokens x hash whose two largest of [p, -p] lie within 1e-5."""
    qq = np.einsum("ntf,fhi->nhti", x.astype(np.float64), R.astype(np.float64))
    top2 = np.sort(np.concatenate([qq, -qq], axis=-1), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < 1e-5


@pytest.mark.parametrize("N,T,d", [(6, 50, 8), (16, 300, 64)])
def test_compute_buckets_match_jax(N, T, d):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, T, d)).astype(np.float32)
    R = np.array(jax.random.normal(jax.random.PRNGKey(42), (d, 32, 2), jnp.float32))
    want = np.asarray(jsp.compute_buckets(jnp.asarray(x), jnp.asarray(R)))
    got = tsp.compute_buckets(torch.from_numpy(x), torch.from_numpy(R)).numpy()
    assert got.shape == want.shape == (N, 32, T)
    differ = got != want
    # allowed only at a near tie (none differ in these draws)
    assert not (differ & ~_near_ties(x, R)).any(), f"{differ.sum()} buckets differ"


@pytest.mark.parametrize("B,Tq,Tk,C,H,sparsity", [
    (2, 40, 40, 32, 4, 0.9),  # self-attention: ties at the threshold are common
    (1, 60, 25, 32, 2, 0.8),  # cross, Tq > Tk
    (2, 25, 60, 48, 3, 0.95),  # cross, Tq < Tk, odd head count
])
def test_dynamic_keep_mask_matches_jax(B, Tq, Tk, C, H, sparsity):
    rng = np.random.default_rng(Tq)
    q = rng.standard_normal((B, Tq, C)).astype(np.float32)
    k = q if Tq == Tk else rng.standard_normal((B, Tk, C)).astype(np.float32)
    key = jax.random.PRNGKey(42)
    R = np.array(jax.random.normal(key, (C // H, 32, 2), jnp.float32))
    want = np.asarray(jsp.dynamic_sparse_keep_mask(jnp.asarray(q), jnp.asarray(k), H,
                                                   sparsity, key))
    got = tsp.dynamic_sparse_keep_mask(torch.from_numpy(q), torch.from_numpy(k), H, sparsity,
                                       torch.from_numpy(R)).numpy()
    assert got.shape == want.shape == (B, H, Tq, Tk)
    assert np.array_equal(got, want)
    k_keep = max(1, round((1 - sparsity) * Tk))
    kept = got.sum(-1)
    assert (kept >= k_keep).all() and (kept > k_keep).any()  # ties kept: above the target
    if Tq == Tk:
        assert got[..., np.arange(Tq), np.arange(Tq)].all()  # a key equal to its query
