"""Sparse attention masks for HTDemucs's sparse variants (port of
``demucs_tpu/ops/sparse.py``).

Behavioral reference: ``demucs/transformer.py:118-212`` (static masks) and
``:818-839`` (LSH dynamic sparsity).

- Static masks: elementary keep-masks (``diag`` band, ``jmask``
  triangular-number offsets, seeded ``random`` Bernoulli, ``global`` first
  rows and columns), joined with ``_`` into their union ("diag_jmask_random").
  They are built in numpy with the JAX package's arithmetic (float32 at the
  integer boundaries, ``np.random.default_rng`` for ``random``), so they are
  bit-equal to its masks. :func:`keep_mask` caches each one on the device as
  a contiguous ``uint8`` tensor (K3's backward reads it) and, on the card,
  builds K3's tile maps and packed bits beside it from the same array
  (``kernels/attention.py`` ``register_mask_tiles``), so no launch builds
  them, inside a CUDA graph's capture or out.
- LSH masks (``t_auto_sparsity``): tokens hashed into buckets by random
  projections, keys kept per query where their buckets collide most. The
  mask is per (batch, head), so the layer takes the dense route with it, as
  the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from demucs_tpu_torch.kernels import device_cache
from demucs_tpu_torch.kernels.attention import register_mask_tiles

__all__ = ["get_elementary_mask", "get_mask", "keep_mask", "lsh_projections",
           "compute_buckets", "dynamic_sparse_keep_mask", "N_HASHES", "PROJ_SIZE"]

N_HASHES = 32  # hash rounds of the LSH masks
PROJ_SIZE = 4  # buckets per round: two projections, argmax over [p, -p]


def get_elementary_mask(T1: int, T2: int, mask_type: str, sparse_attn_window: int,
                        global_window: int, mask_random_seed: int,
                        sparsity: float) -> np.ndarray:
    """Boolean keep-mask of shape ``(T2, T1)`` (transformer.py:123-175)."""
    assert mask_type in ("diag", "jmask", "random", "global")

    if mask_type == "global":
        mask = np.zeros((T2, T1), dtype=bool)
        mask[:, :global_window] = True
        line_window = int(global_window * T2 / T1)
        mask[:line_window, :] = True
        return mask

    if mask_type == "diag":
        mask = np.zeros((T2, T1), dtype=bool)
        rows = np.arange(T2, dtype=np.float32)[:, None]
        # float32 arithmetic matches torch's default dtype at integer boundaries
        cols = (np.float32(T1 / T2) * rows
                + np.arange(-sparse_attn_window, sparse_attn_window + 1, dtype=np.float32))
        cols = np.clip(cols.astype(np.int64), 0, T1 - 1)
        np.put_along_axis(mask, cols, True, axis=1)
        return mask

    if mask_type == "jmask":
        mask = np.zeros((T2 + 2, T1 + 2), dtype=bool)
        rows = np.arange(T2 + 2, dtype=np.float32)[:, None]
        t = np.arange(0, int((2 * T1) ** 0.5 + 1))
        t = (t * (t + 1) / 2).astype(np.int64)
        t = np.concatenate([-t[::-1][:-1], t]).astype(np.float32)
        cols = np.clip((np.float32(T1 / T2) * rows + t).astype(np.int64), 0, T1 + 1)
        np.put_along_axis(mask, cols, True, axis=1)
        return mask[1:-1, 1:-1]

    # "random": a seeded Bernoulli draw of keep probability 1 - sparsity, from
    # numpy's generator as in the JAX package (the reference's torch draw has
    # the same distribution, not the same realization)
    rng = np.random.default_rng(mask_random_seed)
    return rng.random((T2, T1)) > sparsity


@functools.lru_cache(maxsize=32)
def get_mask(T1: int, T2: int, mask_type: str, sparse_attn_window: int,
             global_window: int, mask_random_seed: int, sparsity: float) -> np.ndarray:
    """Union of the ``_``-separated elementary masks (transformer.py:178-212):
    a boolean keep-mask ``(T2, T1)``, cached: do not write to it."""
    masks = [
        get_elementary_mask(T1, T2, kind, sparse_attn_window, global_window,
                            mask_random_seed, sparsity)
        for kind in mask_type.split("_")
    ]
    return np.stack(masks).sum(axis=0) > 0


@device_cache(maxsize=32)
def _keep_mask(Tq: int, Tk: int, mask_type: str, sparse_attn_window: int,
               global_window: int, mask_random_seed: int, sparsity: float,
               device) -> torch.Tensor:
    mask = get_mask(Tk, Tq, mask_type, sparse_attn_window, global_window,
                    mask_random_seed, sparsity)
    table = torch.from_numpy(mask.astype(np.uint8)).to(device).contiguous()
    if table.device.type != "cpu":  # the CPU takes the plain version, which reads the table
        register_mask_tiles(table, mask)
    return table


def keep_mask(Tq: int, Tk: int, mask_type: str, sparse_attn_window: int,
              global_window: int, mask_random_seed: int, sparsity: float,
              device=None) -> torch.Tensor:
    """:func:`get_mask` for ``Tq`` queries over ``Tk`` keys as a contiguous
    ``uint8`` ``(Tq, Tk)`` tensor on ``device``, built once per shape, options
    and device with K3's tile maps beside it on the card (outside inference
    mode; the first call of a shape must not be inside a CUDA graph's
    capture), cached: do not write to it."""
    return _keep_mask(Tq, Tk, mask_type, sparse_attn_window, global_window,
                      mask_random_seed, sparsity, torch.device(device or "cpu"))


def lsh_projections(head_dim: int, seed: int) -> torch.Tensor:
    """The LSH variant's Gaussian projections ``(head_dim, N_HASHES,
    PROJ_SIZE // 2)``, fp32, drawn on the CPU from a ``torch.Generator``
    seeded with ``seed``. The JAX package draws them with
    ``jax.random.normal(PRNGKey(seed))`` and the reference from torch's global
    generator on every forward: three realizations of one distribution."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(head_dim, N_HASHES, PROJ_SIZE // 2, generator=gen)


def compute_buckets(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """LSH bucket ids of per-head tokens (transformer.py:818-824).

    ``x (N, T, d)`` (N = batch x heads), ``R (d, n_hashes, proj_size // 2)``
    shared by all N -> int64 ``(N, n_hashes, T)`` in ``[0, proj_size)``.
    """
    qq = torch.einsum("ntf,fhi->nhti", x, R)
    return torch.cat([qq, -qq], dim=-1).argmax(dim=-1)


def dynamic_sparse_keep_mask(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                             sparsity: float, R: torch.Tensor) -> torch.Tensor:
    """Boolean keep-mask ``(B, H, Tq, Tk)`` from LSH bucket collisions.

    ``q (B, Tq, C)`` and ``k (B, Tk, C)`` are the projected tokens. Per query
    row, the keys whose collision count over the hash rounds reaches the
    ``max(1, round((1 - sparsity) Tk))``-th largest are kept, ties at the
    threshold included, as the JAX package keeps them. A key equal to its
    query collides in every round, so self-attention keeps the diagonal.
    """
    B, Tq, C = q.shape
    Tk = k.shape[1]
    d = C // num_heads
    proj_size = 2 * R.shape[-1]

    def fold(x: torch.Tensor, T: int) -> torch.Tensor:
        xh = x.reshape(B, T, num_heads, d).permute(0, 2, 1, 3)
        return xh.reshape(B * num_heads, T, d).float()

    R = R.float()
    codes = torch.arange(proj_size, device=q.device)

    def one_hot(x: torch.Tensor, T: int) -> torch.Tensor:
        """(N, T, n_hashes x proj_size) one-hot bucket codes of each token."""
        buckets = compute_buckets(fold(x, T), R)  # (N, n_hashes, T)
        hot = buckets.unsqueeze(-1) == codes
        return hot.permute(0, 2, 1, 3).reshape(B * num_heads, T, -1).float()

    # collision counts: integers <= n_hashes, exact in fp32 (and in bf16, where
    # the JAX package counts); the hash rounds and buckets are one contraction
    counts = one_hot(q, Tq) @ one_hot(k, Tk).transpose(1, 2)
    k_keep = max(1, int(round((1.0 - sparsity) * Tk)))
    thresh = counts.topk(k_keep, dim=-1).values[..., -1:]
    return (counts >= thresh).reshape(B, num_heads, Tq, Tk)
