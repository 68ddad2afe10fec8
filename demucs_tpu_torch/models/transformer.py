"""Cross-domain transformer (port of ``demucs_tpu/models/transformer.py``).

Two token streams — spectrogram tokens (the flattened ``(t, f)`` grid with a
2-D sinusoid embedding) and waveform tokens (1-D sinusoid, CAPE or a learned
scaled embedding) — go through alternating self-attention layers (each
domain on its own) and cross-attention layers (each domain queries the
other), per the reference's ``demucs/transformer.py:526-719``.

Every attention runs through kernel K3 (``demucs_tpu_torch.kernels.attention``):
the CUDA kernel on the card (its fp32 or its bf16 route, by the dtype of the
transformer stage), its plain version on the CPU. The static sparse variants
(``sparse_self_attn`` / ``sparse_cross_attn``) hand K3 their ``(Tq, Tk)``
keep-mask (``ops/sparse.py``), cached on the device. The LSH variant
(``auto_sparsity``) builds a keep-mask per (batch, head), which K3 does not
take (its mask is shared by batch and heads, as the Pallas kernel's is): its
layers take the dense route, ``ops/attention.py::multihead_attention``, which
is the JAX package's own route for that mask (``transformer.py:209-220``).
The positional embeddings are cached in fp32 on the device and cast to the
tokens' dtype where they are added. The attention
module owns ``in_proj_weight``, ``in_proj_bias`` and ``out_proj`` under the
names of ``nn.MultiheadAttention`` (so checkpoints load unchanged) but never
calls it, nor ``scaled_dot_product_attention``. Norms and linear maps keep
their weights in ``torch.nn`` modules and apply them through
``demucs_tpu_torch.ops.nn``.

Train mode (``module.train()``, a ``generator`` passed to ``forward``), as
the JAX package at ``train=True``: dropout at ``spec.dropout`` on the
attention probabilities (K3's hashed dropout on either route, fp32 or the
bf16 of a bf16 stage, seeded by a host int drawn per attention; none on the
LSH layers, as in the reference), after the attention
(``dropout1``; the sparse layers also after the out-projection, the
reference's ``proj_drop``), inside the feed-forward and after it
(``dropout2``); ``sin_random_shift``'s shift and CAPE's augment drawn per
forward. Every draw comes from the ``generator`` passed in (a CPU
``torch.Generator``), never from the global RNG; training with a draw to
make and no generator raises. In eval mode nothing is drawn: shift 0, no
augment, no dropout.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
from torch import nn

from demucs_tpu_torch.kernels import device_cache
from demucs_tpu_torch.kernels.attention import flash_mha
from demucs_tpu_torch.models.hlayers import LayerScale, scalar
from demucs_tpu_torch.ops import nn as ops
from demucs_tpu_torch.ops.attention import apply_dropout, multihead_attention
from demucs_tpu_torch.ops.sparse import dynamic_sparse_keep_mask, keep_mask, lsh_projections


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    dim: int
    num_layers: int = 5
    num_heads: int = 8
    hidden_scale: float = 4.0
    cross_first: bool = False
    emb: str = "sin"  # "sin" | "cape" | "scaled"
    norm_in: bool = True
    norm_in_group: bool = False
    norm_first: bool = True
    norm_out: bool = True
    max_period: float = 10000.0
    layer_scale: bool = True
    gelu: bool = True
    weight_pos_embed: float = 1.0
    sin_random_shift: int = 0  # train-time draw of the shift: 0 at eval
    cape_mean_normalize: bool = True
    cape_augment: bool = True  # train-time draws: no augment at eval
    cape_glob_loc_scale: tp.Tuple[float, float, float] = (5000.0, 1.0, 1.4)
    sparse_self_attn: bool = False
    sparse_cross_attn: bool = False
    mask_type: str = "diag"
    mask_random_seed: int = 42
    sparse_attn_window: int = 500
    global_window: int = 50
    sparsity: float = 0.95
    auto_sparsity: bool = False
    dropout: float = 0.0  # train-time dropout (attention probabilities and blocks)

    def mask(self, Tq: int, Tk: int, device) -> torch.Tensor:
        """The static sparse keep-mask ``(Tq, Tk)``, uint8, cached on ``device``."""
        return keep_mask(Tq, Tk, self.mask_type, self.sparse_attn_window, self.global_window,
                         self.mask_random_seed, self.sparsity, device)

    @property
    def hidden_dim(self) -> int:
        return int(self.dim * self.hidden_scale)

    @property
    def classic_parity(self) -> int:
        return 1 if self.cross_first else 0


# ---------------------------------------------------------------------------
# Positional embeddings (transformer.py:19-70), built in numpy once per shape
# and device and cached on the device: the forward copies nothing from the
# host, which a CUDA graph's capture would refuse.
# ---------------------------------------------------------------------------


@device_cache(maxsize=16)
def _sin_embedding(length: int, dim: int, shift: int, max_period: float,
                   device) -> torch.Tensor:
    assert dim % 2 == 0
    pos = shift + np.arange(length, dtype=np.float64)[:, None]
    half_dim = dim // 2
    adim = np.arange(half_dim, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (half_dim - 1)))
    emb = np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)
    return torch.from_numpy(emb).to(device)


def sin_embedding(length: int, dim: int, shift: int = 0, max_period: float = 10000.0,
                  device=None) -> torch.Tensor:
    """1-D sinusoid embedding ``(length, dim)``, cached: do not write to it."""
    return _sin_embedding(length, dim, shift, max_period, device)


@device_cache(maxsize=16)
def _sin_embedding_2d(d_model: int, height: int, width: int, max_period: float,
                      device) -> torch.Tensor:
    if d_model % 4 != 0:
        raise ValueError("2-D sin embedding requires dim % 4 == 0")
    pe = np.zeros((d_model, height, width), dtype=np.float64)
    half = d_model // 2
    div_term = np.exp(np.arange(0, half, 2, dtype=np.float64) * -(math.log(max_period) / half))
    pos_w = np.arange(width, dtype=np.float64)[:, None]
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def sin_embedding_2d(d_model: int, height: int, width: int, max_period: float = 10000.0,
                     device=None) -> torch.Tensor:
    """2-D sinusoid embedding ``(d_model, height, width)``, cached: do not write to it."""
    return _sin_embedding_2d(d_model, height, width, max_period, device)


@device_cache(maxsize=16)
def _cape_embedding(length: int, dim: int, mean_normalize: bool, max_period: float,
                    device) -> torch.Tensor:
    assert dim % 2 == 0
    # float32 throughout, as the JAX package computes it
    pos = np.arange(length, dtype=np.float32)[:, None]
    if mean_normalize:
        pos = pos - pos.mean(axis=0, keepdims=True)
    half_dim = dim // 2
    adim = np.arange(half_dim, dtype=np.float32)[None, :]
    phase = pos / (np.float32(max_period) ** (adim / np.float32(half_dim - 1)))
    emb = np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)
    return torch.from_numpy(emb).to(device)


def cape_embedding(length: int, dim: int, mean_normalize: bool = True,
                   max_period: float = 10000.0, device=None) -> torch.Tensor:
    """CAPE positional embedding ``(length, dim)`` at eval (transformer.py:73-115
    with no augment: the same for every batch item), cached: do not write to it."""
    return _cape_embedding(length, dim, mean_normalize, max_period, device)


def cape_draws(length: int, batch: int, glob_loc_scale: tp.Sequence[float],
               generator: torch.Generator) -> tuple:
    """CAPE's train-time draws, fp32 on the CPU: the global shift ``(1, B,
    1)``, the local shifts ``(length, B, 1)`` and the log-scales ``(1, B, 1)``,
    uniform in +-(global, local, log scale) (the JAX package's three
    ``jax.random.uniform`` draws)."""
    glob, loc, scale = glob_loc_scale

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return (uniform((1, batch, 1), glob), uniform((length, batch, 1), loc),
            uniform((1, batch, 1), math.log(scale)))


def cape_embedding_augmented(length: int, dim: int, draws: tuple, mean_normalize: bool = True,
                             max_period: float = 10000.0, device=None) -> torch.Tensor:
    """CAPE at training (transformer.py:73-115): positions shifted by
    ``draws`` (:func:`cape_draws`) and scaled, per batch item -> ``(B,
    length, dim)`` on ``device``."""
    delta, delta_local, log_lambdas = (d.to(device=device, dtype=torch.float32) for d in draws)
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None, None]
    if mean_normalize:
        pos = pos - pos.mean(dim=0, keepdim=True)
    pos = (pos + delta + delta_local) * torch.exp(log_lambdas)
    half_dim = dim // 2
    adim = torch.arange(half_dim, dtype=torch.float32, device=device)[None, None, :]
    phase = pos / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1).transpose(0, 1)


def _need(generator: tp.Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"training the transformer with {what} needs a generator: pass "
                         "generator= to forward")
    return generator


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class MyGroupNorm(nn.GroupNorm):
    """GroupNorm over ``(B, T, C)`` tokens: normalizes all of T and C per item."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.group_norm(x.transpose(1, 2), self.num_groups, self.weight, self.bias)
        return y.transpose(1, 2)


def _layer_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``norm``'s weights applied through ``ops.nn`` (a MyGroupNorm does so itself)."""
    if isinstance(norm, nn.LayerNorm):
        return ops.layer_norm(x, norm.weight, norm.bias)
    return norm(x)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return ops.linear(x, lin.weight, lin.bias)


class Attention(nn.Module):
    """Multi-head attention with packed input projection, batch-first, on K3."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: tp.Optional[torch.Tensor] = None, lsh_sparsity: float = 0.0,
                lsh_R: tp.Optional[torch.Tensor] = None, dropout: float = 0.0,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """``mask``: a static ``(Tq, Tk)`` keep-mask for K3. ``lsh_sparsity`` > 0:
        the LSH keep-mask of the projected q and k under projections
        ``lsh_R``, on the dense route (K3 takes no per-(batch, head) mask).
        ``dropout`` > 0 (training): K3's dropout of the probabilities under a
        seed drawn from ``generator`` (not on the LSH route, as in the
        reference), and a masked layer's dropout after the out-projection."""
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        qh, kh, vh = (ops.linear(q, w_q, b_q), ops.linear(k, w_k, b_k),
                      ops.linear(v, w_v, b_v))
        if lsh_sparsity:
            keep = dynamic_sparse_keep_mask(qh, kh, self.num_heads, lsh_sparsity, lsh_R)
            out = multihead_attention(qh, kh, vh, self.num_heads, mask=keep)
        else:
            drop = {}
            if dropout > 0.0:
                drop = dict(dropout=dropout,
                            dropout_seed=int(torch.randint(0, 2**31 - 1, (), generator=generator)))
            out = flash_mha(qh, kh, vh, self.num_heads, mask=mask, **drop)
        out = _linear(self.out_proj, out)
        if mask is not None or lsh_sparsity:  # the sparse attention's proj_drop
            out = apply_dropout(out, dropout, generator)
        return out


class _Layer(nn.Module):
    """Shared parts of the self and cross layers: feed-forward, norms, scales."""

    def __init__(self, s: TransformerSpec, cross: bool):
        super().__init__()
        self.spec = s
        sparse = s.sparse_cross_attn if cross else s.sparse_self_attn
        # the JAX package's rule (transformer.py:266, :299): LSH where
        # auto_sparsity is on with a nonzero sparsity, else the static mask
        self.lsh_sparsity = s.sparsity if (s.auto_sparsity and sparse) else 0.0
        self.static_mask = sparse and not self.lsh_sparsity
        attn = Attention(s.dim, s.num_heads)
        if cross:
            self.cross_attn = attn
        else:
            self.self_attn = attn
        self.linear1 = nn.Linear(s.dim, s.hidden_dim)
        self.linear2 = nn.Linear(s.hidden_dim, s.dim)
        self.norm1 = nn.LayerNorm(s.dim)
        self.norm2 = nn.LayerNorm(s.dim)
        if cross:
            self.norm3 = nn.LayerNorm(s.dim)
        if s.norm_first and s.norm_out:
            self.norm_out = MyGroupNorm(1, s.dim)
        if s.layer_scale:
            self.gamma_1 = LayerScale(s.dim, 1e-4, channel_last=True)
            self.gamma_2 = LayerScale(s.dim, 1e-4, channel_last=True)

    def _gamma(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.spec.layer_scale else x

    def _drop(self, x: torch.Tensor, generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        return apply_dropout(x, self._rate(generator), generator)

    def _rate(self, generator: tp.Optional[torch.Generator]) -> float:
        """The dropout rate of this forward: the spec's in train mode, else 0."""
        if not (self.training and self.spec.dropout > 0.0):
            return 0.0
        _need(generator, "dropout")
        return self.spec.dropout

    def _ff(self, x: torch.Tensor, generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        """linear2(dropout(act(linear1(x)))), then dropout2."""
        act = ops.gelu if self.spec.gelu else torch.relu
        y = self._drop(act(_linear(self.linear1, x)), generator)
        return self._drop(_linear(self.linear2, y), generator)

    def _attend(self, attn: Attention, q: torch.Tensor, k: torch.Tensor,
                lsh_R: tp.Optional[torch.Tensor],
                generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        """The attention, then dropout1."""
        mask = (self.spec.mask(q.shape[1], k.shape[1], q.device) if self.static_mask
                else None)
        out = attn(q, k, k, mask=mask, lsh_sparsity=self.lsh_sparsity, lsh_R=lsh_R,
                   dropout=self._rate(generator), generator=generator)
        return self._drop(out, generator)


class SelfLayer(_Layer):
    """MyTransformerEncoderLayer (transformer.py:339-377)."""

    def __init__(self, s: TransformerSpec):
        super().__init__(s, cross=False)

    def forward(self, x: torch.Tensor, lsh_R: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        s, gen = self.spec, generator
        if s.norm_first:
            y = _layer_norm(self.norm1, x)
            x = x + self._gamma("gamma_1", self._attend(self.self_attn, y, y, lsh_R, gen))
            x = x + self._gamma("gamma_2", self._ff(_layer_norm(self.norm2, x), gen))
            if s.norm_out:
                x = self.norm_out(x)
            return x
        x = _layer_norm(self.norm1, x + self._gamma(
            "gamma_1", self._attend(self.self_attn, x, x, lsh_R, gen)))
        return _layer_norm(self.norm2, x + self._gamma("gamma_2", self._ff(x, gen)))


class CrossLayer(_Layer):
    """CrossTransformerEncoderLayer (transformer.py:466-512)."""

    def __init__(self, s: TransformerSpec):
        super().__init__(s, cross=True)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                lsh_R: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        s, gen = self.spec, generator
        if s.norm_first:
            kn = _layer_norm(self.norm2, k)
            x = q + self._gamma("gamma_1", self._attend(
                self.cross_attn, _layer_norm(self.norm1, q), kn, lsh_R, gen))
            x = x + self._gamma("gamma_2", self._ff(_layer_norm(self.norm3, x), gen))
            if s.norm_out:
                x = self.norm_out(x)
            return x
        x = _layer_norm(self.norm1, q + self._gamma(
            "gamma_1", self._attend(self.cross_attn, q, k, lsh_R, gen)))
        return _layer_norm(self.norm2, x + self._gamma("gamma_2", self._ff(x, gen)))


class CrossTransformerEncoder(nn.Module):
    """CrossTransformerEncoder (transformer.py:648-676)."""

    def __init__(self, s: TransformerSpec):
        super().__init__()
        if s.emb not in ("sin", "cape", "scaled"):
            raise ValueError(f"unknown transformer embedding {s.emb}")
        self.spec = s
        if s.auto_sparsity:
            # The LSH projections, one draw for every layer as in the JAX
            # package, kept as the fp32 words' bits: an int buffer moves with
            # .to(device) and is left alone by .to(bfloat16), and the hashing
            # is fp32 whatever the stage's dtype.
            R = lsh_projections(s.dim // s.num_heads, s.mask_random_seed)
            self.register_buffer("lsh_bits", R.view(torch.int32), persistent=False)
        if s.norm_in:
            self.norm_in = nn.LayerNorm(s.dim)
            self.norm_in_t = nn.LayerNorm(s.dim)
        elif s.norm_in_group:
            self.norm_in = MyGroupNorm(1, s.dim)
            self.norm_in_t = MyGroupNorm(1, s.dim)
        if s.emb == "scaled":
            from demucs_tpu_torch.models.hlayers import ScaledEmbedding

            self.position_embeddings = ScaledEmbedding(10000, s.dim, scale=0.2 / 3.0)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for idx in range(s.num_layers):
            kind = SelfLayer if idx % 2 == s.classic_parity else CrossLayer
            self.layers.append(kind(s))
            self.layers_t.append(kind(s))

    @property
    def lsh_projections(self) -> tp.Optional[torch.Tensor]:
        """The LSH projections ``(head_dim, 32, 2)``, fp32 (None without LSH);
        ``set_lsh_projections`` replaces them."""
        bits = getattr(self, "lsh_bits", None)
        return None if bits is None else bits.view(torch.float32)

    def set_lsh_projections(self, R) -> None:
        """Replace the LSH projections by ``R`` (a tensor or array of their shape)."""
        R = torch.as_tensor(R, dtype=torch.float32).contiguous()
        if self.lsh_projections is None or R.shape != self.lsh_projections.shape:
            raise ValueError(f"LSH projections of shape {tuple(R.shape)} do not fit this "
                             "transformer")
        self.lsh_bits.copy_(R.view(torch.int32))

    def forward(self, x: torch.Tensor, xt: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """``x (B, C, Fr, T1)`` spectrogram branch, ``xt (B, C, T2)`` waveform
        branch; ``generator``: the train mode's draws (module docstring)."""
        s = self.spec
        B, C, Fr, T1 = x.shape
        pos2d = sin_embedding_2d(C, Fr, T1, s.max_period, device=x.device)
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)  # b c fr t1 -> b (t1 fr) c
        pos2d = pos2d.permute(2, 1, 0).reshape(1, T1 * Fr, C)
        if s.norm_in or s.norm_in_group:
            x = _layer_norm(self.norm_in, x)
        x = x + scalar(s.weight_pos_embed, x.dtype) * pos2d.to(x.dtype)

        T2 = xt.shape[-1]
        xt = xt.transpose(1, 2)  # (B, T2, C)
        if s.emb == "sin":
            shift = 0  # transformer.py:635: a random shift at training only
            if self.training and s.sin_random_shift:
                shift = int(torch.randint(0, s.sin_random_shift + 1, (),
                                          generator=_need(generator, "sin_random_shift")))
            pos_emb = sin_embedding(T2, C, shift, s.max_period, device=xt.device)[None]
        elif s.emb == "cape" and self.training and s.cape_augment:
            draws = cape_draws(T2, B, s.cape_glob_loc_scale, _need(generator, "CAPE's augment"))
            pos_emb = cape_embedding_augmented(T2, C, draws, s.cape_mean_normalize,
                                               s.max_period, device=xt.device)
        elif s.emb == "cape":
            pos_emb = cape_embedding(T2, C, s.cape_mean_normalize, s.max_period,
                                     device=xt.device)[None]
        else:
            pos_emb = (self.position_embeddings.embedding.weight[:T2] * 3.0)[None]
        if s.norm_in or s.norm_in_group:
            xt = _layer_norm(self.norm_in_t, xt)
        xt = xt + scalar(s.weight_pos_embed, xt.dtype) * pos_emb.to(xt.dtype)

        R = self.lsh_projections
        gen = generator
        for idx in range(s.num_layers):
            if idx % 2 == s.classic_parity:
                x = self.layers[idx](x, lsh_R=R, generator=gen)
                xt = self.layers_t[idx](xt, lsh_R=R, generator=gen)
            else:
                old_x = x
                x = self.layers[idx](x, xt, lsh_R=R, generator=gen)
                xt = self.layers_t[idx](xt, old_x, lsh_R=R, generator=gen)

        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)
