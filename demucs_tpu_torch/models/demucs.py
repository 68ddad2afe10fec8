"""Demucs (v2): waveform U-Net (port of ``demucs_tpu/models/demucs.py``;
behavioral reference ``demucs/demucs.py:219-447``).

Encoder: Conv1d k=8 s=4, GELU, DConv, then the 1x1 rewrite conv and GLU;
decoder: the context conv and GLU, DConv, ConvTranspose1d, each layer adding
its center-trimmed skip. Around them: the mono mean/std normalization, a
pad to :func:`valid_length`, the sinc resampler x2 on the way in and x1/2 on
the way out (``ops/resample.py``), and an optional BLSTM at the bottom
(``lstm_layers``). The layers are ``nn.Sequential`` s with the reference's
numeric indices (``encoder.0.3.layers.0.4.lstm.weight_ih_l0``); the forward
applies their weights through ``ops.nn``, as the JAX forward does, under
``precision_scope(cfg.matmul_precision)`` (``models/htdemucs.py``). There is
no ``compute_dtype``: the model stays fp32.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
from torch import nn

from demucs_tpu_torch.models import hlayers as hl
from demucs_tpu_torch.models.htdemucs import check_precision, precision_scope
from demucs_tpu_torch.models.initializers import Init
from demucs_tpu_torch.ops import nn as ops
from demucs_tpu_torch.ops.resample import resample_frac


@dataclasses.dataclass(frozen=True)
class DemucsConfig:
    sources: tp.Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 64
    growth: float = 2.0
    depth: int = 6
    rewrite: bool = True
    lstm_layers: int = 0
    kernel_size: int = 8
    stride: int = 4
    context: int = 1
    gelu: bool = True
    glu: bool = True
    norm_starts: int = 4
    norm_groups: int = 4
    dconv_mode: int = 1
    dconv_depth: int = 2
    dconv_comp: float = 4.0
    dconv_attn: int = 4
    dconv_lstm: int = 4
    dconv_init: float = 1e-4
    normalize: bool = True
    resample: bool = True
    rescale: float = 0.1
    samplerate: int = 44100
    segment: float = 40.0
    # The JAX package's matmul precision string (models/htdemucs.py::precision_scope)
    matmul_precision: tp.Optional[str] = None


def valid_length(cfg: DemucsConfig, length: int) -> int:
    """The nearest input length at or above ``length`` for which every
    convolution is whole and the output has the input's length
    (``demucs/demucs.py:376-397``)."""
    if cfg.resample:
        length *= 2
    for _ in range(cfg.depth):
        length = math.ceil((length - cfg.kernel_size) / cfg.stride) + 1
        length = max(1, length)
    for _ in range(cfg.depth):
        length = (length - 1) * cfg.stride + cfg.kernel_size
    if cfg.resample:
        length = math.ceil(length / 2)
    return int(length)


def center_trim(x: torch.Tensor, reference: tp.Union[torch.Tensor, int]) -> torch.Tensor:
    """``x`` cut on its last axis to the length of ``reference``, centered, the
    odd sample off the right (``demucs/utils.py:38-54``)."""
    ref_size = reference if isinstance(reference, int) else reference.shape[-1]
    delta = x.shape[-1] - ref_size
    if delta < 0:
        raise ValueError(f"tensor must be larger than reference. Delta is {delta}.")
    if delta:
        x = x[..., delta // 2 : -(delta - delta // 2)]
    return x


@dataclasses.dataclass(frozen=True)
class _V2Layout:
    enc_dconv: tp.Tuple[tp.Optional[hl.DConvSpec], ...]
    dec_dconv: tp.Tuple[tp.Optional[hl.DConvSpec], ...]
    enc_norm: tp.Tuple[bool, ...]
    channels: tp.Tuple[int, ...]  # per-layer channel counts


def layout(cfg: DemucsConfig) -> _V2Layout:
    enc_dconv, dec_dconv, enc_norm, chans = [], [], [], []
    channels = cfg.channels
    for index in range(cfg.depth):
        spec = hl.DConvSpec(channels=channels, compress=cfg.dconv_comp, depth=cfg.dconv_depth,
                            init=cfg.dconv_init, attn=index >= cfg.dconv_attn,
                            lstm=index >= cfg.dconv_lstm)
        enc_dconv.append(spec if cfg.dconv_mode & 1 else None)
        dec_dconv.append(spec if cfg.dconv_mode & 2 else None)
        enc_norm.append(index >= cfg.norm_starts)
        chans.append(channels)
        channels = int(cfg.growth * channels)
    return _V2Layout(tuple(enc_dconv), tuple(dec_dconv), tuple(enc_norm), tuple(chans))


def convtr_param_names(cfg: DemucsConfig) -> tp.FrozenSet[str]:
    """Dotted names of the decoder's ConvTranspose1d weights, for the SVD
    penalty's ``convtr`` option (``train/svd.py``; the reference checks
    ``isinstance``, svd.py:58-61): ``decoder.{i}.{pos}.weight``, after the
    rewrite conv, its norm and GLU and the DConv where the layer has them."""
    lay = layout(cfg)
    names = []
    for index in range(cfg.depth):
        pos = (3 if cfg.rewrite else 0) + (lay.dec_dconv[index] is not None)
        names.append(f"decoder.{cfg.depth - 1 - index}.{pos}.weight")
    return frozenset(names)


class Demucs(nn.Module):
    """Demucs v2. ``forward(mix (B, C, L)) -> stems (B, S, C, L)``."""

    def __init__(self, cfg: DemucsConfig):
        super().__init__()
        check_precision(cfg.matmul_precision)
        self.cfg = cfg
        lay = layout(cfg)
        self.layout = lay
        ch_scale = 2 if cfg.glu else 1

        def act2() -> nn.Module:
            return nn.GELU() if cfg.gelu else nn.ReLU()

        def activation() -> nn.Module:
            return nn.GLU(1) if cfg.glu else nn.ReLU()

        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        in_channels = cfg.audio_channels
        for index in range(cfg.depth):
            channels = lay.channels[index]

            def norm(dim: int) -> nn.Module:
                return nn.GroupNorm(cfg.norm_groups, dim) if lay.enc_norm[index] else nn.Identity()

            encode = [nn.Conv1d(in_channels, channels, cfg.kernel_size, cfg.stride),
                      norm(channels), act2()]
            if lay.enc_dconv[index] is not None:
                encode.append(hl.DConv(lay.enc_dconv[index]))
            if cfg.rewrite:
                encode += [nn.Conv1d(channels, ch_scale * channels, 1),
                           norm(ch_scale * channels), activation()]
            self.encoder.append(nn.Sequential(*encode))

            out_channels = (lay.channels[index - 1] if index > 0
                            else len(cfg.sources) * cfg.audio_channels)
            decode = []
            if cfg.rewrite:
                decode += [nn.Conv1d(channels, ch_scale * channels, 2 * cfg.context + 1,
                                     padding=cfg.context),
                           norm(ch_scale * channels), activation()]
            if lay.dec_dconv[index] is not None:
                decode.append(hl.DConv(lay.dec_dconv[index]))
            decode.append(nn.ConvTranspose1d(channels, out_channels, cfg.kernel_size,
                                             cfg.stride))
            if index > 0:
                decode += [norm(out_channels), act2()]
            self.decoder.insert(0, nn.Sequential(*decode))
            in_channels = channels
        if cfg.lstm_layers:
            self.lstm = hl.BLSTM(lay.channels[-1], cfg.lstm_layers)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with precision_scope(self.cfg.matmul_precision):
            return self._forward(mix)

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lay = self.layout
        x = mix
        length = x.shape[-1]
        if cfg.normalize:
            mono = mix.mean(dim=1, keepdim=True)
            mean = mono.mean(dim=-1, keepdim=True)
            std = ops.std_unbiased(mono, axis=-1)
            x = (x - mean) / (1e-5 + std)
        delta = valid_length(cfg, length) - length
        x = nn.functional.pad(x, (delta // 2, delta - delta // 2))
        if cfg.resample:
            x = resample_frac(x, 1, 2)

        act2 = ops.gelu if cfg.gelu else torch.relu

        def activation(v: torch.Tensor) -> torch.Tensor:
            return ops.glu(v, axis=1) if cfg.glu else torch.relu(v)

        def norm(mod: nn.Module, v: torch.Tensor) -> torch.Tensor:
            if isinstance(mod, nn.Identity):
                return v
            return ops.group_norm(v, cfg.norm_groups, mod.weight, mod.bias)

        saved = []
        for index, layer in enumerate(self.encoder):
            x = ops.conv1d(x, layer[0].weight, layer[0].bias, stride=cfg.stride)
            x = act2(norm(layer[1], x))
            pos = 3
            if lay.enc_dconv[index] is not None:
                x = layer[pos](x)
                pos += 1
            if cfg.rewrite:
                x = ops.conv1d(x, layer[pos].weight, layer[pos].bias)
                x = activation(norm(layer[pos + 1], x))
            saved.append(x)

        if cfg.lstm_layers:
            x = self.lstm(x)

        for idx, layer in enumerate(self.decoder):
            index = cfg.depth - 1 - idx  # decoder[idx] was built at `index`
            x = x + center_trim(saved.pop(-1), x)
            pos = 0
            if cfg.rewrite:
                x = ops.conv1d(x, layer[0].weight, layer[0].bias, padding=cfg.context)
                x = activation(norm(layer[1], x))
                pos = 3
            if lay.dec_dconv[index] is not None:
                x = layer[pos](x)
                pos += 1
            x = ops.conv_transpose1d(x, layer[pos].weight, layer[pos].bias, stride=cfg.stride)
            if index > 0:
                x = act2(norm(layer[pos + 1], x))

        if cfg.resample:
            x = resample_frac(x, 2, 1)
        if cfg.normalize:
            x = x * std + mean
        x = center_trim(x, length)
        return x.reshape(x.shape[0], len(cfg.sources), cfg.audio_channels, x.shape[-1])


def init_demucs(cfg: DemucsConfig, seed: int = 0, layer_scale: tp.Optional[float] = None,
                random_norms: bool = False) -> Demucs:
    """Random weights equal to ``demucs_tpu.models.demucs.init_demucs(cfg,
    seed)``: its draws go encoder layer ``i``, then the decoder layer built
    with it (``decoder[depth - 1 - i]``), then the bottom BLSTM.
    ``layer_scale`` and ``random_norms`` as in ``init_hdemucs``."""
    model = Demucs(cfg)
    init = Init(seed)
    with torch.no_grad():
        for index in range(cfg.depth):
            init.module(model.encoder[index], cfg.rescale)
            init.module(model.decoder[cfg.depth - 1 - index], cfg.rescale)
        if cfg.lstm_layers:
            init.module(model.lstm, None)
        init.finish(model, layer_scale, random_norms)
    return model
