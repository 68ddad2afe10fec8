"""HDemucs (v3): hybrid spectrogram and waveform U-Net
(port of ``demucs_tpu/models/hdemucs.py``; behavioral reference
``demucs/hdemucs.py:338-794``).

``HDemucsConfig`` is a copy of the JAX package's dataclass, fields and
defaults. Against HTDemucs: depth 6, the branches merge by injection at the
layer where the frequency axis is used up and split again through the
decoder's ``pre`` output, the decoders start from zeros (the signal flows
through the skips), the DConv branches gain a BLSTM and LocalState from
``dconv_lstm``/``dconv_attn`` on, and no training segment. Options:
``hybrid_old`` (the MDX-era padding), ``hybrid=False`` (the plain STFT
without its Nyquist row), ``cac=False`` (magnitude masks with Wiener EM or,
with ``wiener_iters < 0``, the mixture's phase) and ``multi_freqs``
(MultiWrap).

The forward runs under ``precision_scope(cfg.matmul_precision)``
(``models/htdemucs.py``; ``None``, the default, is full fp32 with TF32 off
for cuDNN convolutions and RNNs and for cuBLAS), the spectrogram (K1, K2)
and Wiener filtering in full fp32 outside it. There is no ``compute_dtype``:
the model stays fp32, its BLSTM included.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from demucs_tpu_torch.models import hlayers as hl
from demucs_tpu_torch.models.htdemucs import check_precision, precision_scope
from demucs_tpu_torch.models.initializers import Init
from demucs_tpu_torch.ops import nn as ops
from demucs_tpu_torch.ops.spec import cac_pack, cac_unpack, demucs_ispec, demucs_spec, istft, stft
from demucs_tpu_torch.ops.wiener import magnitude_output


@dataclasses.dataclass(frozen=True)
class HDemucsConfig:
    sources: tp.Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 48
    channels_time: tp.Optional[int] = None
    growth: int = 2
    # STFT
    nfft: int = 4096
    wiener_iters: int = 0
    end_iters: int = 0
    wiener_residual: bool = False
    cac: bool = True
    # Main structure
    depth: int = 6
    rewrite: bool = True
    hybrid: bool = True
    hybrid_old: bool = False
    # Frequency branch
    multi_freqs: tp.Tuple[float, ...] = ()
    multi_freqs_depth: int = 2
    freq_emb: float = 0.2
    emb_scale: float = 10.0
    emb_smooth: bool = True
    # Convolutions
    kernel_size: int = 8
    time_stride: int = 2
    stride: int = 4
    context: int = 1
    context_enc: int = 0
    # Normalization
    norm_starts: int = 4
    norm_groups: int = 4
    # DConv residual branch
    dconv_mode: int = 1
    dconv_depth: int = 2
    dconv_comp: float = 4.0
    dconv_attn: int = 4
    dconv_lstm: int = 4
    dconv_init: float = 1e-4
    # Weight init
    rescale: float = 0.1
    # Metadata
    samplerate: int = 44100
    segment: float = 40.0
    # The JAX package's matmul precision string (models/htdemucs.py::precision_scope)
    matmul_precision: tp.Optional[str] = None

    @property
    def hop_length(self) -> int:
        return self.nfft // 4


def layout(cfg: HDemucsConfig) -> hl.HybridLayout:
    return hl.build_hybrid_layout(
        sources=cfg.sources, audio_channels=cfg.audio_channels, channels=cfg.channels,
        channels_time=cfg.channels_time, growth=cfg.growth, nfft=cfg.nfft, cac=cfg.cac,
        depth=cfg.depth, rewrite=cfg.rewrite, kernel_size=cfg.kernel_size,
        time_stride=cfg.time_stride, stride=cfg.stride, context=cfg.context,
        context_enc=cfg.context_enc, norm_starts=cfg.norm_starts,
        norm_groups=cfg.norm_groups, dconv_mode=cfg.dconv_mode,
        dconv_depth=cfg.dconv_depth, dconv_comp=cfg.dconv_comp,
        dconv_init=cfg.dconv_init, dconv_lstm_start=cfg.dconv_lstm,
        dconv_attn_start=cfg.dconv_attn, freq_emb=cfg.freq_emb, hybrid=cfg.hybrid,
        multi_freqs=cfg.multi_freqs, multi_freqs_depth=cfg.multi_freqs_depth)


class HDemucs(nn.Module):
    """HDemucs. ``forward(mix (B, C, L)) -> stems (B, S, C, L)``.

    Submodules are registered in the reference's order (encoder, decoder,
    tencoder, tdecoder, freq_emb): diffq's quantized states list their
    tensors in that order without names (``zoo/diffq.py``)."""

    def __init__(self, cfg: HDemucsConfig):
        super().__init__()
        check_precision(cfg.matmul_precision)
        self.cfg = cfg
        lay = layout(cfg)
        self.layout = lay
        self.encoder = nn.ModuleList(hl.enc_layer(s) for s in lay.enc)
        self.decoder = nn.ModuleList(hl.dec_layer(s) for s in lay.dec)
        self.tencoder = nn.ModuleList(hl.HEncLayer(s) for s in lay.tenc)
        self.tdecoder = nn.ModuleList(hl.HDecLayer(s) for s in lay.tdec)
        if lay.freq_emb_bins:
            self.freq_emb = hl.ScaledEmbedding(lay.freq_emb_bins, lay.freq_emb_dim,
                                               scale=cfg.emb_scale)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with precision_scope(self.cfg.matmul_precision):
            return self._forward(mix)

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        length = mix.shape[-1]
        with precision_scope(None):
            if cfg.hybrid:
                z = demucs_spec(mix, cfg.nfft, hybrid_old=cfg.hybrid_old)
            else:
                z = stft(mix, cfg.nfft, cfg.hop_length)[..., :-1, :]
        x = cac_pack(z) if cfg.cac else z.abs()
        B, C, Fq, T = x.shape
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = ops.std_unbiased(x, axis=(1, 2, 3))
        x = (x - mean) / (1e-5 + std)
        if cfg.hybrid:
            xt = mix
            meant = xt.mean(dim=(1, 2), keepdim=True)
            stdt = ops.std_unbiased(xt, axis=(1, 2))
            xt = (xt - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            inject = None
            if cfg.hybrid and idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.tencoder[idx]
                xt = tenc(xt)
                if not tenc.spec.empty:
                    saved_t.append(xt)
                else:
                    inject = xt
            x = encode(x, inject)
            if idx == 0 and self.layout.freq_emb_bins:
                frs = torch.arange(x.shape[-2], device=x.device)
                x = x + cfg.freq_emb * self.freq_emb(frs).t()[None, :, :, None]
            saved.append(x)

        # the decoders start from zeros: the signal comes through the skips
        x = torch.zeros_like(x)
        if cfg.hybrid:
            xt = torch.zeros_like(x)
        offset = cfg.depth - len(self.tdecoder)
        for idx, decode in enumerate(self.decoder):
            x, pre = decode(x, saved.pop(-1), lengths.pop(-1))
            if cfg.hybrid and idx >= offset:
                tdec = self.tdecoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tdec.spec.empty:
                    if pre.shape[2] != 1:
                        raise AssertionError(tuple(pre.shape))
                    xt, _ = tdec(pre[:, :, 0], None, length_t)
                else:
                    xt, _ = tdec(xt, saved_t.pop(-1), length_t)
        if saved or saved_t or lengths_t:
            raise AssertionError("unbalanced encoder / decoder skips")

        S = len(cfg.sources)
        x = x.reshape(B, S, -1, Fq, T) * std[:, None] + mean[:, None]
        with precision_scope(None):
            if cfg.cac:
                zout = cac_unpack(x)
            else:
                niters = cfg.end_iters if self.training else cfg.wiener_iters
                zout = magnitude_output(x, z, niters, residual=cfg.wiener_residual)
            if cfg.hybrid:
                out = demucs_ispec(zout, length, hybrid_old=cfg.hybrid_old)
                xt = xt.reshape(B, S, -1, length) * stdt[:, None] + meant[:, None]
                return xt + out
            # the plain centered iSTFT, with the Nyquist row put back as zeros
            nyquist = zout.new_zeros(*zout.shape[:-2], 1, zout.shape[-1])
            return istft(torch.cat([zout, nyquist], dim=-2), cfg.nfft, cfg.hop_length,
                         length=length)


def init_hdemucs(cfg: HDemucsConfig, seed: int = 0, layer_scale: tp.Optional[float] = None,
                 random_norms: bool = False) -> HDemucs:
    """Random weights equal to ``demucs_tpu.models.hdemucs.init_hdemucs(cfg,
    seed)`` (``models/initializers.py``). ``layer_scale`` sets every
    LayerScale (1e-4 at init, which hides the DConv branches, BLSTM and
    LocalState included, below a 2e-4 x peak comparison) and
    ``random_norms`` draws every GroupNorm, as in ``init_htdemucs``."""
    model = HDemucs(cfg)
    init = Init(seed)
    with torch.no_grad():
        for group in (model.encoder, model.decoder, model.tencoder, model.tdecoder):
            init.module(group, cfg.rescale)
        if model.layout.freq_emb_bins:
            init.module(model.freq_emb, None, cfg.emb_smooth)
        init.finish(model, layer_scale, random_norms)
    return model
