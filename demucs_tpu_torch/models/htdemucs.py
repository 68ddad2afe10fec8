"""HTDemucs (v4): hybrid dual-branch U-Net with a cross-domain transformer
(port of ``demucs_tpu/models/htdemucs.py``; behavioral reference
``demucs/htdemucs.py:27-759``).

``HTDemucsConfig`` is a copy of the JAX package's dataclass with the same
fields and defaults, so ``.dmx`` configs load unchanged. The forward is
STFT (K1) -> complex-as-channels -> dual encoders -> cross-transformer (K3)
-> dual decoders -> iSTFT (K2) + time branch.

Train mode (``module.train()``): ``forward(mix, generator=...)`` runs the
input at its own length (no padding to the training segment), ``end_iters``
for the magnitude masks of ``cac=False``, and the transformer's dropout and
draws from the generator passed in. ``remat = True`` (the training config's
``remat``) recomputes each encoder and decoder layer in the backward
(``torch.utils.checkpoint``) under the precision of its forward.

Options: ``cac=False`` (magnitude masks; the stems' phase from Wiener EM or,
with ``wiener_iters < 0``, from the mixture), ``multi_freqs`` (MultiWrap
encoders and decoders, as in HDemucs), and every transformer variant of
``models/transformer.py`` (static sparse attention through K3, LSH sparsity
on the dense route, CAPE). ``t_flash_attn`` has no effect: the
transformer always takes K3 where its mask allows.

Precision, as in the JAX package (``htdemucs.py:215-395``): the core's
stages (``_STAGES``) run in bf16 where ``compute_dtype="bfloat16"`` or
``bf16_stages`` says so, with fp32 statistics, softmax and accumulation; the
others in fp32. A bf16 stage computes with bf16 copies of its parameters,
made one of two ways, with the same values:

- serving: the module holds them in bf16, converted once when it is built
  for its config (presets, the device engine and its graphs read them);
- training: every parameter is an fp32 master (``module.float()`` before
  the weights are loaded, or ``init_htdemucs(..., fp32_masters=True)``), and
  each forward casts a bf16 stage's parameters to bf16 (JAX's
  ``stage_params``), differentiably, so the gradients, the optimizer's
  state and the checkpoints stay fp32.

The forward tells the two apart by the dtype of the parameters it finds.
``matmul_precision`` (or
``compute_dtype="mixed"``, which implies ``"tensorfloat32"``) sets
:func:`precision_scope` around the core and ``precision_stages`` per stage.
The DSP (K1, K2) runs in full fp32 outside the scope.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import typing as tp

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from demucs_tpu_torch.models import hlayers as hl
from demucs_tpu_torch.models.transformer import CrossTransformerEncoder, TransformerSpec
from demucs_tpu_torch.ops import nn as ops
from demucs_tpu_torch.ops.spec import cac_pack, cac_unpack, demucs_ispec, demucs_spec
from demucs_tpu_torch.ops.wiener import magnitude_output


@dataclasses.dataclass(frozen=True)
class HTDemucsConfig:
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
    depth: int = 4
    rewrite: bool = True
    # Frequency branch
    multi_freqs: tp.Tuple[float, ...] = ()
    multi_freqs_depth: int = 3
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
    dconv_comp: float = 8.0
    dconv_init: float = 1e-3
    # Before the transformer
    bottom_channels: int = 0
    # Transformer
    t_layers: int = 5
    t_emb: str = "sin"
    t_hidden_scale: float = 4.0
    t_heads: int = 8
    t_dropout: float = 0.0
    t_max_positions: int = 10000
    t_norm_in: bool = True
    t_norm_in_group: bool = False
    t_group_norm: bool = False
    t_norm_first: bool = True
    t_norm_out: bool = True
    t_max_period: float = 10000.0
    t_weight_decay: float = 0.0
    t_lr: tp.Optional[float] = None
    t_layer_scale: bool = True
    t_gelu: bool = True
    t_weight_pos_embed: float = 1.0
    t_sin_random_shift: int = 0
    t_cape_mean_normalize: bool = True
    t_cape_augment: bool = True
    t_cape_glob_loc_scale: tp.Tuple[float, float, float] = (5000.0, 1.0, 1.4)
    t_sparse_self_attn: bool = False
    t_sparse_cross_attn: bool = False
    t_mask_type: str = "diag"
    t_mask_random_seed: int = 42
    t_sparse_attn_window: int = 500
    t_global_window: int = 100
    t_sparsity: float = 0.95
    t_auto_sparsity: bool = False
    t_cross_first: bool = False
    # Weight init
    rescale: float = 0.1
    # Metadata
    samplerate: int = 44100
    segment: float = 10.0
    use_train_segment: bool = True
    # Kept for config compatibility; the port's transformer always takes K3.
    t_flash_attn: bool = False
    # Precision policy (the module docstring): "float32", "mixed" (fp32 with
    # matmul_precision "tensorfloat32") or "bfloat16" (every core stage bf16).
    compute_dtype: str = "float32"
    bf16_stages: tp.Tuple[str, ...] = ()
    matmul_precision: tp.Optional[str] = None
    precision_stages: tp.Tuple[tp.Tuple[str, str], ...] = ()

    @property
    def hop_length(self) -> int:
        return self.nfft // 4

    @property
    def training_length(self) -> int:
        return int(self.segment * self.samplerate)


def layout(cfg: HTDemucsConfig) -> hl.HybridLayout:
    return hl.build_hybrid_layout(
        sources=cfg.sources, audio_channels=cfg.audio_channels,
        channels=cfg.channels, channels_time=cfg.channels_time, growth=cfg.growth,
        nfft=cfg.nfft, cac=cfg.cac, depth=cfg.depth, rewrite=cfg.rewrite,
        kernel_size=cfg.kernel_size, time_stride=cfg.time_stride, stride=cfg.stride,
        context=cfg.context, context_enc=cfg.context_enc,
        norm_starts=cfg.norm_starts, norm_groups=cfg.norm_groups,
        dconv_mode=cfg.dconv_mode, dconv_depth=cfg.dconv_depth,
        dconv_comp=cfg.dconv_comp, dconv_init=cfg.dconv_init,
        freq_emb=cfg.freq_emb, multi_freqs=cfg.multi_freqs,
        multi_freqs_depth=cfg.multi_freqs_depth,
    )


def transformer_spec(cfg: HTDemucsConfig) -> TransformerSpec:
    dim = cfg.bottom_channels or cfg.channels * cfg.growth ** (cfg.depth - 1)
    return TransformerSpec(
        dim=dim, num_layers=cfg.t_layers, num_heads=cfg.t_heads,
        hidden_scale=cfg.t_hidden_scale, cross_first=cfg.t_cross_first,
        emb=cfg.t_emb, norm_in=cfg.t_norm_in, norm_in_group=cfg.t_norm_in_group,
        norm_first=cfg.t_norm_first, norm_out=cfg.t_norm_out,
        max_period=cfg.t_max_period, layer_scale=cfg.t_layer_scale, gelu=cfg.t_gelu,
        weight_pos_embed=cfg.t_weight_pos_embed,
        sin_random_shift=cfg.t_sin_random_shift,
        cape_mean_normalize=cfg.t_cape_mean_normalize, cape_augment=cfg.t_cape_augment,
        cape_glob_loc_scale=cfg.t_cape_glob_loc_scale,
        sparse_self_attn=cfg.t_sparse_self_attn,
        sparse_cross_attn=cfg.t_sparse_cross_attn, mask_type=cfg.t_mask_type,
        mask_random_seed=cfg.t_mask_random_seed,
        sparse_attn_window=cfg.t_sparse_attn_window, global_window=cfg.t_global_window,
        sparsity=cfg.t_sparsity, auto_sparsity=cfg.t_auto_sparsity, dropout=cfg.t_dropout,
    )


# The JAX package's matmul precision strings and their meaning on the card.
PRECISIONS = {None: "float32", "highest": "float32", "float32": "float32",
              "high": "tensorfloat32", "tensorfloat32": "tensorfloat32",
              "default": "bfloat16", "bfloat16": "bfloat16"}


def check_precision(precision: tp.Optional[str]) -> str:
    """The card's mode for a JAX matmul precision string; raises on a name it
    has no counterpart for (the dot-algorithm names such as
    ``"BF16_BF16_F32_X3"``)."""
    try:
        return PRECISIONS[precision]
    except (KeyError, TypeError):
        names = ", ".join(repr(p) for p in PRECISIONS)
        raise ValueError(f"unknown matmul_precision {precision!r}: the card takes {names} "
                         "(dot-algorithm names have no counterpart here)") from None


@contextlib.contextmanager
def precision_scope(precision: tp.Optional[str] = None):
    """The card's form of ``jax.default_matmul_precision(precision)`` for the
    fp32 operations in the block (restored on exit):

    - ``None``, ``"highest"``, ``"float32"``: TF32 off for cuDNN convolutions
      and RNNs and for cuBLAS, full fp32;
    - ``"high"``, ``"tensorfloat32"``: TF32 on for all three;
    - ``"default"``, ``"bfloat16"``: the operands of convolutions and products
      rounded to bf16 (``ops.nn.bf16_operands``) on the TF32 tensor cores:
      fp32 accumulation and results.

    Anything else raises ``ValueError``. On the CPU every string computes true
    fp32, as JAX does there. K3's route follows its inputs' dtype only: its
    fp32 route keeps fp32 accuracy under every string.
    """
    mode = check_precision(precision)
    tf32 = mode != "float32"
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=tf32), ops.bf16_operands(mode == "bfloat16"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


_STAGES = ("encoder", "tencoder", "transformer", "decoder", "tdecoder")


def _bf16_stage_set(cfg: HTDemucsConfig) -> frozenset:
    """Which core stages run with bf16 activations and parameters."""
    if cfg.bf16_stages:
        unknown = set(cfg.bf16_stages) - set(_STAGES)
        if unknown:
            raise ValueError(f"unknown bf16_stages {sorted(unknown)}")
        return frozenset(cfg.bf16_stages)
    if cfg.compute_dtype == "bfloat16":
        return frozenset(_STAGES)
    if cfg.compute_dtype in ("float32", "mixed"):
        return frozenset()
    raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


def _matmul_precision(cfg: HTDemucsConfig) -> tp.Optional[str]:
    if cfg.matmul_precision:
        return cfg.matmul_precision
    if cfg.compute_dtype == "mixed":
        return "tensorfloat32"
    return None


def _precision_overrides(cfg: HTDemucsConfig) -> tp.Dict[str, str]:
    over = dict(cfg.precision_stages)
    if set(over) - set(_STAGES):
        raise ValueError(f"unknown precision_stages {sorted(set(over) - set(_STAGES))}")
    for p in over.values():
        check_precision(p)
    return over


def _casts(stage: str, bf16: frozenset, mod: nn.Module) -> bool:
    """Whether ``mod``, of a bf16 stage, holds fp32 masters to cast per forward."""
    return stage in bf16 and any(p.dtype == torch.float32 for p in mod.parameters())


def _bf16_params(mod: nn.Module) -> tp.Dict[str, torch.Tensor]:
    """bf16 copies of ``mod``'s parameters (JAX's ``stage_params``); their
    gradients reach the fp32 masters through the cast."""
    return {n: p.to(torch.bfloat16) for n, p in mod.named_parameters()}


def _staged(stage: str, bf16: frozenset, mod: nn.Module) -> tp.Callable:
    """``mod`` as the core calls it: on bf16 copies of its fp32 masters in a
    bf16 stage (training), made afresh on every call, else ``mod`` itself."""
    if not _casts(stage, bf16, mod):
        return mod
    return lambda *args, **kwargs: torch.func.functional_call(mod, _bf16_params(mod), args,
                                                              kwargs)


def _conv1x1(conv: nn.Conv1d, x: torch.Tensor, cast: bool) -> torch.Tensor:
    w, b = conv.weight, conv.bias
    if cast:
        w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    return ops.conv1d(x, w, b)


class HTDemucs(nn.Module):
    """HTDemucs. ``forward(mix (B, C, L)) -> stems (B, S, C, L)``, fp32 in and out."""

    remat = False  # recompute the encoder and decoder layers in the backward (training)

    def __init__(self, cfg: HTDemucsConfig):
        super().__init__()
        _bf16_stage_set(cfg)
        _precision_overrides(cfg)
        check_precision(_matmul_precision(cfg))
        self.cfg = cfg
        lay = layout(cfg)
        self.layout = lay
        self.encoder = nn.ModuleList(hl.enc_layer(s) for s in lay.enc)
        self.tencoder = nn.ModuleList(hl.HEncLayer(s) for s in lay.tenc)
        self.decoder = nn.ModuleList(hl.dec_layer(s) for s in lay.dec)
        self.tdecoder = nn.ModuleList(hl.HDecLayer(s) for s in lay.tdec)
        if lay.freq_emb_bins:
            self.freq_emb = hl.ScaledEmbedding(lay.freq_emb_bins, lay.freq_emb_dim,
                                               scale=cfg.emb_scale)
        if cfg.bottom_channels:
            tc = cfg.channels * cfg.growth ** (cfg.depth - 1)
            self.channel_upsampler = nn.Conv1d(tc, cfg.bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(cfg.bottom_channels, tc, 1)
            self.channel_upsampler_t = nn.Conv1d(tc, cfg.bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(cfg.bottom_channels, tc, 1)
        if cfg.t_layers > 0:
            self.crosstransformer = CrossTransformerEncoder(transformer_spec(cfg))
        self._stage_dtypes()

    def stage_modules(self, stage: str) -> tp.List[nn.Module]:
        """The modules whose parameters a core stage reads."""
        names = {"encoder": ("encoder", "freq_emb"), "tencoder": ("tencoder",),
                 "transformer": ("channel_upsampler", "channel_upsampler_t",
                                 "channel_downsampler", "channel_downsampler_t",
                                 "crosstransformer"),
                 "decoder": ("decoder",), "tdecoder": ("tdecoder",)}[stage]
        return [getattr(self, n) for n in names if hasattr(self, n)]

    def _stage_dtypes(self) -> None:
        """Hold each bf16 stage's parameters in bf16, once (serving); the other
        stages keep fp32. ``module.float()`` undoes it for training: the
        forward then casts fp32 masters on every call, as JAX does."""
        bf16 = _bf16_stage_set(self.cfg)
        for stage in _STAGES:
            for mod in self.stage_modules(stage):
                mod.to(torch.bfloat16 if stage in bf16 else torch.float32)

    def forward_core(self, mag: torch.Tensor, mix: torch.Tensor,
                     generator: tp.Optional[torch.Generator] = None
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Encoder / transformer / decoder core (htdemucs.py:677-759), under
        the config's precision policy (JAX ``_core``).

        ``mag (B, C[*2], F, T)`` spectrogram-as-channels, ``mix (B, C, L)``
        waveform -> ``(spec_out (B, S, C*2, F, T), time_out (B, S, C, L))``, fp32.
        """
        cfg = self.cfg
        with precision_scope(_matmul_precision(cfg)):
            return self._core(mag, mix, generator)

    def _layer(self, layer: tp.Callable, precision: tp.Optional[str], *args):
        """``layer(*args)``, recomputed in the backward when training with
        ``remat``, under the same precision scope (and the same casts of a
        bf16 stage's masters, :func:`_staged`) as in the forward."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return layer(*args)

        def run(*inputs):
            with precision_scope(precision):
                return layer(*inputs)

        return checkpoint(run, *args, use_reentrant=False)

    def _core(self, mag: torch.Tensor, mix: torch.Tensor,
              generator: tp.Optional[torch.Generator] = None
              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = mag
        B, C, Fq, T = x.shape
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = ops.std_unbiased(x, axis=(1, 2, 3))
        x = (x - mean) / (1e-5 + std)

        xt = mix
        length = xt.shape[-1]
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = ops.std_unbiased(xt, axis=(1, 2))
        xt = (xt - meant) / (1e-5 + stdt)

        bf16 = _bf16_stage_set(cfg)
        prec_over = _precision_overrides(cfg)
        # fp32, or float64 for a float64 module and input (a reference run on the CPU)
        full = torch.float64 if mag.dtype == torch.float64 else torch.float32

        def cast(stage: str, a: torch.Tensor) -> torch.Tensor:
            return a.to(torch.bfloat16 if stage in bf16 else full)

        def staged(stage: str, mod: nn.Module) -> tp.Callable:
            return _staged(stage, bf16, mod)

        def prec(stage: str):
            p = prec_over.get(stage)
            return precision_scope(p) if p else contextlib.nullcontext()

        def layer_prec(stage: str) -> tp.Optional[str]:
            return prec_over.get(stage, _matmul_precision(cfg))

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.tencoder[idx]
                xt = cast("tencoder", xt)
                with prec("tencoder"):
                    xt = self._layer(staged("tencoder", tenc), layer_prec("tencoder"), xt)
                if not tenc.spec.empty:
                    saved_t.append(xt)
                else:
                    inject = xt
            x = cast("encoder", x)
            if inject is not None:
                inject = cast("encoder", inject)
            with prec("encoder"):
                x = self._layer(staged("encoder", encode), layer_prec("encoder"), x, inject)
            if idx == 0 and self.layout.freq_emb_bins:
                frs = torch.arange(x.shape[-2], device=x.device)
                emb = staged("encoder", self.freq_emb)(frs).t()[None, :, :, None].to(x.dtype)
                x = x + hl.scalar(cfg.freq_emb, x.dtype) * emb
            saved.append(x)

        if cfg.t_layers > 0:
            x = cast("transformer", x)
            xt = cast("transformer", xt)
            with prec("transformer"):
                if cfg.bottom_channels:
                    cast_t = _casts("transformer", bf16, self.channel_upsampler)
                    b, c, f, t = x.shape
                    x = _conv1x1(self.channel_upsampler, x.reshape(b, c, f * t), cast_t)
                    x = x.reshape(b, -1, f, t)
                    xt = _conv1x1(self.channel_upsampler_t, xt, cast_t)
                x, xt = staged("transformer", self.crosstransformer)(x, xt, generator=generator)
                if cfg.bottom_channels:
                    b, c, f, t = x.shape
                    x = _conv1x1(self.channel_downsampler, x.reshape(b, c, f * t), cast_t)
                    x = x.reshape(b, -1, f, t)
                    xt = _conv1x1(self.channel_downsampler_t, xt, cast_t)

        x = cast("decoder", x)
        xt = cast("tdecoder", xt)
        offset = cfg.depth - len(self.tdecoder)
        for idx, decode in enumerate(self.decoder):
            skip = cast("decoder", saved.pop(-1))
            with prec("decoder"):
                x, pre = self._layer(staged("decoder", decode), layer_prec("decoder"), x, skip,
                                     lengths.pop(-1))
            if idx >= offset:
                tdec = self.tdecoder[idx - offset]
                length_t = lengths_t.pop(-1)
                with prec("tdecoder"):
                    if tdec.spec.empty:
                        if pre.shape[2] != 1:
                            raise AssertionError(tuple(pre.shape))
                        xt, _ = self._layer(staged("tdecoder", tdec), layer_prec("tdecoder"),
                                            cast("tdecoder", pre[:, :, 0]), None, length_t)
                    else:
                        xt, _ = self._layer(staged("tdecoder", tdec), layer_prec("tdecoder"), xt,
                                            cast("tdecoder", saved_t.pop(-1)), length_t)
        if saved or saved_t or lengths_t:
            raise AssertionError("unbalanced encoder / decoder skips")

        S = len(cfg.sources)
        x = x.to(full).reshape(B, S, -1, Fq, T) * std[:, None] + mean[:, None]
        xt = xt.to(full).reshape(B, S, -1, length) * stdt[:, None] + meant[:, None]
        return x, xt

    def forward(self, mix: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """``mix (B, C, L)`` -> stems ``(B, S, C, L)`` (htdemucs.py:527-660).

        With ``use_train_segment`` in eval mode the input is right-padded
        with zeros to the training segment and the output cropped back.
        ``generator``: the train mode's draws (the transformer's dropout,
        shift and CAPE augment), a CPU ``torch.Generator``.
        """
        cfg = self.cfg
        length = mix.shape[-1]
        length_pre_pad = None
        if cfg.use_train_segment and not self.training:
            training_length = cfg.training_length
            if length < training_length:
                length_pre_pad = length
                mix = F.pad(mix, (0, training_length - length))
            elif length > training_length:
                raise ValueError(
                    f"Input length {length} exceeds training length {training_length}")
        with precision_scope(None):
            z = demucs_spec(mix, cfg.nfft)
        x, xt = self.forward_core(cac_pack(z) if cfg.cac else z.abs(), mix, generator)
        with precision_scope(None):
            if cfg.cac:
                zout = cac_unpack(x)
            else:  # magnitude masks (htdemucs.py:436-452)
                niters = cfg.end_iters if self.training else cfg.wiener_iters
                zout = magnitude_output(x, z, niters, residual=cfg.wiener_residual)
            out = xt + demucs_ispec(zout, mix.shape[-1])
        if length_pre_pad:
            out = out[..., :length_pre_pad]
        return out


def init_htdemucs(cfg: HTDemucsConfig, seed: int = 0,
                  layer_scale: tp.Optional[float] = None,
                  random_norms: bool = False, fp32_masters: bool = False) -> HTDemucs:
    """Random weights from a seeded ``torch.Generator``, with the distributions
    of ``demucs_tpu.models.htdemucs.init_htdemucs`` (not its numbers):
    ``U(+-1/sqrt(fan_in))`` for convolutions and linear maps, the Demucs
    rescale trick on the U-Net's convolutions, a smoothed normal frequency
    embedding, unit norms and the configured layer scales.

    ``layer_scale`` sets every LayerScale (transformer and DConv) to that
    value instead. At the configured inits (1e-4 in the transformer) those
    branches reach the output at about 1e-4 of its size, below a 2e-4 x peak
    comparison; checks of random weights pass 1.0 so that they count.
    ``random_norms`` draws every GroupNorm and LayerNorm weight as
    ``1 + 0.3 N(0, 1)`` and bias as ``0.3 N(0, 1)``: with unit weights and
    zero biases a norm left out moves the output too little for a check to
    see. ``fp32_masters`` keeps every parameter fp32 (training: a bf16
    stage casts them on each forward) where a bf16 stage would hold bf16."""
    # drawn in fp32, then each bf16 stage rounded once, as a loaded checkpoint is
    model = HTDemucs(dataclasses.replace(cfg, compute_dtype="float32", bf16_stages=()))
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)

    with torch.no_grad():
        for name, mod in model.named_modules():
            rescale = cfg.rescale if name.split(".")[0] in (
                "encoder", "tencoder", "decoder", "tdecoder") else None
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                                nn.Linear)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                uniform_(mod.weight, bound)
                uniform_(mod.bias, bound)
                if rescale and not isinstance(mod, nn.Linear):
                    scale = (mod.weight.std() / rescale) ** 0.5
                    mod.weight /= scale
                    mod.bias /= scale
            elif isinstance(mod, hl.ScaledEmbedding):
                w = torch.randn(mod.embedding.weight.shape, generator=gen)
                if cfg.emb_smooth:
                    w = w.cumsum(0) / torch.arange(1, w.shape[0] + 1).sqrt()[:, None]
                mod.embedding.weight.copy_(w / mod.scale)
            elif hasattr(mod, "in_proj_weight"):
                uniform_(mod.in_proj_weight, 1.0 / math.sqrt(mod.in_proj_weight.shape[1]))
                mod.in_proj_bias.zero_()
            elif isinstance(mod, hl.LayerScale) and layer_scale is not None:
                mod.scale.fill_(layer_scale)
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and random_norms:
                mod.weight.copy_(1 + 0.3 * torch.randn(mod.weight.shape, generator=gen))
                mod.bias.copy_(0.3 * torch.randn(mod.bias.shape, generator=gen))
    model.cfg = cfg
    if not fp32_masters:
        model._stage_dtypes()
    return model
