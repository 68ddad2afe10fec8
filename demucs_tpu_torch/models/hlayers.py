"""Layers of the Demucs families (port of ``demucs_tpu/models/hlayers.py``).

Behavioral reference: ``demucs/hdemucs.py`` (HEncLayer 69-157, MultiWrap
160-253, HDecLayer 256-335, ScaledEmbedding 43-66) and ``demucs/demucs.py``
(BLSTM 20-67, DConv 86-154, LocalState 157-216).

The spec dataclasses and :func:`build_hybrid_layout` are copies of the JAX
package's. The layers are ``nn.Module``s whose attribute names and
``Sequential`` indices reproduce the reference's state-dict paths (for
example ``encoder.0.dconv.layers.1.3.weight``), so a flat checkpoint loads
with ``load_state_dict(strict=True)``. The modules hold the weights and the
``forward`` methods apply them through ``demucs_tpu_torch.ops.nn``, call for
call as the JAX package's ``*_forward`` functions do. The BLSTM runs its
``nn.LSTM`` (cuDNN on the card), whose parameter names are the reference's.
Use :func:`enc_layer` and :func:`dec_layer` to build a layer: they return a
MultiWrap (one layer replica per frequency band) where the spec asks for one.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
from torch import nn

from demucs_tpu_torch.ops import nn as ops

# ---------------------------------------------------------------------------
# Specs (copies of demucs_tpu/models/hlayers.py:41-254)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DConvSpec:
    channels: int
    compress: float = 4.0
    depth: int = 2
    init: float = 1e-4
    norm: bool = True
    attn: bool = False
    heads: int = 4
    ndecay: int = 4
    lstm: bool = False
    gelu: bool = True
    kernel: int = 3
    dilate: bool = True


@dataclasses.dataclass(frozen=True)
class EncSpec:
    chin: int
    chout: int
    freq: bool
    kernel: int
    stride: int
    pad: int
    empty: bool
    norm: bool
    norm_groups: int
    rewrite: bool
    context: int
    dconv: tp.Optional[DConvSpec]
    multi_freqs: tp.Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class DecSpec:
    chin: int
    chout: int
    freq: bool
    kernel: int
    stride: int
    pad: int
    empty: bool
    norm: bool
    norm_groups: int
    rewrite: bool
    context: int
    context_freq: bool
    last: bool
    dconv: tp.Optional[DConvSpec]
    multi_freqs: tp.Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """Static structure of the dual-branch U-Net."""

    enc: tp.Tuple[EncSpec, ...]
    tenc: tp.Tuple[EncSpec, ...]
    dec: tp.Tuple[DecSpec, ...]
    tdec: tp.Tuple[DecSpec, ...]
    freq_emb_bins: int  # rows of the ScaledEmbedding (0 = none)
    freq_emb_dim: int
    bottleneck_channels: int


def build_hybrid_layout(
    *,
    sources: tp.Sequence[str],
    audio_channels: int,
    channels: int,
    channels_time: tp.Optional[int],
    growth: float,
    nfft: int,
    cac: bool,
    depth: int,
    rewrite: bool,
    kernel_size: int,
    time_stride: int,
    stride: int,
    context: int,
    context_enc: int,
    norm_starts: int,
    norm_groups: int,
    dconv_mode: int,
    dconv_depth: int,
    dconv_comp: float,
    dconv_init: float,
    dconv_lstm_start: tp.Optional[int] = None,
    dconv_attn_start: tp.Optional[int] = None,
    freq_emb: float = 0.2,
    hybrid: bool = True,
    multi_freqs: tp.Sequence[float] = (),
    multi_freqs_depth: int = 0,
) -> HybridLayout:
    """Re-creation of the reference constructor loop (hdemucs.py:494-582)."""
    multi_freqs = tuple(multi_freqs or ())

    enc: list[EncSpec] = []
    tenc: list[EncSpec] = []
    dec: list[DecSpec] = []
    tdec: list[DecSpec] = []

    chin = audio_channels
    chin_z = chin * 2 if cac else chin
    chout = channels_time or channels
    chout_z = channels
    freqs = nfft // 2
    freq_emb_bins = 0
    freq_emb_dim = 0

    for index in range(depth):
        lstm = dconv_lstm_start is not None and index >= dconv_lstm_start
        attn = dconv_attn_start is not None and index >= dconv_attn_start
        norm = index >= norm_starts
        freq = freqs > 1
        stri = stride
        ker = kernel_size
        if not freq:
            assert freqs == 1
            ker = time_stride * 2
            stri = time_stride

        pad = True
        last_freq = False
        if freq and freqs <= kernel_size:
            ker = freqs
            pad = False
            last_freq = True

        if last_freq:
            chout_z = max(chout, chout_z)
            chout = chout_z

        def dconv_spec(ch: int) -> tp.Optional[DConvSpec]:
            return DConvSpec(
                channels=ch,
                compress=dconv_comp,
                depth=dconv_depth,
                init=dconv_init,
                lstm=lstm,
                attn=attn,
                gelu=True,
                # reference DConv: negative depth disables dilation
                dilate=dconv_depth > 0,
            )

        pad_amt = ker // 4 if pad else 0
        multi = bool(multi_freqs) and index < multi_freqs_depth
        enc.append(
            EncSpec(
                chin=chin_z, chout=chout_z, freq=freq, kernel=ker, stride=stri,
                pad=pad_amt, empty=False, norm=norm, norm_groups=norm_groups,
                rewrite=rewrite, context=context_enc,
                dconv=dconv_spec(chout_z) if dconv_mode & 1 else None,
                multi_freqs=multi_freqs if multi else (),
            )
        )
        if hybrid and freq:
            tenc.append(
                EncSpec(
                    chin=chin, chout=chout, freq=False, kernel=kernel_size,
                    stride=stride, pad=kernel_size // 4, empty=last_freq,
                    norm=norm, norm_groups=norm_groups, rewrite=rewrite,
                    context=context_enc,
                    dconv=dconv_spec(chout) if dconv_mode & 1 else None,
                )
            )

        if index == 0:
            chin = audio_channels * len(sources)
            chin_z = chin * 2 if cac else chin

        dec.insert(
            0,
            DecSpec(
                chin=chout_z, chout=chin_z, freq=freq, kernel=ker, stride=stri,
                pad=pad_amt, empty=False, norm=norm, norm_groups=norm_groups,
                rewrite=rewrite, context=context, context_freq=not multi,
                last=index == 0,
                dconv=dconv_spec(chout_z) if dconv_mode & 2 else None,
                multi_freqs=multi_freqs if multi else (),
            ),
        )
        if hybrid and freq:
            tdec.insert(
                0,
                DecSpec(
                    chin=chout, chout=chin, freq=False, kernel=kernel_size,
                    stride=stride, pad=kernel_size // 4, empty=last_freq,
                    norm=norm, norm_groups=norm_groups, rewrite=rewrite,
                    context=context, context_freq=True, last=index == 0,
                    dconv=dconv_spec(chout) if dconv_mode & 2 else None,
                ),
            )

        chin = chout
        chin_z = chout_z
        chout = int(growth * chout)
        chout_z = int(growth * chout_z)
        if freq:
            if freqs <= kernel_size:
                freqs = 1
            else:
                freqs //= stride
        if index == 0 and freq_emb:
            freq_emb_bins = freqs
            freq_emb_dim = chin_z

    return HybridLayout(
        enc=tuple(enc), tenc=tuple(tenc), dec=tuple(dec), tdec=tuple(tdec),
        freq_emb_bins=freq_emb_bins, freq_emb_dim=freq_emb_dim,
        bottleneck_channels=chin_z,
    )


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a Python constant multiplying a bf16
    tensor rounds to bf16 first in JAX (a weak-typed scalar); in PyTorch it
    would not. A no-op for fp32 tensors."""
    return value if dtype == torch.float32 else torch.tensor(value, dtype=dtype).item()


class LayerScale(nn.Module):
    """Per-channel rescale of a residual branch (``demucs/demucs.py:70-83``)."""

    def __init__(self, channels: int, init: float = 0.0, channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_last:
            return self.scale * x
        return self.scale[:, None] * x


def _norm(enabled: bool, groups: int, channels: int) -> nn.Module:
    return nn.GroupNorm(groups, channels) if enabled else nn.Identity()


def _maybe_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(norm, nn.Identity):
        return x
    return ops.group_norm(x, norm.num_groups, norm.weight, norm.bias)


def unfold(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Frames ``(..., T) -> (..., F, kernel_size)`` with ``F = ceil(T / stride)``,
    the tail zero-padded so that every frame is whole (``demucs/utils.py:20-35``)."""
    length = x.shape[-1]
    n_frames = math.ceil(length / stride)
    x = nn.functional.pad(x, (0, (n_frames - 1) * stride + kernel_size - length))
    return x.unfold(-1, kernel_size, stride)


def _stitch_frames(frames: torch.Tensor, stride: int, length: int) -> torch.Tensor:
    """Overlapping BLSTM frames ``(B, F, C, width)`` back to ``(B, C, length)``:
    the first frame without its last ``stride // 2`` steps, the middle ones
    without ``stride // 2`` on each side, the last without its first
    (``demucs/demucs.py:55-64``)."""
    B, nframes, C, width = frames.shape
    limit = stride // 2
    middle = frames[:, 1:-1, :, limit:-limit].permute(0, 2, 1, 3).reshape(B, C, -1)
    out = torch.cat([frames[:, 0, :, :-limit], middle, frames[:, -1, :, limit:]], dim=-1)
    return out[..., :length]


class BLSTM(nn.Module):
    """Bidirectional LSTM over ``x (B, C, T)`` then a linear map back to C
    (``demucs/demucs.py:20-67``). With ``max_steps`` a longer input runs as
    overlapping frames of ``max_steps`` steps at half that stride, stitched
    back by :func:`_stitch_frames`; ``skip`` adds the input."""

    def __init__(self, dim: int, layers: int = 1, max_steps: tp.Optional[int] = None,
                 skip: bool = False):
        super().__init__()
        self.max_steps = max_steps
        self.skip = skip
        self.lstm = nn.LSTM(bidirectional=True, num_layers=layers, hidden_size=dim,
                            input_size=dim)
        self.linear = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        y = x
        framed = self.max_steps is not None and T > self.max_steps
        if framed:
            width = self.max_steps
            stride = width // 2
            frames = unfold(x, width, stride)  # (B, C, F, width)
            nframes = frames.shape[2]
            x = frames.permute(0, 2, 1, 3).reshape(-1, C, width)
        x = self.lstm(x.permute(2, 0, 1))[0]  # (T', B', 2C)
        x = ops.linear(x, self.linear.weight, self.linear.bias).permute(1, 2, 0)
        if framed:
            x = _stitch_frames(x.reshape(B, nframes, C, width), stride, T)
        if self.skip:
            x = x + y
        return x


class LocalState(nn.Module):
    """Content-based local attention with a decaying time penalty
    (``demucs/demucs.py:157-216``), ``x (B, C, T)``; each step's own position
    is masked with -100. Plain products (cuBLAS on the card, through
    ``ops.matmul``), as the JAX package's einsums."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4):
        super().__init__()
        self.heads = heads
        self.ndecay = ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        if ndecay:
            self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        heads = self.heads

        def conv(mod: nn.Conv1d, v: torch.Tensor) -> torch.Tensor:
            return ops.conv1d(v, mod.weight, mod.bias)

        queries = conv(self.query, x).reshape(B, heads, -1, T)
        keys = conv(self.key, x).reshape(B, heads, -1, T)
        dots = ops.matmul("bhct,bhcs->bhts", keys, queries) / math.sqrt(keys.shape[2])
        if self.ndecay:
            indexes = torch.arange(T, device=x.device, dtype=x.dtype)
            delta = (indexes[:, None] - indexes[None, :]).abs()
            decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
            decay_q = torch.sigmoid(conv(self.query_decay, x).reshape(B, heads, -1, T)) / 2
            decay_kernel = -decays[:, None, None] * delta / math.sqrt(self.ndecay)
            dots = dots + ops.matmul("fts,bhfs->bhts", decay_kernel, decay_q)
        eye = torch.eye(T, dtype=torch.bool, device=x.device)
        dots = dots.masked_fill(eye, -100.0)
        weights = torch.softmax(dots, dim=2)
        content = conv(self.content, x).reshape(B, heads, -1, T)
        result = ops.matmul("bhts,bhct->bhcs", weights, content).reshape(B, -1, T)
        return x + conv(self.proj, result)


class DConv(nn.Module):
    """Residual dilated-conv branch (``demucs/demucs.py:86-154``), ``x (B, C, T)``.

    ``layers[d]`` is a Sequential with the reference's indices: 0 conv1,
    1 norm1, 2 GELU, then the BLSTM (``lstm``) and LocalState (``attn``)
    where the spec has them, then conv2, norm2, GLU and LayerScale. The
    modules hold the weights; ``forward`` applies them through ``ops.nn``, as
    ``dconv_forward`` does in the JAX package.
    """

    def __init__(self, s: DConvSpec):
        super().__init__()
        self.spec = s
        hidden = int(s.channels / s.compress)
        layers = []
        for d in range(abs(s.depth)):
            dilation = 2 ** d if s.dilate else 1
            padding = dilation * (s.kernel // 2)
            mods = [nn.Conv1d(s.channels, hidden, s.kernel, dilation=dilation, padding=padding),
                    _norm(s.norm, 1, hidden), nn.GELU() if s.gelu else nn.ReLU()]
            if s.lstm:
                mods.append(BLSTM(hidden, layers=2, max_steps=200, skip=True))
            if s.attn:
                mods.append(LocalState(hidden, heads=s.heads, ndecay=s.ndecay))
            mods += [nn.Conv1d(hidden, 2 * s.channels, 1), _norm(s.norm, 1, 2 * s.channels),
                     nn.GLU(1), LayerScale(s.channels, s.init)]
            layers.append(nn.Sequential(*mods))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        act = ops.gelu if s.gelu else torch.relu
        for d, layer in enumerate(self.layers):
            conv1, norm1, _, *middle, conv2, norm2, _, scale = layer
            dilation = 2 ** d if s.dilate else 1
            # One step per line, so that each intermediate is freed as soon
            # as the next exists (as in Sequential.forward): these are the
            # largest activations of the freq branch.
            y = ops.conv1d(x, conv1.weight, conv1.bias, dilation=dilation,
                           padding=dilation * (s.kernel // 2))
            y = _maybe_norm(norm1, y)
            y = act(y)
            for mod in middle:  # BLSTM, then LocalState
                y = mod(y)
            y = ops.conv1d(y, conv2.weight, conv2.bias)
            y = _maybe_norm(norm2, y)
            y = ops.glu(y, axis=1)
            x = x + scale(y)
        return x


def _dconv_on_branch(dconv: DConv, y: torch.Tensor, freq: bool) -> torch.Tensor:
    """The freq branch runs DConv over every frequency row as one batch."""
    if freq:
        B, C, Fr, T = y.shape
        y = y.permute(0, 2, 1, 3).reshape(-1, C, T)
        y = dconv(y)
        return y.reshape(B, Fr, C, T).permute(0, 2, 1, 3)
    return dconv(y)


class HEncLayer(nn.Module):
    """Encoder layer (``demucs/hdemucs.py:69-157``): conv, norm, GELU, DConv,
    rewrite conv, norm, GLU."""

    def __init__(self, s: EncSpec):
        super().__init__()
        if s.multi_freqs:
            raise ValueError("a spec with multi_freqs makes a MultiWrap: use enc_layer")
        self.spec = s
        if s.freq:
            self.conv = nn.Conv2d(s.chin, s.chout, (s.kernel, 1), (s.stride, 1), (s.pad, 0))
        else:
            self.conv = nn.Conv1d(s.chin, s.chout, s.kernel, s.stride, s.pad)
        if s.empty:
            return
        self.norm1 = _norm(s.norm, s.norm_groups, s.chout)
        if s.rewrite:
            k = 1 + 2 * s.context
            if s.freq:
                self.rewrite = nn.Conv2d(s.chout, 2 * s.chout, k, 1, s.context)
            else:
                self.rewrite = nn.Conv1d(s.chout, 2 * s.chout, k, 1, s.context)
            self.norm2 = _norm(s.norm, s.norm_groups, 2 * s.chout)
        if s.dconv is not None:
            self.dconv = DConv(s.dconv)

    def forward(self, x: torch.Tensor, inject: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.spec
        if not s.freq and x.dim() == 4:
            B, C, Fr, T = x.shape
            x = x.reshape(B, -1, T)
        if s.freq:
            y = ops.conv2d(x, self.conv.weight, self.conv.bias, stride=(s.stride, 1),
                           padding=(s.pad, 0))
        else:
            le = x.shape[-1]
            if le % s.stride != 0:
                x = nn.functional.pad(x, (0, s.stride - le % s.stride))
            y = ops.conv1d(x, self.conv.weight, self.conv.bias, stride=s.stride, padding=s.pad)
        if s.empty:
            return y
        if inject is not None:
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = ops.gelu(_maybe_norm(self.norm1, y))
        if s.dconv is not None:
            y = _dconv_on_branch(self.dconv, y, s.freq)
        if s.rewrite:
            conv = ops.conv2d if s.freq else ops.conv1d
            z = _maybe_norm(self.norm2, conv(y, self.rewrite.weight, self.rewrite.bias,
                                             padding=s.context))
            z = ops.glu(z, axis=1)
        else:
            z = y
        return z


class HDecLayer(nn.Module):
    """Decoder layer (``demucs/hdemucs.py:256-335``): skip add, rewrite conv,
    norm, GLU, DConv, transposed conv, norm, GELU. ``forward`` returns
    ``(z, pre)``."""

    def __init__(self, s: DecSpec):
        super().__init__()
        if s.multi_freqs:
            raise ValueError("a spec with multi_freqs makes a MultiWrap: use dec_layer")
        self.spec = s
        if s.freq:
            self.conv_tr = nn.ConvTranspose2d(s.chin, s.chout, (s.kernel, 1), (s.stride, 1))
        else:
            self.conv_tr = nn.ConvTranspose1d(s.chin, s.chout, s.kernel, s.stride)
        self.norm2 = _norm(s.norm, s.norm_groups, s.chout)
        if s.empty:
            return
        if s.rewrite:
            k = 1 + 2 * s.context
            if s.freq:
                if s.context_freq:
                    self.rewrite = nn.Conv2d(s.chin, 2 * s.chin, k, 1, s.context)
                else:
                    self.rewrite = nn.Conv2d(s.chin, 2 * s.chin, (1, k), 1, (0, s.context))
            else:
                self.rewrite = nn.Conv1d(s.chin, 2 * s.chin, k, 1, s.context)
            self.norm1 = _norm(s.norm, s.norm_groups, 2 * s.chin)
        if s.dconv is not None:
            self.dconv = DConv(s.dconv)

    def forward(self, x: torch.Tensor, skip: tp.Optional[torch.Tensor],
                length: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        s = self.spec
        if s.freq and x.dim() == 3:
            B, C, T = x.shape
            x = x.reshape(B, s.chin, -1, T)
        if not s.empty:
            x = x + skip
            if s.rewrite:
                w, b = self.rewrite.weight, self.rewrite.bias
                if not s.freq:
                    y = ops.conv1d(x, w, b, padding=s.context)
                elif s.context_freq:
                    y = ops.conv2d(x, w, b, padding=(s.context, s.context))
                else:
                    y = ops.conv2d(x, w, b, padding=(0, s.context))
                y = _maybe_norm(self.norm1, y)
                y = ops.glu(y, axis=1)
            else:
                y = x
            if s.dconv is not None:
                y = _dconv_on_branch(self.dconv, y, s.freq)
        else:
            y = x
            if skip is not None:
                raise ValueError("an empty decoder layer takes no skip")
        if s.freq:
            z = ops.conv_transpose2d(y, self.conv_tr.weight, self.conv_tr.bias,
                                     stride=(s.stride, 1))
        else:
            z = ops.conv_transpose1d(y, self.conv_tr.weight, self.conv_tr.bias, stride=s.stride)
        z = _maybe_norm(self.norm2, z)
        if s.freq:
            if s.pad:
                z = z[..., s.pad : -s.pad, :]
        else:
            z = z[..., s.pad : s.pad + length]
            if z.shape[-1] != length:
                raise AssertionError((z.shape[-1], length))
        if not s.last:
            z = ops.gelu(z)
        return z, y


class MultiWrapEnc(nn.Module):
    """Encoder MultiWrap (``demucs/hdemucs.py:160-224``): the frequency axis
    split into bands at ``multi_freqs`` (then the rest), each band through its
    own unpadded replica with explicit edge padding, the outputs concatenated.
    The band limits are the JAX package's arithmetic (hlayers.py:537-568)."""

    def __init__(self, s: EncSpec):
        super().__init__()
        self.spec = s
        sub = dataclasses.replace(s, multi_freqs=(), pad=0)
        self.layers = nn.ModuleList(HEncLayer(sub) for _ in range(len(s.multi_freqs) + 1))

    def forward(self, x: torch.Tensor, inject: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if inject is not None:
            raise ValueError("a MultiWrap layer takes no injection")
        s = self.spec
        Fr = x.shape[2]
        pad = s.kernel // 4
        start = 0
        outs = []
        for layer, ratio in zip(self.layers, list(s.multi_freqs) + [1]):
            if ratio == 1:
                limit = Fr
            else:
                limit = int(round(Fr * ratio))
                le = limit - start
                if start == 0:
                    le += pad
                frames = round((le - s.kernel) / s.stride + 1)
                limit = start + (frames - 1) * s.stride + s.kernel
                if start == 0:
                    limit -= pad
            if not (0 < limit - start and limit <= Fr):
                raise AssertionError((start, limit, Fr))
            y = x[:, :, start:limit, :]
            if start == 0:
                y = nn.functional.pad(y, (0, 0, pad, 0))
            if ratio == 1:
                y = nn.functional.pad(y, (0, 0, 0, pad))
            outs.append(layer(y))
            start = limit - s.kernel + s.stride
        return torch.cat(outs, dim=2)


class MultiWrapDec(nn.Module):
    """Decoder MultiWrap (``demucs/hdemucs.py:226-253``): per-band transposed
    convolutions, unpadded and without their own GELU, stitched at the band
    edges: each band's first ``stride`` rows are added to the previous band's
    last ones, less the bias counted twice. ``forward`` returns ``(z, None)``."""

    def __init__(self, s: DecSpec):
        super().__init__()
        self.spec = s
        sub = dataclasses.replace(s, multi_freqs=(), pad=0, last=True)
        self.layers = nn.ModuleList(HDecLayer(sub) for _ in range(len(s.multi_freqs) + 1))

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                length: int) -> tp.Tuple[torch.Tensor, None]:
        s = self.spec
        Fr = x.shape[2]
        start = 0
        outs: tp.List[torch.Tensor] = []
        for layer, ratio in zip(self.layers, list(s.multi_freqs) + [1]):
            limit = Fr if ratio == 1 else int(round(Fr * ratio))
            out, _ = layer(x[:, :, start:limit], skip[:, :, start:limit], length)
            if outs:
                bias = layer.conv_tr.bias.reshape(1, -1, 1, 1)
                prev = outs[-1]
                edge = prev[:, :, -s.stride:] + out[:, :, :s.stride] - bias
                outs[-1] = torch.cat([prev[:, :, :-s.stride], edge], dim=2)
                out = out[:, :, s.stride:]
            if ratio == 1:
                out = out[:, :, :-s.stride // 2, :]
            if start == 0:
                out = out[:, :, s.stride // 2:, :]
            outs.append(out)
            start = limit
        out = torch.cat(outs, dim=2)
        if not s.last:
            out = ops.gelu(out)
        return out, None


def enc_layer(s: EncSpec) -> nn.Module:
    """The encoder layer of spec ``s``: a MultiWrap where ``s.multi_freqs`` is set."""
    return MultiWrapEnc(s) if s.multi_freqs else HEncLayer(s)


def dec_layer(s: DecSpec) -> nn.Module:
    """The decoder layer of spec ``s``: a MultiWrap where ``s.multi_freqs`` is set."""
    return MultiWrapDec(s) if s.multi_freqs else HDecLayer(s)


class ScaledEmbedding(nn.Module):
    """Embedding whose stored weight is multiplied by ``scale``
    (``demucs/hdemucs.py:43-66``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, scale: float = 10.0):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.scale = scale

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return ops.embedding(ids, self.embedding.weight) * self.scale
