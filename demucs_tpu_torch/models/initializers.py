"""Seeded random weights in the JAX package's numbers
(port of ``demucs_tpu/models/initializers.py`` for HDemucs and Demucs v2).

``demucs_tpu.models.initializers.Init`` draws every tensor from one
``numpy.random.default_rng(seed)``, in the order its ``init_*`` functions
build the parameter tree: U(+-1/sqrt(fan_in)) for convolutions and linear
maps, the Demucs rescale trick on convolutions, U(+-1/sqrt(hidden)) for LSTM
weights, a smoothed normal embedding; norms at 1 and 0 and LayerScales at
their init take no draw. :class:`Init` repeats those draws in the same
order and the same float32 arithmetic and writes them into a module's
tensors, so that ``init_hdemucs(cfg, seed)`` and ``init_demucs(cfg, seed)``
give the JAX package's weights at the same seed. The module is walked in
registration order, which is the JAX draw order except inside LocalState
(its ``query_decay`` is drawn first) and in Demucs v2 (encoder and decoder
layers interleaved; the caller passes that order).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from demucs_tpu_torch.models import hlayers as hl

_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


def _set(t: torch.Tensor, value: np.ndarray) -> None:
    t.copy_(torch.from_numpy(np.ascontiguousarray(value)))


class Init:
    """One seeded numpy generator, drawing into modules as the JAX package's
    ``Init`` draws into its parameter tree."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def _uniform(self, shape, bound: float) -> np.ndarray:
        return self.rng.uniform(-bound, bound, size=tuple(shape)).astype(np.float32)

    def conv(self, mod: nn.Module, rescale: tp.Optional[float]) -> None:
        bound = 1.0 / math.sqrt(int(np.prod(mod.weight.shape[1:])))
        w = self._uniform(mod.weight.shape, bound)
        b = self._uniform(mod.bias.shape, bound)
        if rescale:  # demucs.py:70-83
            scale = (w.std() / rescale) ** 0.5
            w /= scale
            b /= scale
        _set(mod.weight, w)
        _set(mod.bias, b)

    def linear(self, mod: nn.Linear) -> None:
        bound = 1.0 / math.sqrt(mod.in_features)
        _set(mod.weight, self._uniform(mod.weight.shape, bound))
        _set(mod.bias, self._uniform(mod.bias.shape, bound))

    def lstm(self, mod: nn.LSTM) -> None:
        bound = 1.0 / math.sqrt(mod.hidden_size)
        for _, p in mod.named_parameters():  # (layer, direction, ih/hh weight, biases)
            _set(p, self._uniform(p.shape, bound))

    def embedding(self, mod: hl.ScaledEmbedding, smooth: bool) -> None:
        num, _ = mod.embedding.weight.shape
        w = self.rng.standard_normal(tuple(mod.embedding.weight.shape)).astype(np.float32)
        if smooth:
            w = np.cumsum(w, axis=0) / np.sqrt(np.arange(1, num + 1, dtype=np.float32))[:, None]
        _set(mod.embedding.weight, w / mod.scale)

    def module(self, root: nn.Module, rescale: tp.Optional[float], emb_smooth: bool = True) -> None:
        """Draw every tensor of ``root`` in the JAX package's order."""
        done: tp.Set[int] = set()
        for mod in root.modules():
            if id(mod) in done:
                continue
            if isinstance(mod, hl.LocalState):
                subs = ([mod.query_decay] if mod.ndecay else []) + [
                    mod.content, mod.query, mod.key, mod.proj]
                for sub in subs:
                    self.conv(sub, rescale)
                    done.add(id(sub))
                if mod.ndecay:  # a decay near zero behind the sigmoid: the widest window
                    mod.query_decay.weight.mul_(0.01)
                    mod.query_decay.bias.fill_(-2.0)
            elif isinstance(mod, _CONVS):
                self.conv(mod, rescale)
            elif isinstance(mod, nn.Linear):
                self.linear(mod)
            elif isinstance(mod, nn.LSTM):
                self.lstm(mod)
            elif isinstance(mod, hl.ScaledEmbedding):
                self.embedding(mod, emb_smooth)

    def finish(self, root: nn.Module, layer_scale: tp.Optional[float],
               random_norms: bool) -> None:
        """The test options, after the JAX package's draws: every LayerScale
        at ``layer_scale``; with ``random_norms`` every GroupNorm weight
        ``1 + 0.3 N(0, 1)`` and bias ``0.3 N(0, 1)``, in module order."""
        for mod in root.modules():
            if isinstance(mod, hl.LayerScale) and layer_scale is not None:
                mod.scale.fill_(layer_scale)
            elif isinstance(mod, nn.GroupNorm) and random_norms:
                _set(mod.weight, 1 + 0.3 * self.rng.standard_normal(mod.weight.shape))
                _set(mod.bias, 0.3 * self.rng.standard_normal(mod.bias.shape))
