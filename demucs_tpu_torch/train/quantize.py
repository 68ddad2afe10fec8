"""Quantization-aware training: DiffQ (learned bit depths through pseudo
quantization noise) and fixed-bit QAT (port of ``demucs_tpu/train/quantize.py``;
behavioral reference: ``diffq.DiffQuantizer`` / ``UniformQuantizer`` as
``demucs/states.py:23-47`` and ``demucs/solver.py:339-342`` use them).

DiffQ (Défossez, Adi, Synnaeve, "Differentiable Model Compression via Pseudo
Quantization Noise"): in training each group of ``group_size`` weights of a
large parameter gets additive noise of the uniform quantization error's std
at a learnable bit depth (one logit per group), and the loss carries
``penalty * model_size_mb``; at validation and export the weights are
quantized at the rounded learned depths. QAT quantizes at fixed ``bits``
with a straight-through estimator (``w + (q - w).detach()``).

The functions map ``{dotted name: tensor}`` to the substituted tensors of
the quantized names only; :class:`Quantizer` holds a run's state (the names,
DiffQ's logits and their own Adam at ``logit_lr``, as diffq's
``setup_optimizer``) and puts the substituted weights into the module for a
step (:func:`substituted`). The group walk and the container are
``zoo/diffq.py``'s, so an export loads back through ``zoo``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import typing as tp

import numpy as np
import torch

__all__ = ["QuantSpec", "make_spec", "quantized_param_names", "init_logits",
           "bits_from_logits", "noisy_params", "ste_params", "eval_params", "model_size_mb",
           "hard_quantized_state", "Quantizer", "substituted"]

Params = tp.Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    mode: str                 # "diffq" | "qat"
    penalty: float = 0.0      # DiffQ's model-size loss weight
    bits: int = 8             # QAT's fixed bit depth
    min_size: float = 0.2     # MB of fp32 at or below which a parameter stays fp32
    group_size: int = 8
    min_bits: float = 2.0
    max_bits: float = 15.0
    init_bits: float = 8.0
    logit_lr: float = 1e-3


def make_spec(args) -> tp.Optional[QuantSpec]:
    """``TrainArgs.quant`` -> a QuantSpec, None when quantization is off."""
    q = args.quant
    if q.diffq:
        return QuantSpec(mode="diffq", penalty=float(q.diffq), min_size=q.min_size,
                         group_size=q.group_size)
    if q.qat:
        # UniformQuantizer: one range per tensor
        return QuantSpec(mode="qat", bits=int(q.qat), min_size=q.min_size, group_size=0)
    return None


def quantized_param_names(kind: str, cfg, spec: QuantSpec) -> tp.Tuple[str, ...]:
    """Names of the parameters above ``min_size`` MB, in the container's walk order."""
    from demucs_tpu_torch.zoo.diffq import _partition, param_order

    big, _small = _partition(param_order(kind, cfg), spec.min_size)
    if spec.group_size:
        for name, shape in big:
            numel = int(np.prod(shape))
            if numel % spec.group_size:
                raise ValueError(f"{name}: numel {numel} not divisible by group_size "
                                 f"{spec.group_size}")
    return tuple(name for name, _ in big)


def _groups(w: torch.Tensor, group_size: int) -> torch.Tensor:
    return w.reshape(-1, group_size) if group_size else w.reshape(1, -1)


def init_logits(params: Params, names: tp.Sequence[str], spec: QuantSpec
                ) -> tp.Dict[str, torch.Tensor]:
    """One fp32 logit per weight group, at ``init_bits``."""
    p0 = (spec.init_bits - spec.min_bits) / (spec.max_bits - spec.min_bits)
    l0 = math.log(p0 / (1.0 - p0))
    return {name: torch.full((_groups(params[name], spec.group_size).shape[0],), l0,
                             dtype=torch.float32, device=params[name].device)
            for name in names}


def bits_from_logits(logit: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    return spec.min_bits + (spec.max_bits - spec.min_bits) * torch.sigmoid(logit)


def noisy_params(params: Params, logits: Params, spec: QuantSpec,
                 generator: tp.Optional[torch.Generator] = None,
                 noise: tp.Optional[Params] = None) -> tp.Dict[str, torch.Tensor]:
    """DiffQ's training weights: each group plus standard normal noise times
    delta / sqrt(12), delta = the group's range / (2^bits - 1) (the range
    held constant), differentiable in the weights and the logits. The noise
    is drawn per name in sorted order from ``generator`` (on the weights'
    device), or given (``noise``, one tensor per name)."""
    out = {}
    for name in sorted(logits):
        w = params[name]
        g = _groups(w, spec.group_size)
        bits = bits_from_logits(logits[name], spec)[:, None]
        span = (g.amax(dim=-1, keepdim=True) - g.amin(dim=-1, keepdim=True)).detach()
        delta = span / (2.0 ** bits - 1.0)
        if noise is not None:
            z = noise[name].to(device=w.device, dtype=w.dtype).reshape(g.shape)
        else:
            z = torch.randn(g.shape, generator=generator, device=w.device, dtype=w.dtype)
        out[name] = (g + z * (delta / math.sqrt(12.0))).reshape(w.shape)
    return out


def _quant_dequant(g: torch.Tensor, bits: tp.Union[torch.Tensor, float]) -> torch.Tensor:
    """Quantize-dequantize groups ``(G, n)`` over each group's [min, max] at
    ``bits`` (``(G, 1)`` or a number): the container's codec."""
    mn = g.amin(dim=-1, keepdim=True)
    mx = g.amax(dim=-1, keepdim=True)
    nlev = 2.0 ** bits - 1.0
    span = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    levels = torch.round((g - mn) / span * nlev)
    return levels / nlev * (mx - mn) + mn


def ste_params(params: Params, names: tp.Sequence[str], spec: QuantSpec
               ) -> tp.Dict[str, torch.Tensor]:
    """QAT's training weights: the forward sees the weights quantized at
    ``spec.bits``, the gradient passes straight through."""
    out = {}
    for name in names:
        w = params[name]
        q = _quant_dequant(_groups(w, spec.group_size), float(spec.bits)).reshape(w.shape)
        out[name] = w + (q - w).detach()
    return out


def eval_params(params: Params, logits: Params, spec: QuantSpec) -> tp.Dict[str, torch.Tensor]:
    """DiffQ's evaluation weights: quantized at the rounded learned depths
    (diffq's eval-mode forward pre-hook), as the export stores them."""
    out = {}
    for name in sorted(logits):
        w = params[name]
        bits = torch.clamp(torch.round(bits_from_logits(logits[name], spec)), 1.0, 15.0)
        out[name] = _quant_dequant(_groups(w, spec.group_size), bits[:, None]).reshape(w.shape)
    return out


def model_size_mb(logits: Params, spec: QuantSpec) -> torch.Tensor:
    """The quantized parameters' size in MB, differentiable in the logits:
    the sum over groups of group_size x bits, in bytes (DiffQ's penalty)."""
    total = 0.0
    for name in sorted(logits):
        total = total + (bits_from_logits(logits[name], spec) * spec.group_size).sum()
    return total / 8.0 / 2.0**20


def hard_quantized_state(params: tp.Mapping[str, tp.Any], logits: tp.Optional[Params],
                         spec: QuantSpec, kind: str, cfg) -> dict:
    """The export: a ``__quantized`` container (``zoo/diffq.py``'s layout) at
    the learned depths per group (DiffQ) or QAT's fixed bits."""
    from demucs_tpu_torch.zoo.diffq import _partition, param_order, quantize_entry

    def host(v) -> np.ndarray:
        return (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))

    big, small = _partition(param_order(kind, cfg), spec.min_size)
    quantized = []
    for name, _shape in big:
        bits: tp.Union[int, np.ndarray] = spec.bits
        if logits is not None:
            learned = bits_from_logits(logits[name].detach().cpu(), spec).numpy()
            bits = np.clip(np.round(learned), 1, 15).astype(np.uint8)
        quantized.append(quantize_entry(host(params[name]), spec.group_size, bits))
    return {
        "__quantized": True,
        "quantized": quantized,
        "others": [host(params[name]) for name, _ in small],
        "float16": [],
        "meta": {"klass": "DiffQuantizer" if spec.mode == "diffq" else "UniformQuantizer",
                 "init_kwargs": ({"min_size": spec.min_size, "group_size": spec.group_size}
                                 if spec.mode == "diffq" else
                                 {"min_size": spec.min_size, "bits": spec.bits})},
    }


@contextlib.contextmanager
def substituted(module: torch.nn.Module, tensors: Params):
    """Run the block with ``tensors`` in place of ``module``'s parameters of
    those names, as ``torch.func.functional_call`` does, but for the whole
    block: the forward and the backward, where ``remat`` recomputes layers."""
    if not tensors:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module

    with _reparametrize_module(module, dict(tensors)):
        yield


class Quantizer:
    """A run's quantization state over a ``Model``: the spec, the quantized
    names, and for DiffQ the logits (leaf tensors on the model's device) and
    their Adam."""

    def __init__(self, spec: QuantSpec, model):
        self.spec = spec
        self.names = quantized_param_names(model.kind, model.cfg, spec)
        params = dict(model.module.named_parameters())
        self.logits: tp.Optional[tp.Dict[str, torch.Tensor]] = None
        self.optimizer: tp.Optional[torch.optim.Optimizer] = None
        if spec.mode == "diffq":
            self.logits = {n: t.requires_grad_() for n, t in
                           init_logits(params, self.names, spec).items()}
            # optax.adam(logit_lr)'s betas (0.9, 0.999) and eps 1e-8 are Adam's defaults
            self.optimizer = torch.optim.Adam(list(self.logits.values()), lr=spec.logit_lr)
        # QAT's size is constant: the quantized weights at their fixed bits
        self.qat_mb = (sum(params[n].numel() for n in self.names) * spec.bits / 8.0 / 2.0**20
                       if spec.mode == "qat" else 0.0)

    def train_params(self, params: Params, generator: tp.Optional[torch.Generator] = None,
                     noise: tp.Optional[Params] = None) -> tp.Dict[str, torch.Tensor]:
        """The step's substituted weights: DiffQ's noisy ones (the noise drawn
        on the weights' device from a generator seeded by ``generator``, or
        given), QAT's straight-through ones."""
        if self.logits is None:
            return ste_params(params, self.names, self.spec)
        device = next(iter(params.values())).device
        gen = None
        if noise is None:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            gen = torch.Generator(device=device).manual_seed(seed)
        return noisy_params(params, self.logits, self.spec, generator=gen, noise=noise)

    def size_mb(self) -> tp.Union[torch.Tensor, float]:
        return model_size_mb(self.logits, self.spec) if self.logits is not None else self.qat_mb

    def eval_params(self, params: Params) -> tp.Dict[str, torch.Tensor]:
        """The weights validation sees: DiffQ's at the rounded learned depths,
        QAT's at the fixed bits."""
        with torch.no_grad():
            if self.logits is None:
                return ste_params(params, self.names, self.spec)
            return eval_params(params, self.logits, self.spec)

    def state_dict(self) -> dict:
        if self.logits is None:
            return {}
        return {"qlogits": {n: t.detach().cpu().numpy() for n, t in self.logits.items()},
                "qoptimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if self.logits is None:
            return
        with torch.no_grad():
            for name, value in state["qlogits"].items():
                self.logits[name].copy_(torch.as_tensor(np.asarray(value)))
        self.optimizer.load_state_dict(state["qoptimizer"])
