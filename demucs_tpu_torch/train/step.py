"""One training step: loss, gradients, clipping, optimizer (port of
``demucs_tpu/train/step.py`` and of ``make_optimizer`` in
``demucs_tpu/train/solver.py``; behavioral reference ``demucs/solver.py:291-405``).

The per-source weighted time-domain loss (l1 or mse, with the reference's
mse quirks), the forward in train mode through the model's kernels (K1,
K2's backward, K3 and its backward on the card), the gradient's global norm
(before clipping), clipping by that norm, and the optimizer: optax's chains
mapped onto ``torch.optim.Adam`` / ``AdamW`` (see :func:`make_optimizer`).
With a quantizer (``train/quantize.py``) the forward runs on DiffQ's noisy or
QAT's straight-through weights, and DiffQ's model-size term joins the loss;
with an SVD penalty (``train/svd.py``) on a step where it fires, its weighted
term joins it too. The gradient's norm and clipping cover the model's
parameters only (DiffQ's logits have their own Adam).
"""

from __future__ import annotations

import typing as tp

import torch

from demucs_tpu_torch.models.registry import Model

__all__ = ["source_loss", "make_optimizer", "forward_loss", "backward_precision",
           "clip_and_step", "train_step"]


def source_loss(estimate: torch.Tensor, sources: torch.Tensor, kind: str,
                weights: tp.Sequence[float]) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The reference's weighted per-source loss (solver.py:324-336) of
    ``estimate`` against ``sources``, both ``(B, S, C, T)`` -> ``(loss,
    reco_per_source (S,))``. For mse the reference sums the loss over the
    batch (its loss matrix stays ``(B, S)`` through the weighting) and
    reports the RMSE as reco: both quirks kept."""
    w = torch.as_tensor(weights, dtype=estimate.dtype, device=estimate.device)
    if kind == "l1":
        per_source = (estimate - sources).abs().mean(dim=(0, 2, 3))
        loss_mat = per_source
    elif kind == "mse":
        per_elem = ((estimate - sources) ** 2).mean(dim=(2, 3))  # (B, S)
        per_source = per_elem.sqrt().mean(dim=0)
        loss_mat = per_elem.sum(dim=0)
    else:
        raise ValueError(f"Invalid loss {kind}")
    return (loss_mat * w).sum() / w.sum(), per_source


def _groups(model: Model, lr: float, wd: float) -> list:
    """One parameter group, or HTDemucs's two: its transformer with ``t_lr``
    and ``t_weight_decay`` (transformer.py:715-719 make_optim_group), when
    either is set (the JAX package's condition)."""
    params = list(model.module.named_parameters())
    t_lr = getattr(model.cfg, "t_lr", None)
    t_wd = getattr(model.cfg, "t_weight_decay", 0.0)
    if not (model.kind == "htdemucs" and (t_lr is not None or t_wd)):
        return [{"params": [p for _, p in params], "lr": lr, "weight_decay": wd}]
    inside = [p for n, p in params if n.split(".")[0] == "crosstransformer"]
    outside = [p for n, p in params if n.split(".")[0] != "crosstransformer"]
    return [{"params": outside, "lr": lr, "weight_decay": wd},
            {"params": inside, "lr": t_lr if t_lr is not None else lr, "weight_decay": t_wd}]


def make_optimizer(args, model: Model) -> torch.optim.Optimizer:
    """``args.optim``'s optimizer over ``model``'s parameters, optax's
    ``make_optimizer`` of the JAX package step for step:

    - ``"adam"``: ``add_decayed_weights`` before ``scale_by_adam`` (the
      decay joins the gradient, L2) = ``torch.optim.Adam(weight_decay=wd)``;
    - ``"adamw"``: the decay after the moments = ``torch.optim.AdamW``;

    with ``betas = (momentum, beta2)``, eps 1e-8, and HTDemucs's transformer
    group (:func:`_groups`). Clipping by the global norm over every parameter
    comes before the group split, in :func:`clip_and_step`."""
    opt = args.optim
    groups = _groups(model, opt.lr, opt.weight_decay)
    # on the card one fused launch updates every parameter (the same arithmetic)
    fused = all(p.is_cuda for g in groups for p in g["params"])
    kw = dict(betas=(opt.momentum, opt.beta2), eps=1e-8, fused=fused)
    if opt.optim == "adam":
        return torch.optim.Adam(groups, **kw)
    if opt.optim == "adamw":
        return torch.optim.AdamW(groups, **kw)
    raise ValueError(f"Invalid optimizer {opt.optim}")


def forward_loss(model: Model, sources: torch.Tensor, loss: str, weights: tp.Sequence[float],
                 generator: tp.Optional[torch.Generator] = None):
    """The mixture (the sum of ``sources (B, S, C, T)``), the forward in train
    mode, the loss -> ``(loss, reco_per_source)``."""
    mix = sources.sum(dim=1)
    kw = {"generator": generator} if model.kind == "htdemucs" else {}
    estimate = model.module(mix, **kw)
    if estimate.shape != sources.shape:
        raise AssertionError(f"estimate {tuple(estimate.shape)} for sources "
                             f"{tuple(sources.shape)}")
    return source_loss(estimate, sources, loss, weights)


def backward_precision(model: Model):
    """The precision scope of the backward: the forward's model-wide one (an
    HTDemucs's ``matmul_precision`` or ``compute_dtype``, else full fp32 with
    TF32 off), since autograd runs the backward outside the forward's scopes;
    per-stage ``precision_stages`` hold in the forward only."""
    from demucs_tpu_torch.models.htdemucs import _matmul_precision, precision_scope

    return precision_scope(_matmul_precision(model.cfg) if model.kind == "htdemucs" else None)


def clip_and_step(optimizer: torch.optim.Optimizer, clip_grad: float) -> torch.Tensor:
    """The gradients' global norm over every parameter of ``optimizer``
    (returned, before clipping), ``optax.clip_by_global_norm(clip_grad)``
    (scale by ``clip_grad / norm`` where the norm exceeds it), then the
    optimizer's step. A parameter without a gradient gets zeros, as optax
    updates every leaf."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = torch.nn.utils.get_total_norm([p.grad for p in params])  # optax.global_norm
    if clip_grad:
        scale = torch.where(norm < clip_grad, torch.ones_like(norm), clip_grad / norm)
        torch._foreach_mul_([p.grad for p in params], scale)
    optimizer.step()
    return norm


def train_step(model: Model, optimizer: torch.optim.Optimizer, sources: torch.Tensor, *,
               loss: str = "l1", weights: tp.Sequence[float] = (1.0, 1.0, 1.0, 1.0),
               clip_grad: float = 0.0, generator: tp.Optional[torch.Generator] = None,
               augment: tp.Optional[tp.Callable] = None, quantizer=None,
               quant_noise: tp.Optional[tp.Mapping[str, torch.Tensor]] = None,
               svd=None) -> dict:
    """One step on ``sources (B, S, C, T)`` on the model's device: augment
    (``augment(sources, generator)``), forward, loss, backward, clip, update.
    ``quantizer``: a ``quantize.Quantizer`` (DiffQ's noise drawn from
    ``generator``, or ``quant_noise``); ``svd``: an ``svd.SvdPenalty`` that
    fires this step. Returns ``{"loss", "reco" (S,), "grad_norm"}`` (with
    ``"ms"`` under a quantizer, ``"penalty"`` under ``svd``) as tensors on
    the device (no synchronisation)."""
    from demucs_tpu_torch.train.quantize import substituted

    if augment is not None:
        sources = augment(sources, generator)
    optimizer.zero_grad(set_to_none=True)
    params = dict(model.module.named_parameters())
    swapped = {}
    if quantizer is not None:
        if quantizer.optimizer is not None:
            quantizer.optimizer.zero_grad(set_to_none=True)
        swapped = quantizer.train_params(params, generator, quant_noise)
    out = {}
    with substituted(model.module, swapped):
        value, reco = forward_loss(model, sources, loss, weights, generator)
        with backward_precision(model):
            if svd is not None:
                out["penalty"] = svd(params, generator)
                value = value + svd.weight * out["penalty"]
            if quantizer is not None:
                out["ms"] = quantizer.size_mb()
                if quantizer.logits is not None:
                    value = value + quantizer.spec.penalty * out["ms"]
            value.backward()
    norm = clip_and_step(optimizer, clip_grad)
    if quantizer is not None and quantizer.optimizer is not None:
        quantizer.optimizer.step()
    out = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    return dict(out, loss=value.detach(), reco=reco.detach(), grad_norm=norm)
