"""The spectral penalty on large weight matrices (port of
``demucs_tpu/train/svd.py``; behavioral reference ``demucs/svd.py``).

The penalty is the sum of sigma_max^2 over every large conv, linear and LSTM
matrix: the exact SVD at validation, a randomized low-rank SVD (or the power
method, ``powm``) in training. Conv weights ``(O, I, K[, K])`` flatten to
``(O, -1)``; transposed convs ``(I, O, K[, K])`` are transposed first with
``convtr`` (the hybrid models name them ``.conv_tr.``, Demucs v2's decoder
holds them at positional names, ``models/demucs.py::convtr_param_names``);
1-D tensors are skipped, and with ``conv_only`` the 2-D ones too.

On tensors, differentiable, in ``torch.linalg`` (QR, ``svdvals``) and
``matmul``. The randomized probes come from an explicit ``torch.Generator``
(drawn on the CPU, moved to the weights' device), or are given per matrix
name (``probes``: the tests give the JAX package's draw). The skip
(``proba``) draws from a ``random.Random`` the caller owns: seeded with 1234,
as the reference's shared RNG (svd.py:25-28), it skips on the same steps as
the JAX package.
"""

from __future__ import annotations

import dataclasses
import random
import typing as tp

import torch

__all__ = ["PENALTY_SEED", "collect_matrices", "convtr_names_for", "power_iteration",
           "svd_lowrank_sq", "svd_total", "svd_penalty", "SvdPenalty"]

PENALTY_SEED = 1234  # svd.py:25: random.Random(1234), shared by every worker


def collect_matrices(params: tp.Mapping[str, torch.Tensor], min_size: float, convtr: bool,
                     conv_only: bool, convtr_names: tp.AbstractSet[str] = frozenset()
                     ) -> tp.List[tp.Tuple[str, torch.Tensor]]:
    """``(name, matrix)`` of every tensor the penalty covers, in ``params``' order."""
    mats = []
    for name, p in params.items():
        if p.numel() / 2**18 < min_size:
            continue
        if p.dim() in (3, 4):
            if convtr and (".conv_tr." in name or name in convtr_names):
                p = p.transpose(0, 1)
            p = p.reshape(p.shape[0], -1)
        elif p.dim() == 1 or conv_only:
            continue
        if p.dim() != 2:
            continue
        mats.append((name, p))
    return mats


def convtr_names_for(kind: str, cfg) -> tp.FrozenSet[str]:
    """Names of transposed-conv weights that are not named ``conv_tr``
    (Demucs v2's decoder); empty for the hybrid models."""
    if kind != "demucs":
        return frozenset()
    from demucs_tpu_torch.models.demucs import convtr_param_names

    return convtr_param_names(cfg)


def power_iteration(m: torch.Tensor, b: torch.Tensor, niters: int = 1) -> torch.Tensor:
    """The power method on a square PSD ``m`` from the probe ``b (dim, bs)``
    (svd.py:11-23): the mean over the probes of the last step's norm."""
    norm = torch.zeros((1, b.shape[1]), dtype=m.dtype, device=m.device)
    for _ in range(niters):
        n = m @ b
        norm = torch.linalg.vector_norm(n, dim=0, keepdim=True)
        b = n / (1e-10 + norm)
    return norm.mean()


def svd_lowrank_sq(p: torch.Tensor, q: torch.Tensor, niters: int) -> torch.Tensor:
    """sigma_max^2 of ``p (m, n)`` by randomized subspace iteration from the
    probe ``q (n, dim)`` (``torch.svd_lowrank``'s algorithm, Halko et al. 2009)."""
    q = p @ q
    for _ in range(niters):
        q, _ = torch.linalg.qr(q)
        q = p @ (p.T @ q)
    q, _ = torch.linalg.qr(q)
    return torch.linalg.svdvals(q.T @ p)[0] ** 2


def _probe(name: str, shape: tuple, like: torch.Tensor,
           generator: tp.Optional[torch.Generator],
           probes: tp.Optional[tp.Mapping[str, torch.Tensor]]) -> torch.Tensor:
    if probes is not None:
        q = probes[name]
        if tuple(q.shape) != shape:
            raise ValueError(f"probe for {name}: shape {tuple(q.shape)}, expected {shape}")
    else:
        if generator is None:
            raise ValueError("the randomized estimators need a generator or probes")
        q = torch.randn(shape, generator=generator, dtype=torch.float32)
    return q.to(device=like.device, dtype=like.dtype)


def svd_total(params: tp.Mapping[str, torch.Tensor], *, min_size: float = 0.1, dim: int = 1,
              niters: int = 2, powm: bool = False, convtr: bool = True, conv_only: bool = False,
              exact: bool = False, bs: int = 1, generator: tp.Optional[torch.Generator] = None,
              probes: tp.Optional[tp.Mapping[str, torch.Tensor]] = None,
              convtr_names: tp.AbstractSet[str] = frozenset()) -> torch.Tensor:
    """The sum of sigma_max^2 estimates, with no skip. ``probes``: one
    starting matrix per name, ``(n, dim)`` for the low-rank SVD of an ``(m,
    n)`` matrix, ``(min(m, n), bs)`` for the power method."""
    total = None
    for name, p in collect_matrices(params, min_size, convtr, conv_only, convtr_names):
        if exact:
            estimate = torch.linalg.svdvals(p).square().max()
        elif powm:
            a, b = p.shape
            n = p @ p.T if a < b else p.T @ p
            estimate = power_iteration(n, _probe(name, (n.shape[0], bs), p, generator, probes),
                                       niters)
        else:
            estimate = svd_lowrank_sq(p, _probe(name, (p.shape[1], dim), p, generator, probes),
                                      niters)
        total = estimate if total is None else total + estimate
    if total is None:
        device = next(iter(params.values())).device if params else None
        return torch.zeros((), device=device)
    return total


def svd_penalty(params: tp.Mapping[str, torch.Tensor], rng: random.Random, *,
                proba: float = 1.0, **kw) -> tp.Union[float, torch.Tensor]:
    """The penalty with the reference's skip (svd.py:31-83): 0.0 when
    ``rng.random() > proba``, else :func:`svd_total` unbiased by ``1 / proba``."""
    if rng.random() > proba:
        return 0.0
    return svd_total(params, **kw) / proba


@dataclasses.dataclass(frozen=True)
class SvdPenalty:
    """A run's penalty (``TrainArgs.svd`` with the model's transposed-conv
    names): :meth:`fires` draws the step's skip, calling it gives the
    randomized estimate unbiased by ``1 / proba``, :meth:`exact` the value
    that validation logs (with the skip, as the reference)."""

    weight: float
    proba: float = 1.0
    min_size: float = 0.1
    dim: int = 1
    niters: int = 2
    powm: bool = False
    convtr: bool = True
    conv_only: bool = False
    bs: int = 1
    convtr_names: tp.FrozenSet[str] = frozenset()

    @classmethod
    def from_args(cls, args, kind: str, cfg) -> "SvdPenalty":
        kw = dataclasses.asdict(args.svd)
        return cls(weight=kw.pop("penalty"), convtr_names=convtr_names_for(kind, cfg), **kw)

    def _kw(self) -> dict:
        return dict(min_size=self.min_size, dim=self.dim, niters=self.niters, powm=self.powm,
                    convtr=self.convtr, conv_only=self.conv_only, bs=self.bs,
                    convtr_names=self.convtr_names)

    def fires(self, rng: random.Random) -> bool:
        return rng.random() <= self.proba

    def __call__(self, params: tp.Mapping[str, torch.Tensor],
                 generator: tp.Optional[torch.Generator] = None,
                 probes: tp.Optional[tp.Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        return svd_total(params, generator=generator, probes=probes, **self._kw()) / self.proba

    def exact(self, params: tp.Mapping[str, torch.Tensor], rng: random.Random
              ) -> tp.Union[float, torch.Tensor]:
        return svd_penalty(params, rng, proba=self.proba, exact=True, **self._kw())
