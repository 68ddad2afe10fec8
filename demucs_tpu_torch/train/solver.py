"""The training loop (port of ``demucs_tpu/train/solver.py``; behavioral
reference ``demucs/solver.py``).

Per batch: augment, mixture, forward in train mode, weighted loss,
gradients, clipping, optimizer, batch EMAs (``train/step.py``). Per epoch:
validation through the port's ``apply_model`` (or one forward with
``valid_apply=False``) on the live weights and on each EMA, the best state,
the test set through the port's ``evaluate`` every ``test.every`` epochs and
at the last, the history (``history.json``) and an atomic checkpoint.

The checkpoint (``checkpoint.pkl``, a pickle of numpy arrays) holds
``state`` and ``best_state`` as ``{dotted name: array}`` dicts, the names of
the JAX package's parameter trees (``demucs_tpu.zoo.torch_load.nest_state``
and ``flatten_state`` convert), so weights cross between the packages; the
optimizer's state, the generator's and the EMAs' are the port's own. The best
model goes to ``best.dmx`` through ``zoo/native.py``, which
``demucs_tpu_torch.api.Separator`` loads. Every draw of a run comes from one
CPU ``torch.Generator`` seeded with ``args.seed`` and kept in the checkpoint,
but the SVD penalty's skip: a ``random.Random(1234)`` as the reference's
(``train/svd.py``), also kept.

With ``svd.penalty`` the penalty joins the loss on the steps where it fires,
and validation logs the exact one. With ``quant.diffq`` or ``quant.qat`` a
``quantize.Quantizer`` gives each step its weights (and DiffQ its size
term), validation runs on the quantized weights, the checkpoint holds
DiffQ's logits and their Adam, and :meth:`Solver.quantized_state` gives the
``__quantized`` container (``zoo/native.py::save_model(...,
quantized_state=...)`` writes it as a ``.dmx``).

On several processes (``train/distrib.py``) every rank runs the loop on its
share of the batches (the loaders are rank-sharded, validation too), the
step averages the gradients (``train/step.py``), the epoch's metrics are
averaged over the ranks (``distrib.average``), and rank 0 alone writes the
checkpoint, the history and ``best.dmx`` while the others wait at a barrier
(the reference's solver.py:284-287: concurrent renames from several ranks
would race).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pickle
import random
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch.evaluate import evaluate, new_sdr
from demucs_tpu_torch.inference.apply import apply_model
from demucs_tpu_torch.models.registry import Model, build_module
from demucs_tpu_torch.train import distrib
from demucs_tpu_torch.train.augment import AugmentConfig, make_augment
from demucs_tpu_torch.train.config import TrainArgs
from demucs_tpu_torch.train.ema import ModelEMA, swap
from demucs_tpu_torch.train.quantize import Quantizer, hard_quantized_state, make_spec
from demucs_tpu_torch.train.step import backward_precision, source_loss, train_step
from demucs_tpu_torch.train.svd import PENALTY_SEED, SvdPenalty
from demucs_tpu_torch.zoo.convert import flat_state, load_flat_state

__all__ = ["Solver", "MetricAverager"]

logger = logging.getLogger(__name__)


def _summary(metrics: dict) -> str:
    return " | ".join(f"{key.capitalize()}={val}" for key, val in metrics.items())


def _to_host(obj):
    """Tensors of a nested state -> numpy arrays (picklable, device-free)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_tensors(obj):
    """The inverse of :func:`_to_host`: numpy arrays -> CPU tensors (an
    optimizer's ``load_state_dict`` moves each to its parameter's device)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    return obj


def _merge_state(module: torch.nn.Module, source: tp.Mapping[str, np.ndarray]) -> None:
    """``load_state_dict(strict=False)`` semantics (solver.py:128-130): names
    in both load (a shape mismatch raises), the others stay."""
    current = module.state_dict()
    for name, value in source.items():
        if name in current and tuple(np.shape(value)) != tuple(current[name].shape):
            raise ValueError(f"size mismatch for {name}: checkpoint {np.shape(value)} vs "
                             f"model {tuple(current[name].shape)}")
    with torch.no_grad():
        for name, value in source.items():
            if name in current:
                current[name].copy_(torch.as_tensor(np.asarray(value)))


class MetricAverager:
    """Running average of metric dicts (demucs/utils.py:67-85, beta=1)."""

    def __init__(self):
        self.total: tp.Dict[str, float] = {}
        self.fix: tp.Dict[str, float] = {}

    def __call__(self, metrics: dict, weight: float = 1.0) -> dict:
        for key, value in metrics.items():
            self.total[key] = self.total.get(key, 0.0) + weight * float(value)
            self.fix[key] = self.fix.get(key, 0.0) + weight
        return {key: tot / self.fix[key] for key, tot in self.total.items()}


def _atomic_pickle(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


class Solver:
    """``Solver(loaders, model, optimizer, args, folder).train()``; ``model``
    is a port ``Model`` on the device to train on."""

    def __init__(self, loaders: dict, model: Model, optimizer: torch.optim.Optimizer,
                 args: TrainArgs, folder: tp.Union[str, Path]):
        self.args = args
        self.loaders = loaders
        self.model = model
        self.optimizer = optimizer
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.emas: tp.Dict[str, tp.List[ModelEMA]] = {"batch": [], "epoch": []}
        for kind in self.emas:
            for decay in getattr(args.ema, kind) or ():
                self.emas[kind].append(ModelEMA(model.module, decay))
        aug = args.augment
        self._augment = make_augment(AugmentConfig(
            shift=int(args.dset.samplerate * args.dset.shift), shift_same=aug.shift_same,
            flip=aug.flip, scale_proba=aug.scale.proba, scale_min=aug.scale.min,
            scale_max=aug.scale.max, remix_proba=aug.remix.proba,
            remix_group_size=aug.remix.group_size),
            full=bool(aug.scale.proba or aug.remix.proba))  # solver.py:57-61
        self.checkpoint_file = self.folder / "checkpoint.pkl"
        self.best_file = self.folder / "best.dmx"
        self.history: tp.List[dict] = []
        self.best_state: tp.Optional[dict] = None
        self.best_changed = False
        self.generator = torch.Generator().manual_seed(args.seed)
        self.penalty_rng = random.Random(PENALTY_SEED)
        self.svd = (SvdPenalty.from_args(args, model.kind, model.cfg) if args.svd.penalty > 0
                    else None)
        spec = make_spec(args)
        self.quantizer = Quantizer(spec, model) if spec is not None else None
        self.timing: tp.List[dict] = []  # per epoch: seconds waiting for batches, in steps
        self._reset()

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------ persistence

    def _state(self) -> dict:
        return flat_state(self.model.module)

    def _serialize(self, epoch: int) -> None:
        """The atomic checkpoint (solver.py:77-101), the periodic copy of
        ``save_every`` and, when the best state changed, ``best.dmx``."""
        package = {
            "state": self._state(),
            "optimizer": _to_host(self.optimizer.state_dict()),
            "history": [dict(m) for m in self.history],
            "best_state": self.best_state,
            "args": dataclasses.asdict(self.args),
            "generator": self.generator.get_state().numpy(),
            "penalty_rng": self.penalty_rng.getstate(),
        }
        if self.quantizer is not None:
            package["quant"] = _to_host(self.quantizer.state_dict())
        for kind, emas in self.emas.items():
            for k, ema in enumerate(emas):
                package[f"ema_{kind}_{k}"] = {"state": _to_host(ema.state), "count": ema.count}
        _atomic_pickle(self.checkpoint_file, package)
        every = self.args.save_every
        if every and (epoch + 1) % every == 0 and epoch + 1 != self.args.epochs:
            _atomic_pickle(self.folder / f"checkpoint_{epoch + 1}.pkl", package)
        if self.best_changed and self.best_state is not None:
            from demucs_tpu_torch.zoo.native import save_model

            # the fp32 masters, as trained (a bf16 stage rounds them when it is served)
            best = load_flat_state(build_module(self.model.kind, self.model.cfg).float(),
                                   self.best_state)
            tmp = self.best_file.with_suffix(".tmp")
            save_model(Model(self.model.kind, self.model.cfg, best), tmp,
                       training_args=dataclasses.asdict(self.args))
            os.replace(tmp, self.best_file)
        self.best_changed = False
        logger.info("Checkpoint written: epoch %d", epoch + 1)

    def _reset(self) -> None:
        """Resume from this XP's checkpoint, or warm-start (solver.py:103-132)."""
        if self.checkpoint_file.exists():
            logger.info("Loading checkpoint model: %s", self.checkpoint_file)
            with open(self.checkpoint_file, "rb") as f:
                package = pickle.load(f)
            _merge_state(self.model.module, package["state"])
            self.optimizer.load_state_dict(_to_tensors(package["optimizer"]))
            self.history[:] = package["history"]
            self.best_state = package.get("best_state")
            self.generator.set_state(torch.from_numpy(package["generator"]))
            if "penalty_rng" in package:  # checkpoints written since the SVD penalty
                self.penalty_rng.setstate(package["penalty_rng"])
            if self.quantizer is not None:
                self.quantizer.load_state_dict(_to_tensors(package["quant"]))
            for kind, emas in self.emas.items():
                for k, ema in enumerate(emas):
                    ema.load_state_dict(package[f"ema_{kind}_{k}"])
        elif self.args.continue_pretrained:
            from demucs_tpu_torch.zoo.pretrained import get_model

            pre = get_model(self.args.continue_pretrained, repo=self.args.pretrained_repo,
                            device=self.device)
            _merge_state(self.model.module, flat_state(pre.module))
        elif self.args.continue_from:
            source_file = self.folder.parent / str(self.args.continue_from) / "checkpoint.pkl"
            logger.info("Loading from %s", source_file)
            with open(source_file, "rb") as f:
                package = pickle.load(f)
            self.best_state = package.get("best_state")
            source = package["best_state"] if self.args.continue_best else package["state"]
            _merge_state(self.model.module, source)
            if self.args.continue_opt:
                self.optimizer.load_state_dict(_to_tensors(package["optimizer"]))

    # ------------------------------------------------------------------- loop

    def _format_train(self, metrics: dict) -> dict:
        out = {"loss": format(metrics["loss"], ".4f"), "reco": format(metrics["reco"], ".4f")}
        for key in ("nsdr", "grad", "ms", "penalty", "best", "bname"):
            if key in metrics:
                val = metrics[key]
                out[key] = val if isinstance(val, str) else format(val, ".4f")
        return out

    def train(self) -> None:
        """The epoch loop (solver.py:172-289)."""
        for epoch, metrics in enumerate(self.history):
            logger.info("Replay | Epoch %d | %s", epoch + 1,
                        _summary(self._format_train(metrics["train"])))
        for epoch in range(len(self.history), self.args.epochs):
            metrics: tp.Dict[str, tp.Any] = {"train": self._run_one_epoch(epoch)}
            logger.info("Train Summary | Epoch %d | %s", epoch + 1,
                        _summary(self._format_train(metrics["train"])))
            key = self.args.test.metric
            valid = self._run_one_epoch(epoch, train=False)
            best_valid, bname, state = valid, "main", None
            metrics["valid"] = {"main": valid}
            for kind, emas in self.emas.items():
                for k, ema in enumerate(emas):
                    with swap(self.model.module, ema.state):
                        v = self._run_one_epoch(epoch, train=False)
                    name = f"ema_{kind}_{k}"
                    metrics["valid"][name] = v
                    a, b = v[key], best_valid[key]
                    if key.startswith("nsdr"):
                        a, b = -a, -b
                    if a < b:
                        best_valid, state, bname = v, ema, name
            metrics["valid"].update(best_valid)
            metrics["valid"]["bname"] = bname
            valid_loss = metrics["valid"][key]
            past = [m["valid"][key] for m in self.history] + [valid_loss]
            best_loss = max(past) if key.startswith("nsdr") else min(past)
            metrics["valid"]["best"] = best_loss
            if self.svd is not None:  # the exact penalty, with its skip (solver.py:237-242)
                with torch.no_grad(), backward_precision(self.model):
                    metrics["valid"]["penalty"] = float(self.svd.exact(
                        dict(self.model.module.named_parameters()), self.penalty_rng))
            logger.info("Valid Summary | Epoch %d | %s", epoch + 1,
                        _summary(self._format_train(metrics["valid"])))
            if valid_loss == best_loss or self.args.dset.train_valid:
                logger.info("New best valid loss %.4f", valid_loss)
                self.best_state = (self._state() if state is None
                                   else {k: v.float().cpu().numpy()
                                         for k, v in state.state.items()})
                self.best_changed = True
            is_last = epoch == self.args.epochs - 1
            if ((epoch + 1) % self.args.test.every == 0 or is_last) and self.args.dset.musdb:
                metrics["test"] = self._test(compute_sdr=self.args.test.sdr and is_last)
            self.history.append(metrics)
            if distrib.rank() == 0:
                self._push_history()
                self._serialize(epoch)
            self.best_changed = False
            distrib.barrier()
            if is_last:
                break

    def quantized_state(self) -> dict:
        """The ``__quantized`` container of the live weights, at DiffQ's
        learned depths or QAT's bits (``zoo/diffq.py``'s layout)."""
        if self.quantizer is None:
            raise ValueError("quantized_state: this run trains without quant.diffq / quant.qat")
        return hard_quantized_state(dict(self.model.module.named_parameters()),
                                    self.quantizer.logits, self.quantizer.spec,
                                    self.model.kind, self.model.cfg)

    def _test(self, compute_sdr: bool) -> dict:
        """The test set with the best state (``test.best``) or the live one."""
        use_best = self.args.test.best and self.best_state is not None
        scope = (swap(self.model.module, {k: torch.as_tensor(v) for k, v in
                                          self.best_state.items()})
                 if use_best else contextlib.nullcontext())
        self.model.module.eval()
        with scope:
            return evaluate(self, compute_sdr=compute_sdr)

    def _push_history(self) -> None:
        path = self.folder / "history.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.history, indent=1))
        os.replace(tmp, path)

    def _valid_losses(self, sources: np.ndarray) -> tp.Tuple[dict, np.ndarray, np.ndarray]:
        """The loss, reco and estimate of one valid item (mixture first)."""
        args = self.args
        mix, refs = sources[:, 0], sources[:, 1:]
        if args.valid_apply:
            # apply_model's defaults (solver.py:316): one random shift per track,
            # drawn from the run's generator
            rng = random.Random(int(torch.randint(0, 2**62, (), generator=self.generator)))
            estimate = apply_model(self.model, mix, split=args.test.split, overlap=0, shifts=1,
                                   rng=rng)
        else:
            with torch.no_grad():
                estimate = self.model.module(torch.from_numpy(mix).to(self.device)).cpu().numpy()
        loss, reco = source_loss(torch.from_numpy(estimate), torch.from_numpy(refs),
                                 args.optim.loss, args.weights)
        return {"loss": float(loss)}, reco.numpy(), estimate

    def _run_one_epoch(self, epoch: int, train: bool = True) -> dict:
        """The batch loop (solver.py:291-405)."""
        loader = self.loaders["train"] if train else self.loaders["valid"]
        if train and hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        if not train and self.quantizer is not None:
            # validate the quantized model (diffq quantizes in its eval-mode forward pre-hook)
            module = self.model.module
            valid = self.quantizer.eval_params(dict(module.named_parameters()))
            with swap(module, {**module.state_dict(), **valid}):
                return self._epoch(epoch, loader, train)
        return self._epoch(epoch, loader, train)

    def _epoch(self, epoch: int, loader, train: bool) -> dict:
        args = self.args
        self.model.module.train(train)
        averager = MetricAverager()
        weights = np.asarray(args.weights, dtype=np.float64)
        losses: tp.Dict[str, float] = {}
        waited = stepped = 0.0
        idx = -1
        batches = iter(loader)
        while True:
            start = time.perf_counter()
            sources = next(batches, None)
            if sources is None:
                break
            idx += 1
            waited += time.perf_counter() - start
            start = time.perf_counter()
            if train:
                batch = torch.from_numpy(sources).to(self.device)
                # the skip draws on the host, as every worker's (svd.py:26-28)
                svd = self.svd if self.svd is not None and self.svd.fires(self.penalty_rng) \
                    else None
                m = train_step(self.model, self.optimizer, batch, loss=args.optim.loss,
                               weights=args.weights, clip_grad=args.optim.clip_grad,
                               generator=self.generator, augment=self._augment,
                               quantizer=self.quantizer, svd=svd)
                reco = m["reco"].cpu().numpy()
                losses = {"loss": float(m["loss"]), "grad": float(m["grad_norm"])}
                for key in ("ms", "penalty"):  # solver.py:339-360
                    if key in m:
                        losses[key] = float(m[key])
                for ema in self.emas["batch"]:
                    ema.update()
            else:
                losses, reco, estimate = self._valid_losses(sources)
                nsdrs = new_sdr(sources[:, 1:], estimate).mean(axis=0)
                for source, nsdr in zip(self.model.sources, nsdrs):
                    losses[f"nsdr_{source}"] = float(nsdr)
                losses["nsdr"] = float((nsdrs * weights).sum() / weights.sum())
            stepped += time.perf_counter() - start
            losses["reco"] = float((reco * weights).sum() / weights.sum())
            for k, source in enumerate(self.model.sources):
                losses[f"reco_{source}"] = float(reco[k])
            losses = averager(losses)
            # the reference breaks after processing batch max_batches
            # (solver.py:396): max_batches + 1 batches an epoch
            if args.max_batches is not None and idx == args.max_batches:
                break
            if (args.debug and train) or args.flag == "debug":
                break
        if train:
            for ema in self.emas["epoch"]:
                ema.update()
            self.timing.append({"epoch": epoch, "batches": idx + 1, "load_s": waited,
                                "step_s": stepped})
            logger.info("Epoch %d: %d batches, %.3f s waiting for data, %.3f s in steps",
                        epoch + 1, idx + 1, waited, stepped)
        self.model.module.eval()
        return distrib.average(losses, idx + 1)
