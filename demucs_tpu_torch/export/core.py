"""Export of the HTDemucs core to a ``torch.export`` artifact (counterpart of
``tools/export_stablehlo.py``).

The export boundary is the JAX package's and the reference fork's: the
core between the STFT and the iSTFT (``HTDemucs.forward_core``), from the
complex-as-channels spectrogram ``mag (1, 2C, nfft/2, frames)`` and the
waveform ``mix (1, C, training_length)`` to ``(spec_out, time_out)``, at the
training length. K1 and K2 stay outside it: the runtime (``export/run.py``)
runs them eagerly around each call. Inside it every attention is one node of
the registered op ``demucs_tpu_torch::flash_mha`` (K3), so the program runs
the hand-written kernel on the card and its plain version on the CPU.

The artifact (``.pt2``) holds the graph, the weights under the ``.dmx``
dotted names (any ``.dmx`` of the same config drives it, ``Core``'s
``weights``) and the positional-embedding tables as constants, which
:func:`load_core` moves to the device with the program. Beside it,
``<out>.meta.json``: the keys of ``tools/export_tflite.py``'s meta, plus
``matmul_precision``, ``compute_dtype`` and ``format``.

Precision: a graph does not carry ``torch.backends``' TF32 flags, so the
meta records the config's matmul precision and :class:`Core` applies it
around each call with ``models/htdemucs.py::precision_scope``. bf16 stages
(the ``fast`` preset) are the graph's own casts. The ``"default"`` /
``"bfloat16"`` operand rounding is decided per device when the forward runs
and is refused, as are per-stage precisions that differ from the core's.

    python -m demucs_tpu_torch.export.core -n NAME [--repo DIR] --out core.pt2
    python -m demucs_tpu_torch.export.core --random --out core.pt2 [--segment 7.8]
        [--preset fast] [-d cpu]

The op registration (``demucs_tpu_torch.kernels.attention``) must be
imported before ``torch.export.load``; :func:`load_core` does it.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import typing as tp
from pathlib import Path

import torch

from demucs_tpu_torch.kernels import attention  # noqa: F401 (registers demucs_tpu_torch::flash_mha)
from demucs_tpu_torch.models import htdemucs as ht

__all__ = ["FORMAT", "CoreModule", "exportable_precision", "core_shapes", "export_program",
           "save_core", "export_core", "Core", "load_core", "meta_path", "main"]

FORMAT = "torch.export"


class CoreModule(ht.HTDemucs):
    """``forward(mag, mix) = forward_core(mag, mix)`` of an HTDemucs, sharing
    its submodules, so the exported state dict has the model's own names."""

    def __init__(self, model: ht.HTDemucs):
        torch.nn.Module.__init__(self)
        for name, child in model.named_children():
            self.add_module(name, child)
        self.cfg, self.layout = model.cfg, model.layout
        self.train(model.training)

    def forward(self, mag: torch.Tensor, mix: torch.Tensor):
        return self.forward_core(mag, mix)


def exportable_precision(cfg: ht.HTDemucsConfig) -> tp.Optional[str]:
    """The matmul precision an artifact of ``cfg`` records for its runtime;
    ``ValueError`` where the graph could not hold the config's numerics."""
    precision = ht._matmul_precision(cfg)
    modes = {ht.check_precision(precision)}
    modes |= {ht.check_precision(p) for _, p in cfg.precision_stages}
    if "bfloat16" in modes:
        raise ValueError("the export refuses the 'default' / 'bfloat16' matmul precision: its "
                         "operand rounding is decided per device when the forward runs, and "
                         "the graph would not carry it")
    if len(modes) > 1:
        raise ValueError(f"precision_stages {cfg.precision_stages} differ from the core's "
                         f"{precision!r}: the runtime applies one precision around the call")
    return precision


def core_shapes(cfg: ht.HTDemucsConfig) -> tp.Tuple[tuple, tuple]:
    """The (mag, mix) input shapes at the training length, batch 1."""
    length = cfg.training_length
    frames = math.ceil(length / cfg.hop_length)
    chans = cfg.audio_channels * (2 if cfg.cac else 1)
    return (1, chans, cfg.nfft // 2, frames), (1, cfg.audio_channels, length)


def export_program(model, device=None) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s core (a ``Model`` or an ``HTDemucs`` in
    eval mode), traced on ``device`` (default: the module's own; another
    device traces a copy moved there)."""
    import copy

    module = getattr(model, "module", model)
    if not isinstance(module, ht.HTDemucs):
        raise TypeError(f"the core export takes an HTDemucs, got {type(module).__name__}")
    if module.training:
        raise ValueError("export the core of a module in eval mode")
    exportable_precision(module.cfg)
    current = next(module.parameters()).device
    if device is not None and torch.device(device) != current:
        module = copy.deepcopy(module).to(device)
        current = torch.device(device)
    mag_shape, mix_shape = core_shapes(module.cfg)
    args = (torch.zeros(mag_shape, device=current), torch.zeros(mix_shape, device=current))
    with torch.no_grad():
        return torch.export.export(CoreModule(module), args)


def meta_path(out: tp.Union[str, Path]) -> Path:
    return Path(out).with_suffix(".meta.json")


def save_core(program: torch.export.ExportedProgram, cfg: ht.HTDemucsConfig,
              out: tp.Union[str, Path]) -> None:
    """Save an exported core to ``out`` (``.pt2``) and its meta beside it."""
    out = Path(out)
    torch.export.save(program, out)
    mag_shape, mix_shape = core_shapes(cfg)
    meta = {
        "samplerate": cfg.samplerate,
        "audio_channels": cfg.audio_channels,
        "sources": list(cfg.sources),
        "nfft": cfg.nfft,
        "hop_length": cfg.hop_length,
        "cac": cfg.cac,
        "segment": cfg.segment,
        "training_length": cfg.training_length,
        "inputs": {"mag": list(mag_shape), "mix": list(mix_shape)},
        "artifact": out.name,
        "matmul_precision": exportable_precision(cfg),
        "compute_dtype": cfg.compute_dtype,
        "format": FORMAT,
    }
    meta_path(out).write_text(json.dumps(meta, indent=1))


def export_core(model, out: tp.Union[str, Path], device=None) -> tp.Tuple[tuple, tuple]:
    """Export ``model``'s core (:func:`export_program`), save it to ``out``
    (``.pt2``) and write ``<out>.meta.json``. Returns the (mag, mix) input
    shapes."""
    cfg = getattr(model, "module", model).cfg
    save_core(export_program(model, device), cfg, out)
    return core_shapes(cfg)


class Core:
    """A loaded artifact on one device: ``core(mag, mix, weights=None) ->
    (spec_out, time_out)`` under the meta's matmul precision, in inference
    mode. ``weights``: ``{dotted name: tensor}`` in place of the artifact's
    own (every name of its state dict; :meth:`weights_of` makes them from a
    port ``Model``)."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict,
                 device: torch.device):
        self.program, self.meta, self.device = program, meta, device
        self.module = program.module()
        self._dtypes = {k: v.dtype for k, v in program.state_dict.items()}

    def weights_of(self, model) -> tp.Dict[str, torch.Tensor]:
        """A ``Model``'s or module's weights (or a ``{name: tensor or array}``
        mapping) as this artifact takes them: its names exactly, its dtypes,
        its device."""
        module = getattr(model, "module", model)
        state = module.state_dict() if isinstance(module, torch.nn.Module) else dict(model)
        if set(state) != set(self._dtypes):
            missing, extra = set(self._dtypes) - set(state), set(state) - set(self._dtypes)
            raise ValueError(f"the weights do not fit the artifact: missing {sorted(missing)[:5]}, "
                             f"unexpected {sorted(extra)[:5]}")
        return {k: torch.as_tensor(v).to(device=self.device, dtype=self._dtypes[k])
                for k, v in state.items()}

    def __call__(self, mag: torch.Tensor, mix: torch.Tensor,
                 weights: tp.Optional[tp.Mapping[str, torch.Tensor]] = None):
        with torch.inference_mode(), ht.precision_scope(self.meta["matmul_precision"]):
            if weights is None:
                return self.module(mag, mix)
            return torch.func.functional_call(self.module, dict(weights), (mag, mix))


def load_core(path: tp.Union[str, Path], device="cuda") -> Core:
    """Load an artifact and its meta onto ``device`` (the card unless the
    caller asks for the CPU; raises without one). A bf16 artifact runs on the
    card only: the CPU's bf16 convolution (oneDNN) gives wrong values for some
    of the core's shapes."""
    from torch.export.passes import move_to_device_pass

    from demucs_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the traced device checks carry an index
        dev = torch.device("cuda", torch.cuda.current_device())
    meta = json.loads(meta_path(path).read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} core (meta format {meta.get('format')!r})")
    program = torch.export.load(Path(path))
    if dev.type == "cpu" and any(v.dtype == torch.bfloat16
                                 for v in program.state_dict.values()):
        raise ValueError(f"{path} holds bf16 stages, which run on the card only")
    return Core(move_to_device_pass(program, dev), meta, dev)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export the HTDemucs core with torch.export")
    parser.add_argument("-n", "--name", default="htdemucs")
    parser.add_argument("--repo", type=Path, default=None)
    parser.add_argument("--random", action="store_true",
                        help="seeded random weights at the config's defaults (no zoo needed)")
    parser.add_argument("--out", type=Path, default=Path("htdemucs_core.pt2"))
    parser.add_argument("--segment", type=float, default=None)
    parser.add_argument("--preset", default="default",
                        help="default, fast, balanced or quality (presets.py)")
    parser.add_argument("-d", "--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from demucs_tpu_torch import resolve_device
    from demucs_tpu_torch.models.registry import BagOfModels, Model, reconfigured
    from demucs_tpu_torch.presets import resolve_preset

    device = resolve_device(args.device)
    if args.random:
        cfg = ht.HTDemucsConfig(segment=args.segment or 7.8)
        model = Model("htdemucs", cfg, ht.init_htdemucs(cfg, seed=0).eval().to(device))
    else:
        from demucs_tpu_torch.zoo.pretrained import get_model

        model = get_model(args.name, repo=args.repo, device=device)
        if isinstance(model, BagOfModels):
            model = model.models[0]
        if model.kind != "htdemucs":
            raise ValueError(f"the core export takes an HTDemucs, {args.name} is {model.kind}")
        if args.segment:
            model = reconfigured(model, segment=args.segment)
    compute_dtype, precision, _, _ = resolve_preset(args.preset, None)
    delta = {k: v for k, v in (("compute_dtype", compute_dtype),
                               ("matmul_precision", precision)) if v}
    if delta:
        model = reconfigured(model, **delta)
    start = time.perf_counter()
    mag_shape, mix_shape = export_core(model, args.out)
    print(f"exported {FORMAT} core: {args.out} ({args.out.stat().st_size / 2**20:.1f} MB, "
          f"{time.perf_counter() - start:.1f} s)")
    print(f"  in:  mag {mag_shape}, mix {mix_shape}")


if __name__ == "__main__":
    main()
