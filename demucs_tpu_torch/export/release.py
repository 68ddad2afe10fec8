"""Export a trained XP to a release ``.dmx`` (counterpart of ``tools/export.py``;
behavioral reference: the reference's ``tools/export.py``).

For each XP signature, ``{outdir}/xps/{SIG}/checkpoint.pkl`` (the port's
``train/solver.py``) gives the training arguments and the weights
(``best_state``, else ``state``). The model's ``segment`` is pinned to the
trained segment (``dset.segment``), and the release is written to
``{out}/{SIG}-{sha256[:8]}.dmx``: fp16 weights, or, for a DiffQ / QAT XP,
the hard-quantized container at DiffQ's learned depths or QAT's bits
(``train/quantize.py::hard_quantized_state``, ``zoo/diffq.py``'s layout).

    python -m demucs_tpu_torch.export.release SIG [SIG ...] [--out release_models]
        [--outdir outputs]
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
from pathlib import Path

import torch

from demucs_tpu_torch.train.config import TrainArgs
from demucs_tpu_torch.zoo.native import save_with_checksum

__all__ = ["training_args", "export_xp", "main"]


def training_args(saved: dict) -> TrainArgs:
    """The ``TrainArgs`` of a checkpoint's ``args`` (``dataclasses.asdict``)."""

    def restore(node, data: dict) -> None:
        for key, value in data.items():
            current = getattr(node, key)
            if dataclasses.is_dataclass(current) and isinstance(value, dict):
                restore(current, value)
            else:
                if isinstance(current, tuple) and isinstance(value, list):
                    value = tuple(value)
                setattr(node, key, value)

    args = TrainArgs()
    restore(args, saved)
    return args


def export_xp(folder: Path, out: Path) -> Path:
    """The release ``.dmx`` of the XP in ``folder`` (its name the signature),
    written into ``out``."""
    from demucs_tpu_torch.train.quantize import hard_quantized_state, make_spec
    from demucs_tpu_torch.train.train import get_model
    from demucs_tpu_torch.zoo.convert import load_flat_state

    with open(folder / "checkpoint.pkl", "rb") as f:
        package = pickle.load(f)
    saved = package["args"]
    args = training_args(saved)
    model = get_model(args, device="cpu")
    load_flat_state(model.module, package.get("best_state") or package["state"])
    model.segment = float(args.dset.segment)
    model.module.eval()
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{folder.name}.dmx"
    spec = make_spec(args)
    if spec is None:
        return save_with_checksum(model, path, training_args=saved, half=True)
    logits = package.get("quant", {}).get("qlogits")
    if logits is not None:
        logits = {k: torch.as_tensor(v) for k, v in logits.items()}
    qstate = hard_quantized_state(dict(model.module.named_parameters()), logits, spec,
                                  model.kind, model.cfg)
    return save_with_checksum(model, path, training_args=saved, quantized_state=qstate)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export trained XPs to release .dmx files")
    parser.add_argument("signatures", nargs="+")
    parser.add_argument("--out", type=Path, default=Path("release_models"))
    parser.add_argument("--outdir", type=Path, default=Path("outputs"))
    args = parser.parse_args(argv)
    for sig in args.signatures:
        path = export_xp(args.outdir / "xps" / sig, args.out)
        print(f"exported {sig} ({path.stat().st_size / 2**20:.1f} MB) -> {path}")


if __name__ == "__main__":
    main()
