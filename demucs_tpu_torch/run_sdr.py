"""The SDR quality gate on the card (the port's counterpart of
``tools/run_sdr.py``): evaluate a released model or bag on the MUSDB-HQ test
set and print a verdict against its published SDR (reference README.md:23-24:
htdemucs_ft 9.00 dB overall; pass within 0.05 dB, BASELINE.md).

    python -m demucs_tpu_torch.run_sdr --musdb /path/to/musdbhq -n htdemucs_ft --repo DIR
    python -m demucs_tpu_torch.run_sdr --musdb ... -n htdemucs --gate 8.55 --repo DIR

``--repo`` is a folder of the reference's ``.th`` packages, ``.dmx`` files and
bag ``.yaml`` files; without it the released registry is read from the
download cache. Nothing here downloads the weights or the dataset. The
verdict JSON (printed, and written to ``--out``):

    {"model": ..., "metric": "sdr_med"|"nsdr", "value": ..., "gate_db": ...,
     "tolerance_db": ..., "pass": true|false, "scores": {...}}

The exit code is 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

#: Published overall SDR (the mean over sources of the median over tracks of
#: museval's SDR) per released name: reference README.md:23-24, 85-94.
PUBLISHED_SDR = {
    "htdemucs_ft": 9.00,
    "htdemucs": 8.55,  # v4 without fine-tuning (the paper's table)
    "hdemucs_mmi": 8.11,
    "mdx_extra": 7.80,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m demucs_tpu_torch.run_sdr", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-n", "--name", default="htdemucs_ft",
                        help="released model or bag name (default htdemucs_ft, the 9.00 dB "
                        "headline)")
    parser.add_argument("--repo", type=Path, default=None,
                        help="local checkpoint folder instead of the download cache")
    parser.add_argument("--musdb", type=Path, required=True,
                        help="MUSDB-HQ root (train/ and test/ track folders)")
    parser.add_argument("--gate", type=float, default=None,
                        help="gate in dB (default: the published number for --name, "
                        "PUBLISHED_SDR)")
    parser.add_argument("--tolerance", type=float, default=0.05,
                        help="pass when value >= gate - tolerance (BASELINE.md)")
    parser.add_argument("--nsdr-only", action="store_true",
                        help="skip BSS-eval and gate on the MDX nsdr (faster; the published "
                        "gate is museval's SDR)")
    parser.add_argument("--shifts", type=int, default=1)
    parser.add_argument("--overlap", type=float, default=0.25)
    parser.add_argument("--workers", type=int, default=2,
                        help="BSS-eval worker processes")
    parser.add_argument("-d", "--device", default="cuda",
                        help="the card (default) or cpu")
    parser.add_argument("--out", type=Path, default=Path("sdr_verdict.json"))
    return parser


def eval_args(musdb: Path, shifts: int = 1, overlap: float = 0.25,
              workers: int = 2) -> types.SimpleNamespace:
    """The fields of the JAX package's ``TrainArgs`` that ``evaluate`` reads,
    at its defaults (``demucs_tpu/train/config.py``)."""
    test = types.SimpleNamespace(shifts=shifts, overlap=overlap, workers=workers, split=True,
                                 save=False, nonhq=None, length_bucket_seconds=None)
    return types.SimpleNamespace(test=test, dset=types.SimpleNamespace(musdb=str(musdb)))


def run(args) -> dict:
    from demucs_tpu_torch.evaluate import evaluate
    from demucs_tpu_torch.zoo.pretrained import get_model

    model = get_model(args.name, repo=args.repo, device=args.device)
    folder = args.out.parent if args.out.parent != Path("") else Path(".")
    solver = types.SimpleNamespace(
        args=eval_args(args.musdb, args.shifts, args.overlap, args.workers),
        model=model, folder=folder)
    scores = evaluate(solver, compute_sdr=not args.nsdr_only)
    metric = "nsdr" if args.nsdr_only else "sdr_med"
    value = scores[metric]
    gate = args.gate if args.gate is not None else PUBLISHED_SDR.get(args.name)
    return {
        "model": args.name,
        "metric": metric,
        "value": round(float(value), 4),
        "gate_db": gate,
        "tolerance_db": args.tolerance,
        "pass": (gate is None) or (value >= gate - args.tolerance),
        "scores": {k: round(float(v), 4) for k, v in scores.items()},
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    verdict = run(args)
    args.out.write_text(json.dumps(verdict, indent=1))
    print(json.dumps(verdict))
    if not verdict["pass"]:
        print(f"FAIL: {verdict['metric']} {verdict['value']:.3f} dB < "
              f"gate {verdict['gate_db']} - {verdict['tolerance_db']}", file=sys.stderr)
        sys.exit(1)
    return verdict


if __name__ == "__main__":
    main()
