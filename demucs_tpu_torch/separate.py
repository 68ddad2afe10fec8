"""CLI: separate the sources of the given WAV tracks
(port of ``demucs_tpu/separate.py``; behavioral reference ``demucs/separate.py``).

    python -m demucs_tpu_torch track.wav --repo DIR -n NAME [-o OUT] [-d cuda|cpu]

Models load from a local folder of ``.dmx`` files (``--repo``). Stems are
written as WAV to ``OUT/NAME/{track}/{stem}.wav`` by default.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from demucs_tpu_torch.api import LoadAudioError, LoadModelError, Separator
from demucs_tpu_torch.audio import save_audio


def fatal(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "demucs_tpu_torch", description="Separate the sources for the given tracks")
    parser.add_argument("tracks", nargs="+", type=Path, help="Path to WAV tracks")
    parser.add_argument("-n", "--name", default="htdemucs",
                        help="Model name: <repo>/<name>.dmx. Default is htdemucs.")
    parser.add_argument("--repo", type=Path, required=True,
                        help="Folder holding the .dmx models.")
    parser.add_argument("-o", "--out", type=Path, default=Path("separated"),
                        help="Folder for the stems; a subfolder with the model name "
                        "is created.")
    parser.add_argument("--filename", default="{track}/{stem}.{ext}",
                        help='Output name template; variables "{track}", "{trackext}", '
                        '"{stem}", "{ext}".')
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--shifts", default=1, type=int,
                        help="Number of random shifts for equivariant stabilization.")
    parser.add_argument("--overlap", default=0.25, type=float,
                        help="Overlap between the splits.")
    split_group = parser.add_mutually_exclusive_group()
    split_group.add_argument("--no-split", action="store_false", dest="split", default=True,
                             help="Do not split the audio into chunks.")
    split_group.add_argument("--segment", type=float, help="Length of each chunk (seconds).")
    parser.add_argument("--two-stems", dest="stem", metavar="STEM",
                        help="Only separate audio into {STEM} and no_{STEM}.")
    parser.add_argument("--other-method", dest="other_method",
                        choices=["none", "add", "minus"], default="add",
                        help='How to compute "no_{STEM}": none|add|minus.')
    depth_group = parser.add_mutually_exclusive_group()
    depth_group.add_argument("--int24", action="store_true", help="Save wav as 24 bits.")
    depth_group.add_argument("--float32", action="store_true", help="Save wav as float32.")
    parser.add_argument("--batch-size", default=16, type=int,
                        help="Segments per forward on the device.")
    return parser


def main(opts=None):
    args = get_parser().parse_args(opts)
    try:
        separator = Separator(model=args.name, repo=args.repo, device=args.device,
                              shifts=args.shifts, split=args.split, overlap=args.overlap,
                              segment=args.segment, batch_size=args.batch_size)
    except LoadModelError as error:
        fatal(str(error))
    max_segment = separator.model.segment
    if args.segment is not None and args.segment > max_segment:
        fatal("Cannot use a Transformer model with a longer segment than it was trained "
              f"for. Maximum segment is: {max_segment}")
    if args.stem is not None and args.stem not in separator.model.sources:
        fatal(f'error: stem "{args.stem}" is not in selected model. STEM must be one of '
              f'{", ".join(separator.model.sources)}.')
    out = args.out / args.name
    out.mkdir(parents=True, exist_ok=True)
    print(f"Separated tracks will be stored in {out.resolve()}")
    kwargs = {"samplerate": separator.samplerate, "as_float": args.float32,
              "bits_per_sample": 24 if args.int24 else 16}
    for track in args.tracks:
        if not track.exists():
            print(f"File {track} does not exist.", file=sys.stderr)
            continue
        print(f"Separating track {track}")
        try:
            origin, res = separator.separate_audio_file(track)
        except LoadAudioError as error:
            fatal(str(error))

        def _path(stem_name: str) -> Path:
            path = out / args.filename.format(track=track.name.rsplit(".", 1)[0],
                                              trackext=track.name.rsplit(".", 1)[-1],
                                              stem=stem_name, ext="wav")
            path.parent.mkdir(parents=True, exist_ok=True)
            return path

        if args.stem is None:
            for stem_name, source in res.items():
                save_audio(source, _path(stem_name), **kwargs)
            continue
        if args.other_method == "minus":
            save_audio(origin - res[args.stem], _path("minus_" + args.stem), **kwargs)
        save_audio(res.pop(args.stem), _path(args.stem), **kwargs)
        if args.other_method == "add":
            other = np.zeros_like(next(iter(res.values())))
            for source in res.values():
                other += source
            save_audio(other, _path("no_" + args.stem), **kwargs)


if __name__ == "__main__":
    main()
