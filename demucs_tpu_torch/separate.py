"""CLI: separate the sources of the given tracks
(port of ``demucs_tpu/separate.py``; behavioral reference ``demucs/separate.py``).

    python -m demucs_tpu_torch track.mp3 -n NAME [--repo DIR] [-o OUT] [-d cuda|cpu]
        [--flac | --mp3 [--mp3-bitrate 320] [--mp3-preset 2]] [--int24 | --float32]
        [--preset default|fast|balanced|quality] [--shift-offsets 2500,8000]
    python -m demucs_tpu_torch --list-models [--repo DIR]

``NAME`` (or ``-s SIG``) is a bag name or a model signature, in the folder
``--repo`` (``.th``, ``.dmx`` and bag ``.yaml`` files) or, without it, in the
released registry (download cache); ``demucs_unittest`` needs neither. A
track is read in any format ``audio.read_audio`` knows (WAV, FLAC, mp3, and
what libavcodec or ffmpeg decode), and a track at another sample rate is
resampled to the model's. Stems are written as WAV, FLAC (``--flac``) or mp3
(``--mp3``) to ``OUT/NAME/{track}/{stem}.{ext}`` by default. On the card
the tracks go through the device-resident engine (``--engine auto``), one
after the other with each track's copy to the host overlapping the next
track's compute. ``--preset`` picks a precision policy and stems wire
(``presets.py``; an explicit ``--wire`` wins) and prints its contract;
``--shift-offsets`` pins the shift offsets (``inference/prewarm.py``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from demucs_tpu_torch.api import LoadAudioError, LoadModelError, Separator, list_models
from demucs_tpu_torch.audio import save_audio
from demucs_tpu_torch.models.registry import BagOfModels
from demucs_tpu_torch.presets import resolve_preset
from demucs_tpu_torch.zoo.pretrained import add_model_flags


def fatal(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def auto_wire(args: argparse.Namespace) -> str:
    """The stems' wire for ``--wire auto``: int16 only for 16-bit PCM WAV output
    (its rounding stays under half a step of that file), float16 otherwise
    (24-bit or float WAV, FLAC, mp3)."""
    pcm16_wav = not (args.float32 or args.int24 or args.mp3 or args.flac)
    return "int16" if pcm16_wav else "float16"


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "demucs_tpu_torch", description="Separate the sources for the given tracks")
    parser.add_argument("tracks", nargs="*", type=Path, default=[], help="Path to tracks")
    add_model_flags(parser)
    parser.add_argument("--list-models", action="store_true",
                        help="List the models and bags of the repo and exit.")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="Show the separation's progress.")
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
    parser.add_argument("--shift-offsets", default=None,
                        help="Comma-separated pinned shift offsets (samples), consumed in "
                        "order instead of random draws: the reference's numerics for those "
                        "draws, and a bounded set of tail shapes that a prewarm can run.")
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
    parser.add_argument("--clip-mode", default="rescale", choices=["rescale", "clamp", "none"],
                        help="Clipping strategy: rescale | clamp | none.")
    format_group = parser.add_mutually_exclusive_group()
    format_group.add_argument("--flac", action="store_true", help="Output flac.")
    format_group.add_argument("--mp3", action="store_true", help="Output mp3.")
    parser.add_argument("--mp3-bitrate", default=320, type=int, help="mp3 bitrate (kb/s).")
    parser.add_argument("--mp3-preset", choices=range(2, 8), type=int, default=2,
                        help="mp3 encoder preset, 2 = highest quality, 7 = fastest.")
    parser.add_argument("-j", "--jobs", default=0, type=int,
                        help="Number of jobs (compatibility; see --batch-size).")
    parser.add_argument("--batch-size", default=16, type=int,
                        help="Segments per forward on the device.")
    parser.add_argument("--engine", default="auto", choices=["auto", "host", "device"],
                        help="device: the track stays on the device, overlap-add there, "
                        "one copy of the stems back; host: one copy per batch, "
                        "overlap-add on the host; auto (default): device on the card, "
                        "host on the CPU.")
    parser.add_argument("--tail-mode", default="exact", choices=["exact", "uniform"],
                        help="Ragged tail chunks on the device engine for models whose "
                        "padding depends on the chunk length (HDemucs, Demucs v2, HTDemucs "
                        "without use_train_segment): exact (default) runs each at its own "
                        "length as the reference does; uniform pads it to the full segment.")
    parser.add_argument("--length-bucket", type=float, default=None, metavar="SECONDS",
                        help="Pad each track with zeros to a multiple of this length on the "
                        "device engine, so tracks of other lengths share graphs (only the "
                        "last chunk's context changes).")
    parser.add_argument("--preset", default="default",
                        choices=["default", "fast", "balanced", "quality"],
                        help="Precision policy and stems wire (presets.py): 'fast' = bf16 "
                        "storage in HTDemucs's core stages + int8 wire; default = full fp32; "
                        "'balanced' = TF32 tensor cores in cuDNN and cuBLAS; 'quality' = "
                        "full fp32 + the bit-exact wire. An explicit --wire wins.")
    parser.add_argument("--wire", default="auto",
                        choices=["auto", "float32", "float16", "int16", "int8"],
                        help="Format of the stems' copy from the device engine: auto = "
                        "int16 when writing 16-bit PCM WAV (scaled to each stem channel's "
                        "peak: it rounds by at most half of 1/32766 of that peak, under "
                        "half a step of the file), else float16; float32 = bit-exact; "
                        "int8 = half the bytes at about 44 dB SNR. The track goes to the "
                        "device in float32 whatever the wire.")
    return parser


def main(opts=None):
    args = get_parser().parse_args(opts)
    if args.list_models:
        models = list_models(args.repo)
        print("Bag of models:", end="\n    ")
        print("\n    ".join(models["bag"]))
        print("Single models:", end="\n    ")
        print("\n    ".join(models["single"]))
        return
    if not args.tracks:
        fatal("error: the following arguments are required: tracks")
    name = args.sig or args.name
    compute_dtype, matmul_precision, wire, banner = resolve_preset(args.preset, args.wire)
    if banner:
        print(banner)
    if wire == "auto":
        wire = auto_wire(args)
    try:
        separator = Separator(model=name, repo=args.repo, device=args.device,
                              shifts=args.shifts, split=args.split, overlap=args.overlap,
                              segment=args.segment, jobs=args.jobs, progress=args.verbose,
                              batch_size=args.batch_size, engine=args.engine,
                              transfer_dtype=None if wire == "float32" else wire,
                              length_bucket_seconds=args.length_bucket,
                              tail_mode=args.tail_mode, compute_dtype=compute_dtype,
                              matmul_precision=matmul_precision,
                              shift_offsets=(tuple(int(x) for x in args.shift_offsets.split(","))
                                             if args.shift_offsets else None))
    except LoadModelError as error:
        fatal(str(error))
    model = separator.model
    if isinstance(model, BagOfModels):
        max_segment = model.max_allowed_segment
    else:
        max_segment = model.segment if model.kind == "htdemucs" else float("inf")
    if args.segment is not None and args.segment > max_segment:
        fatal("Cannot use a Transformer model with a longer segment than it was trained "
              f"for. Maximum segment is: {max_segment}")
    if args.stem is not None and args.stem not in separator.model.sources:
        fatal(f'error: stem "{args.stem}" is not in selected model. STEM must be one of '
              f'{", ".join(separator.model.sources)}.')
    out = args.out / name
    out.mkdir(parents=True, exist_ok=True)
    print(f"Separated tracks will be stored in {out.resolve()}")
    ext = "mp3" if args.mp3 else "flac" if args.flac else "wav"
    kwargs = {"samplerate": separator.samplerate, "bitrate": args.mp3_bitrate,
              "preset": args.mp3_preset, "clip": args.clip_mode, "as_float": args.float32,
              "bits_per_sample": 24 if args.int24 else 16}

    def announced(tracks):
        for track in tracks:
            if not track.exists():
                print(f"File {track} does not exist.", file=sys.stderr)
                continue
            print(f"Separating track {track}")  # when it is picked up, not when it ends
            yield track

    def write(track: Path, origin: np.ndarray, res: dict) -> None:
        def _path(stem_name: str) -> Path:
            path = out / args.filename.format(track=track.name.rsplit(".", 1)[0],
                                              trackext=track.name.rsplit(".", 1)[-1],
                                              stem=stem_name, ext=ext)
            path.parent.mkdir(parents=True, exist_ok=True)
            return path

        if args.stem is None:
            for stem_name, source in res.items():
                save_audio(source, _path(stem_name), **kwargs)
            return
        if args.other_method == "minus":
            save_audio(origin - res[args.stem], _path("minus_" + args.stem), **kwargs)
        save_audio(res.pop(args.stem), _path(args.stem), **kwargs)
        if args.other_method == "add":
            other = np.zeros_like(next(iter(res.values())))
            for source in res.values():
                other += source
            save_audio(other, _path("no_" + args.stem), **kwargs)

    try:
        for track, origin, res in separator.separate_audio_files(announced(args.tracks)):
            write(track, origin, res)
    except LoadAudioError as error:
        fatal(str(error))


if __name__ == "__main__":
    main()
