"""Run an exported HTDemucs core end to end: WAV in, stems out (counterpart
of ``tools/run_stablehlo.py``).

The core comes only from the artifact (``export/core.py``): no model code is
traced or called for it. Around each call the runtime does what the
reference's ONNX host loop does: the STFT and complex-as-channels packing
(K1 on the card), the iSTFT of the unpacked spectrogram plus the time branch
(K2), the segment overlap-add with the triangle weight
(``demucs/apply.py:257-301``), and the mixture-reference normalisation
(``demucs/separate.py:140-218``). Weights come from the artifact or from a
``.dmx`` of the same config.

    python -m demucs_tpu_torch.export.run --core core.pt2 --dmx model.dmx \\
        track.wav [-o separated] [-d cpu]

It runs on the card unless ``-d cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch.export.core import Core, load_core
from demucs_tpu_torch.inference.apply import Chunk, _triangle_weight, center_trim
from demucs_tpu_torch.models.htdemucs import precision_scope
from demucs_tpu_torch.ops.spec import cac_pack, cac_unpack, demucs_ispec, demucs_spec

__all__ = ["separate_with_core", "main"]


def separate_with_core(core: Core, model_cfg, mix: np.ndarray, overlap: float = 0.25,
                       transition_power: float = 1.0,
                       weights: tp.Optional[tp.Mapping[str, torch.Tensor]] = None) -> np.ndarray:
    """Overlap-add separation of ``mix (1, C, L)`` with the loaded ``core``
    -> ``(1, S, C, L)`` float32 on the host.

    The numerics of ``apply_model(model, mix, shifts=0, split=True)`` for a
    CaC HTDemucs: every chunk is padded to the artifact's training length
    with real neighbouring samples where the track has them (``Chunk``), the
    core's ``(spec, time)`` outputs become stems (CaC unpack, iSTFT, plus the
    time branch), center-trimmed and triangle-weighted into the track.
    ``weights``: the core's weights in place of the artifact's
    (:meth:`Core.weights_of`)."""
    if not model_cfg.cac:
        raise ValueError("the core runtime takes a CaC HTDemucs (cac=True)")
    seg_len = core.meta["training_length"]
    if model_cfg.training_length != seg_len or model_cfg.nfft != core.meta["nfft"]:
        raise ValueError(f"the config (training length {model_cfg.training_length}, nfft "
                         f"{model_cfg.nfft}) is not the artifact's ({seg_len}, "
                         f"{core.meta['nfft']})")
    mix = np.asarray(mix, np.float32)
    if mix.ndim != 3 or mix.shape[0] != 1:
        raise ValueError(f"mix must be (1, C, L), got {mix.shape}")
    _, channels, length = mix.shape
    out = np.zeros((1, len(model_cfg.sources), channels, length), np.float32)
    sum_weight = np.zeros(length, np.float32)
    weight = _triangle_weight(seg_len, transition_power)
    for offset in range(0, length, int((1 - overlap) * seg_len)):
        chunk = Chunk(mix, offset, seg_len)
        x = torch.from_numpy(chunk.padded(seg_len)).to(core.device)
        with torch.inference_mode(), precision_scope(None):
            mag = cac_pack(demucs_spec(x, model_cfg.nfft))
        spec_out, time_out = core(mag, x, weights)
        with torch.inference_mode(), precision_scope(None):
            stems = time_out + demucs_ispec(cac_unpack(spec_out), seg_len)
        chunk_out = center_trim(stems.cpu().numpy(), chunk.length)
        out[..., offset:offset + seg_len] += weight[:chunk.length] * chunk_out
        sum_weight[offset:offset + seg_len] += weight[:chunk.length]
    out /= sum_weight
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Separate tracks with an exported core")
    parser.add_argument("tracks", nargs="+", type=Path)
    parser.add_argument("--core", type=Path, required=True,
                        help="artifact from python -m demucs_tpu_torch.export.core")
    parser.add_argument("--dmx", type=Path, required=True,
                        help=".dmx archive holding the config and the weights")
    parser.add_argument("-o", "--out", type=Path, default=Path("separated"))
    parser.add_argument("--overlap", type=float, default=0.25)
    parser.add_argument("-d", "--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--float32", action="store_true",
                        help="write float32 WAV (default: int16)")
    parser.add_argument("--clip", default="rescale",
                        choices=["rescale", "clamp", "tanh", "none"])
    args = parser.parse_args(argv)

    from demucs_tpu_torch.audio import read_audio, save_audio
    from demucs_tpu_torch.zoo.native import load_native_model

    core = load_core(args.core, args.device)
    model = load_native_model(args.dmx, device=args.device)
    if model.kind != "htdemucs":
        raise ValueError(f"{args.dmx} holds a {model.kind}: the core is HTDemucs's")
    weights = core.weights_of(model)
    args.out.mkdir(parents=True, exist_ok=True)
    for track in args.tracks:
        wav, _ = read_audio(track, samplerate=model.samplerate, channels=model.audio_channels)
        ref = wav.mean(axis=0)
        mean, std = ref.mean(), ref.std() + 1e-8
        stems = separate_with_core(core, model.cfg, ((wav - mean) / std)[None],
                                   overlap=args.overlap, weights=weights)
        stems = stems * std + mean
        for name, stem in zip(model.sources, stems[0]):
            dest = args.out / f"{track.stem}_{name}.wav"
            save_audio(stem, dest, model.samplerate, clip=args.clip,
                       bits_per_sample=32 if args.float32 else 16, as_float=args.float32)
            print(f"wrote {dest}")


if __name__ == "__main__":
    main()
