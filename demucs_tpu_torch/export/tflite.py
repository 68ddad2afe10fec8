"""Export of the HTDemucs core as a TFLite flatbuffer (counterpart of
``tools/export_tflite.py``), the artifact the web shell runs
(``web/index.html`` through tfjs-tflite; ``tools/inspect_debug_pack.py``
replays its debug packs against it).

The flatbuffer is converted from the SavedModel of ``export/tf.py``
(``TFLiteConverter.from_saved_model`` with the TFLite builtins and the
select TF ops), written with ``<out>.meta.json`` beside it (the keys of the
JAX tool's meta, plus ``matmul_precision``, ``compute_dtype`` and
``format``, as ``export/core.py::save_core`` writes them), then run in
process by ``tf.lite.Interpreter`` against the port's eager
``forward_core`` on the same inputs. A core with bf16 stages is refused:
TFLite's converter cannot legalise the bf16 graph (the JAX tool fails on
it the same way). Host only, as ``export/tf.py``.

    python -m demucs_tpu_torch.export.tflite -n NAME [--repo DIR] --out core.tflite
    python -m demucs_tpu_torch.export.tflite --random --out core.tflite [-d cpu]

(``--random``: seeded weights on a reduced config, RANDOM_CFG.)
"""

from __future__ import annotations

import json
import tempfile
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from demucs_tpu_torch.export import core as ecore
from demucs_tpu_torch.export import tf as etf
from demucs_tpu_torch.models import htdemucs as ht

__all__ = ["FORMAT", "RANDOM_CFG", "convert", "run_interpreter", "export_tflite_core", "main"]

FORMAT = "tflite"
# --random's config: a reduced HTDemucs of the full topology, as the JAX tool's
RANDOM_CFG = dict(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                  samplerate=8000)


def convert(saved_model: tp.Union[str, Path]) -> bytes:
    """The flatbuffer of a SavedModel: TFLite builtins, select TF ops where
    a builtin is missing."""
    import tensorflow as tf

    converter = tf.lite.TFLiteConverter.from_saved_model(str(saved_model))
    converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS,
                                           tf.lite.OpsSet.SELECT_TF_OPS]
    return converter.convert()


def run_interpreter(flatbuffer: bytes, mag: np.ndarray, mix: np.ndarray) -> tuple:
    """``(spec_out, time_out)`` of a core flatbuffer on ``(mag, mix)`` by
    ``tf.lite.Interpreter`` (inputs and outputs told apart by rank, as the
    web shell and ``tools/inspect_debug_pack.py`` do)."""
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_content=flatbuffer)
    interp.allocate_tensors()
    by_rank = {len(d["shape"]): d["index"] for d in interp.get_input_details()}
    interp.set_tensor(by_rank[4], np.asarray(mag, np.float32))
    interp.set_tensor(by_rank[3], np.asarray(mix, np.float32))
    interp.invoke()
    outs = [interp.get_tensor(d["index"]) for d in interp.get_output_details()]
    return next(o for o in outs if o.ndim == 5), next(o for o in outs if o.ndim == 4)


def export_tflite_core(model, out: tp.Union[str, Path], inputs=None,
                       device=None) -> tp.Tuple[tuple, dict]:
    """Convert ``model``'s core to a flatbuffer at ``out`` and write
    ``<out>.meta.json``. Returns the interpreter's ``(spec_out, time_out)``
    on ``inputs`` (``(mag, mix)`` numpy; default ``export/tf.py::
    sample_inputs``) and each output's largest error against the eager
    ``forward_core`` over its peak."""
    module = getattr(model, "module", model)
    cfg = module.cfg
    bf16 = sorted(ht._bf16_stage_set(cfg))
    if bf16:
        raise ValueError(f"the TFLite export refuses bf16 stages ({bf16}): TFLite's converter "
                         "cannot legalise the bf16 graph; export the fp32 core, or the "
                         "SavedModel (export/tf.py)")
    if inputs is None:
        inputs = etf.sample_inputs(cfg)
    mag, mix = (np.asarray(x, np.float32) for x in inputs)
    with tempfile.TemporaryDirectory() as folder:
        etf.save_tf_core(model, Path(folder) / "saved_model", device)
        flatbuffer = convert(Path(folder) / "saved_model")
    out = Path(out)
    out.write_bytes(flatbuffer)
    mag_shape, mix_shape = ecore.core_shapes(cfg)
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
        "matmul_precision": ecore.exportable_precision(cfg),
        "compute_dtype": cfg.compute_dtype,
        "format": FORMAT,
    }
    ecore.meta_path(out).write_text(json.dumps(meta, indent=1))
    got = run_interpreter(flatbuffer, mag, mix)
    dev = next(module.parameters()).device
    with torch.inference_mode(), ht.precision_scope(meta["matmul_precision"]):
        want = module.forward_core(torch.from_numpy(mag).to(dev), torch.from_numpy(mix).to(dev))
    errs = {}
    for name, g, w in zip(("spec_out", "time_out"), got, want):
        w = w.float().cpu().numpy()
        if g.shape != w.shape:
            raise AssertionError(f"{name}: the flatbuffer gives {g.shape}, the core {w.shape}")
        errs[name] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))
    return got, errs


def main(argv=None) -> None:
    args = etf.cli_parser("Export the HTDemucs core as a TFLite flatbuffer",
                          "htdemucs_core.tflite").parse_args(argv)
    model = etf.model_from_args(args, RANDOM_CFG)
    start = time.perf_counter()
    _, errs = export_tflite_core(model, args.out)
    print(f"exported TFLite flatbuffer: {args.out} ({args.out.stat().st_size / 2**20:.1f} MB, "
          f"{time.perf_counter() - start:.1f} s), interpreter vs eager core, max err over "
          f"peak: {errs}")


if __name__ == "__main__":
    main()
