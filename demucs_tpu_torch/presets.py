"""The serving presets: one definition of each preset's precision policy and
stems wire (port of ``demucs_tpu/presets.py``).

The CLI (``separate.py``) reads them here, so each preset's contents, the
rule that an explicit wire wins and the printed contract cannot drift apart.
On the card the ladder is set by what the H100 offers for fp32 operands
(``models/htdemucs.py::precision_scope``):

  preset     policy on the card                                   stems wire
  fast       bf16 storage in every HTDemucs core stage, K3 on       int8
             bf16; fp32 accumulation, fp32 statistics
  (default)  full fp32: TF32 off in cuDNN and cuBLAS              auto
  balanced   TF32 in cuDNN (convolutions, LSTM) and cuBLAS        auto
  quality    full fp32, as the default, with the bit-exact wire   float32

K3's fp32 route keeps fp32 accuracy (three TF32 products) under every
preset. The card's measured SER and rates are in PERF.md; none of the TPU
ladder's figures applies here.
"""

from __future__ import annotations

import typing as tp

__all__ = ["PRESETS", "resolve_preset", "resolve_fast_preset"]

FAST_COMPUTE_DTYPE = "bfloat16"
FAST_WIRE = "int8"
FAST_CONTRACT = ("bf16 storage in every HTDemucs core stage (fp32 accumulation, "
                 "fp32 normalization statistics and softmax; attention on K3's bf16 route) "
                 "+ int8 stems wire (8 bits a sample, a scale per block of 1024); other "
                 "families keep fp32")

# preset -> (compute_dtype, matmul_precision, default wire, contract)
PRESETS: tp.Dict[str, tp.Tuple[tp.Optional[str], tp.Optional[str],
                               tp.Optional[str], str]] = {
    "fast": (FAST_COMPUTE_DTYPE, None, FAST_WIRE, FAST_CONTRACT),
    "balanced": (None, "tensorfloat32", None,
                 "TF32 tensor cores for every cuDNN convolution and LSTM and every "
                 "cuBLAS product (10-bit mantissa operands, fp32 accumulation)"),
    "quality": (None, "highest", "float32",
                "full fp32 (TF32 off) + bit-exact wire: the card's numerics held "
                "against the CPU forward"),
}


def resolve_preset(
    preset: str, wire: tp.Optional[str]
) -> tp.Tuple[tp.Optional[str], tp.Optional[str], tp.Optional[str],
              tp.Optional[str]]:
    """-> (compute_dtype, matmul_precision, wire, banner).

    ``wire`` is the user's stems-wire choice with ``None``/``"auto"`` meaning
    "not explicitly set": an explicit wire always wins over the preset, and
    the banner states the wire actually in effect."""
    if preset in (None, "default"):
        return None, None, wire, None
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    compute_dtype, matmul_precision, preset_wire, contract = PRESETS[preset]
    explicit = wire not in (None, "auto")
    wire_out = wire if explicit else (preset_wire if preset_wire else wire)
    banner = (f"preset {preset}: {contract}; stems wire: {wire_out}"
              + (" (explicit --wire override in effect)" if explicit else "")
              + " (see PERF.md)")
    return compute_dtype, matmul_precision, wire_out, banner


def resolve_fast_preset(
    preset: str, wire: tp.Optional[str]
) -> tp.Tuple[tp.Optional[str], tp.Optional[str], tp.Optional[str]]:
    """-> (compute_dtype, wire, banner), for callers of the older interface."""
    compute_dtype, _, wire_out, banner = resolve_preset(preset, wire)
    return compute_dtype, wire_out, banner
