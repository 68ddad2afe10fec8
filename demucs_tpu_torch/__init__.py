"""PyTorch / CUDA port of ``demucs_tpu`` for NVIDIA Hopper (H100).

The JAX package ``demucs_tpu`` stays the reference. This package imports
``torch`` and numpy only: it keeps its own copies of what it needs from the
JAX package, and its three TPU kernels (STFT, iSTFT, flash attention) are
CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built at their first CUDA
call (``demucs_tpu_torch.kernels._build``). It runs the three model families
(HTDemucs, HDemucs, Demucs v2) under the JAX package's precision policies
(``presets.py``; ``models/htdemucs.py::precision_scope``) and loads the
reference's ``.th`` packages, ``.dmx`` archives and bag definitions
(``zoo/``).

Entry points run on the card (``"cuda"``) unless the caller asks for the CPU;
asking for ``"cuda"`` without a card raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent.

    Only ``"cuda"`` (any index) and ``"cpu"`` are accepted: there is no
    silent fall-back from the card to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
