"""The rows of a data-parallel global batch that this rank holds.

JAX trains data-parallel as one program over the global batch: its random
draws (the augments, dropout, CAPE's shifts) are draws for the global batch,
whatever the process holding a row. Here each rank runs its own rows, so the
train step sets :func:`global_rows` around its augment and forward, and each
batch-shaped draw is made for the global batch from the generator every rank
shares (seeded alike) and cut to this rank's rows. K3's hashed dropout salts
each batch-head ``bh = b * H + h`` with ``bh * 0x27D4EB2F``; a rank adds
``offset * H * 0x27D4EB2F`` to its seed (:func:`dropout_seed`), so two ranks
drop exactly the scores one process drops on the global batch, with no kernel
change. Outside the context a batch is its own global batch.
"""

from __future__ import annotations

import contextlib
import typing as tp

__all__ = ["global_rows", "current", "dropout_seed"]

_ROWS: tp.Optional[tp.Tuple[int, int]] = None


@contextlib.contextmanager
def global_rows(offset: int, total: int):
    """Inside the block this rank's batch is rows ``[offset, offset + B)`` of
    a global batch of ``total`` rows."""
    global _ROWS
    outer, _ROWS = _ROWS, (int(offset), int(total))
    try:
        yield
    finally:
        _ROWS = outer


def current(batch: int) -> tp.Tuple[int, int]:
    """``(offset, total)`` of a local batch of ``batch`` rows: ``(0, batch)``
    outside :func:`global_rows`."""
    if _ROWS is None:
        return 0, batch
    offset, total = _ROWS
    if offset + batch > total:
        raise ValueError(f"rows [{offset}, {offset + batch}) outside a global batch of {total}")
    return offset, total


def dropout_seed(seed: int, batch: int, num_heads: int) -> int:
    """K3's dropout seed for this rank's rows (module docstring), uint32."""
    offset, _ = current(batch)
    return (int(seed) + offset * num_heads * 0x27D4EB2F) & 0xFFFFFFFF
