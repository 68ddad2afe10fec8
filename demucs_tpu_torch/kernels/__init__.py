"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU only; for a CUDA
tensor it launches its kernel or raises. Each wrapper carries an integer
``launches`` attribute, incremented once per kernel launch.

Tables that the kernels and the forward read (windows, twiddles, envelopes,
positional embeddings) are built on the host once per shape and device and
cached by :func:`device_cache`.
"""

import contextlib
import functools

import torch

_RETAINED = None  # the list of retain_tables() while it is open, else None


def device_cache(maxsize: int):
    """Cache a builder of device tables, at most ``maxsize`` of them.

    The builder runs under ``torch.inference_mode(False)``: the tables must
    outlive an inference-mode caller and serve a later autograd-tracked one.
    While :func:`retain_tables` is open, every table looked up is also kept in
    its list: a captured CUDA graph reads a table by its address, so the table
    must live as long as the graph, whatever the cache evicts meanwhile.
    """

    def wrap(build):
        @functools.lru_cache(maxsize=maxsize)
        def cached(*args):
            with torch.inference_mode(False):
                return build(*args)

        @functools.wraps(build)
        def get(*args):
            table = cached(*args)
            if _RETAINED is not None:
                _RETAINED.append(table)
            return table

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get

    return wrap


@contextlib.contextmanager
def retain_tables():
    """Collect every cached table looked up inside the block (see
    :func:`device_cache`); the caller keeps the list as long as it needs them."""
    global _RETAINED
    outer, _RETAINED = _RETAINED, []
    try:
        yield _RETAINED
    finally:
        _RETAINED = outer


class NoBackward(torch.autograd.Function):
    """Run a kernel launch as an autograd node whose backward raises.

    For a kernel without a backward kernel: only K3's bf16 route now (K1, K2
    and K3's fp32 route are autograd functions whose backward launches a
    kernel). A launch that wrote into a fresh tensor would otherwise cut the
    graph silently, and training would run on wrong gradients; with this node
    the forward works in any grad mode and a backward through the kernel
    fails loudly.
    """

    @staticmethod
    def forward(ctx, name, launch, *inputs):
        ctx.name = name
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"{ctx.name} has no backward kernel: bf16 training comes "
                                  "with a later slice of the port")
