"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU only; for a CUDA
tensor it launches its kernel or raises. Each wrapper carries an integer
``launches`` attribute, incremented once per kernel launch. A kernel on a
training path is an autograd function whose backward launches a kernel too.

Tables that the kernels and the forward read (windows, twiddles, envelopes,
positional embeddings) are built on the host once per shape and device and
cached by :func:`device_cache`.
"""

import contextlib
import functools

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

_RETAINED = None  # the list of retain_tables() while it is open, else None


def device_cache(maxsize: int):
    """Cache a builder of device tables, at most ``maxsize`` of them.

    The builder runs under ``torch.inference_mode(False)``: the tables must
    outlive an inference-mode caller and serve a later autograd-tracked one.
    It also runs outside ``torch.export``'s fake tensors and tracing: a table
    first looked up during an export is a real tensor, the program's
    constant, as it is when the cache already held it (so the graph does not
    depend on the cache), and no fake tensor is left in the cache.
    While :func:`retain_tables` is open, every table looked up is also kept in
    its list: a captured CUDA graph reads a table by its address, so the table
    must live as long as the graph, whatever the cache evicts meanwhile.
    """

    def wrap(build):
        @functools.lru_cache(maxsize=maxsize)
        def cached(*args):
            with torch.inference_mode(False), unset_fake_temporarily(), \
                    disable_proxy_modes_tracing():
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
