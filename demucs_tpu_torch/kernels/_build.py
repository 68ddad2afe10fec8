"""Build ``csrc/*.cu`` with ``nvcc`` into shared libraries, load them with ctypes.

Each source is compiled on its own (one ``nvcc`` per source, all started
together by :func:`build`) for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout, named by a hash of the source, every header in ``csrc/``
(``*.cuh``) and the flags, so an edited source or header never loads a
stale library. The build runs at the first CUDA call of
a kernel, or up front through :func:`build`. The libraries have a plain C
interface: every pointer and the stream are passed as ``ctypes.c_void_p``,
and every entry point returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception. A missing ``nvcc`` or a failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("stft", "flash_mha", "flash_mha_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as torch resolves it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of demucs_tpu_torch "
                           "cannot be built without the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_path(name: str) -> Path:
    """The compiler report kept beside the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> str:
    """nvcc's report (``-Xptxas=-v``: registers, shared memory, spills) of the
    library of ``csrc/<name>.cu`` as it stands, whichever call built it."""
    return ptxas_path(name).read_text()


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, in parallel.

    Returns ``{name: {"seconds": wall time, "ptxas": compiler report}}`` for
    the sources compiled by this call (registers, shared memory, spills); the
    report is also kept beside the library (:func:`ptxas_report`).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    start = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        ptxas_path(name).write_text(out)  # before the library: a built one has its report
        os.replace(tmp, library_path(name))  # atomic: readers never see a partial file
        report[name] = {"seconds": time.perf_counter() - start, "ptxas": out}
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as an integer handle.
    ``device`` must be the current device (``torch.cuda.device(...)``): the
    runtime launches a kernel on the current device and fails a launch on a
    stream of another one."""
    import torch

    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(f"a kernel launch on {device} while cuda:{current} is the current "
                           "device: launch it under torch.cuda.device(...)")
    return torch.cuda.current_stream(device).cuda_stream
