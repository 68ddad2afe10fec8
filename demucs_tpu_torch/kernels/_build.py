"""Build ``csrc/*.cu`` with ``nvcc`` into shared libraries, load them with ctypes.

Each source is compiled on its own (one ``nvcc`` per source, all started
together by :func:`build`) for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout, named by a hash of the source, every header in ``csrc/``
(``*.cuh``) and the flags, so an edited source or header never loads a
stale library. A library of several sources (``PARTS``: K3's masked forward
kernels and its head dim 128 instances beside its unmasked ones, and the
backwards' head dim 128 instances beside theirs) compiles
each to an object in parallel with the rest and links them into one
library. The build runs at the first CUDA call of a kernel, or up front
through :func:`build`. The libraries have a plain C
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
SOURCES = ("stft", "flash_mha", "flash_mha_bwd", "flash_mha_bwd_masked")
# the libraries linked from several sources, each compiled on its own: K3's
# forward (flash_mha.cu's C entries call flash_mha_masked.cu's launches and,
# at head dim 128, flash_mha_d128.cu's) and its backwards (at head dim 128
# their d128 sources')
PARTS = {"flash_mha": ("flash_mha", "flash_mha_masked", "flash_mha_d128"),
         "flash_mha_bwd": ("flash_mha_bwd", "flash_mha_bwd_d128"),
         "flash_mha_bwd_masked": ("flash_mha_bwd_masked", "flash_mha_bwd_masked_d128")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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


def parts(name: str, csrc: Path | None = None) -> list:
    """The sources of library ``name`` in ``csrc`` (the package's by
    default): ``<name>.cu``, then its other parts that ``csrc`` holds (an
    older checkout's may lack them)."""
    csrc = CSRC if csrc is None else Path(csrc)
    return [p for p in PARTS.get(name, (name,)) if p == name or (csrc / f"{p}.cu").exists()]


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in parts(name):
        digest.update((CSRC / f"{part}.cu").read_bytes())
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


class Job:
    """nvcc for one library of ``csrc``'s sources into ``out``, started at
    once: one process for a single source; for several (:func:`parts`) one
    compile to an object each, linked by :meth:`finish`."""

    def __init__(self, name: str, csrc: Path, out: Path, nvcc: str):
        self.name, self.out, self.nvcc = name, Path(out), nvcc
        self.start = time.perf_counter()
        sources = [Path(csrc) / f"{p}.cu" for p in parts(name, csrc)]
        if len(sources) == 1:
            self.objects = []
            cmds = [[nvcc, *NVCC_FLAGS, "-o", str(self.out), str(sources[0])]]
        else:
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            self.objects = [self.out.with_name(f"{self.out.name}.{s.stem}.o") for s in sources]
            cmds = [[nvcc, *compile_flags, "-c", "-o", str(o), str(s)]
                    for o, s in zip(self.objects, sources)]
        self.procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for cmd in cmds]

    def finish(self) -> tuple:
        """Wait for the compiles and link -> (nvcc's report, an error or None)."""
        outs, error = [], None
        for proc in self.procs:
            out, _ = proc.communicate()
            outs.append(out)
            if proc.returncode != 0 and error is None:
                error = f"nvcc failed for {self.name} (exit {proc.returncode}):\n{out}"
        if self.objects and error is None:
            link = subprocess.run([self.nvcc, *LINK_FLAGS, "-o", str(self.out),
                                   *map(str, self.objects)], capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                error = f"nvcc failed to link {self.name} (exit {link.returncode}):\n{outs[-1]}"
        for obj in self.objects:
            obj.unlink(missing_ok=True)
        return "".join(outs), error


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
    jobs = {}
    start = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        jobs[name] = (tmp, Job(name, CSRC, Path(tmp), nvcc))
    report, errors = {}, []
    for name, (tmp, job) in jobs.items():
        out, error = job.finish()
        if error is not None:
            Path(tmp).unlink(missing_ok=True)
            errors.append(error)
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
