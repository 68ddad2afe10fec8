"""Package rules of the port: no JAX and nothing of demucs_tpu inside
demucs_tpu_torch or chip_smoke.py, and the card as the default device."""

import ast
from pathlib import Path

import pytest
import torch

from demucs_tpu_torch import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "demucs_tpu")


def _port_files():
    return sorted((REPO / "demucs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in _port_files()}
    assert {"chip_smoke.py", "htdemucs.py", "attention.py", "stft.py", "api.py", "native.py",
            "flacio.py", "mp3io.py", "avio.py", "audio.py", "streaming.py", "serve.py",
            "sparse.py", "bsseval.py", "evaluate.py", "distrib.py", "run_sdr.py",
            "timestretch.py", "repitch.py", "svd.py", "quantize.py", "core.py", "run.py",
            "release.py", "launcher.py", "distprobe.py", "sharded.py", "tp.py",
            "rows.py"} <= names
    paths = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"demucs_tpu_torch/parallel/__init__.py", "demucs_tpu_torch/grids/__init__.py",
            "demucs_tpu_torch/grids/__main__.py"} <= paths


def test_port_builds_its_own_native_sources():
    """The C++ of the port's codecs is its own (csrc/), never the JAX package's
    native/ folder: no module of the port names that folder in a path."""
    from demucs_tpu_torch import native

    assert native.CSRC == REPO / "demucs_tpu_torch" / "csrc"
    assert {"codec.cpp", "avio.cpp", "wavio.cpp"} <= {p.name for p in native.CSRC.glob("*.cpp")}
    for path in _port_files():
        text = path.read_text()
        assert '/ "native"' not in text and "'native/" not in text and '"native/' not in text, \
            path.name


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
