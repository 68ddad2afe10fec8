"""demucs_tpu_torch.kernels._build on the CPU: what names a built library, and
what the wrappers declare of its exports.

A library is found by the hash in its file name, so every input of the build
has to be in that hash, or an edit loads a stale library. nvcc is not needed:
nothing is compiled here.
"""

import ctypes
import importlib
import re
import sys
import types

import pytest

from demucs_tpu_torch.kernels import _build


def _edit_source(csrc):
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')


def _edit_header(csrc):
    (csrc / "h.cuh").write_text("// two\n")


def _add_header(csrc):
    (csrc / "new.cuh").write_text("// three\n")


@pytest.mark.parametrize("edit", [_edit_source, _edit_header, _add_header])
def test_library_path_changes_with_every_input(tmp_path, monkeypatch, edit):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    edit(tmp_path)
    after = _build.library_path("k")
    assert after != before and after.parent == before.parent == _build.BUILD_DIR


def test_library_path_changes_with_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// k\n")
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("k") != before


def test_build_keeps_the_compiler_report_beside_the_library(tmp_path, monkeypatch):
    """The registers and spills of a library built by an earlier process stay
    readable: the report lives beside the library, named by the same hash."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
                    "print('ptxas info    : Used 40 registers')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    report = _build.build(("k",))
    assert "Used 40 registers" in report["k"]["ptxas"]
    assert _build.library_path("k").is_file()
    assert _build.build(("k",)) == {}  # built: nothing compiled, the report still there
    assert _build.ptxas_report("k") == report["k"]["ptxas"]


@pytest.mark.parametrize("name", _build.SOURCES)
def test_sources_include_only_headers_of_csrc(name):
    """Every local include of a kernel source is a csrc/*.cuh, which the hash covers."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    for header in re.findall(r'#include\s+"([^"]+)"', text):
        assert header.endswith(".cuh") and (_build.CSRC / header).is_file(), header


class _FakeLib:
    """Stands in for a loaded library: records what the wrapper declares."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, types.SimpleNamespace())


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _exported(source):
    """name -> parameter ctypes of each function in the extern "C" block."""
    text = source.split('extern "C"', 1)[1]
    found = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", text, re.M):
        kinds = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1])
            kinds.append(ctypes.c_void_p if decl.endswith("*") else _C_TYPES[decl])
        found[name] = kinds
    return found


@pytest.mark.parametrize("module,source", [("stft", "stft"), ("attention", "flash_mha")])
def test_wrapper_argtypes_match_the_c_signature(monkeypatch, module, source):
    """A ctypes call with more or fewer arguments than the C function takes
    reads garbage off the stack; each wrapper must declare its exports'
    parameters as the source defines them."""
    mod = importlib.import_module(f"demucs_tpu_torch.kernels.{module}")
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    mod._lib.cache_clear()
    try:
        mod._lib()
    finally:
        mod._lib.cache_clear()
    exported = _exported((_build.CSRC / f"{source}.cu").read_text())
    assert set(fake.functions) == set(exported)
    for name, kinds in exported.items():
        assert fake.functions[name].argtypes == kinds, name
        assert fake.functions[name].restype is ctypes.c_int, name
