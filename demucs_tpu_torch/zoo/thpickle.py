"""Reader of the reference's ``.th`` checkpoints that runs no code from the
file (port of ``demucs_tpu/zoo/thpickle.py``, a copy).

``torch.load(weights_only=False)`` would run whatever the pickle stream asks
for and import the ``demucs`` package to resolve the model class;
``weights_only=True`` refuses that class. So the format is parsed directly:

The reference serializes models as a torch pickle of
``{klass, args, kwargs, state, training_args}`` (``demucs/states.py:121-132``)
where ``klass`` is the model class object.

- torch's zip container (``<name>/data.pkl`` + ``<name>/data/<key>`` raw
  storage payloads, the "new zipfile serialization" every released demucs
  checkpoint uses);
- a restricted ``pickle.Unpickler`` whose ``find_class`` resolves ONLY:
  * an explicit allowlist of safe stdlib/torch-metadata globals
    (``collections.OrderedDict``, ``fractions.Fraction``, ``torch.Size`` ->
    ``tuple``, the ``_rebuild_tensor*`` functions reimplemented on numpy),
  * ``torch.*Storage`` dtype markers,
  * ``demucs.*`` / ``diffq.*`` class globals, mapped to inert
    :class:`ClassStub` name carriers (never instantiated by the stream —
    the format stores the class itself, not an instance);
  anything else raises ``UnpicklingError``.

Tensors come back as numpy arrays (fp16 kept; ``zoo.convert.load_flat_state``
promotes it). bfloat16 storages are widened to float32 here (numpy has no
bfloat16). Reference format: ``demucs/states.py:50-132``,
``demucs/repo.py:63-70``.
"""

from __future__ import annotations

import collections
import fractions
import io
import pickle
import typing as tp
import zipfile

import numpy as np

__all__ = ["read_th", "ClassStub"]


class ClassStub:
    """Inert stand-in for a pickled class global (e.g.
    ``demucs.htdemucs.HTDemucs``). Carries the dotted name; calling it (which
    a well-formed checkpoint never does) raises."""

    def __init__(self, module: str, name: str):
        self.__module__ = module
        self.__name__ = name

    def __call__(self, *a, **k):  # pragma: no cover - malformed stream guard
        raise pickle.UnpicklingError(
            f"refusing to instantiate pickled class {self.__module__}.{self.__name__}")

    def __repr__(self):
        return f"<ClassStub {self.__module__}.{self.__name__}>"


# torch legacy storage-class name -> numpy dtype (torch/storage.py naming).
_STORAGE_DTYPES: tp.Dict[str, tp.Callable[[], np.dtype]] = {
    "DoubleStorage": lambda: np.dtype(np.float64),
    "FloatStorage": lambda: np.dtype(np.float32),
    "HalfStorage": lambda: np.dtype(np.float16),
    "LongStorage": lambda: np.dtype(np.int64),
    "IntStorage": lambda: np.dtype(np.int32),
    "ShortStorage": lambda: np.dtype(np.int16),
    "CharStorage": lambda: np.dtype(np.int8),
    "ByteStorage": lambda: np.dtype(np.uint8),
    "BoolStorage": lambda: np.dtype(np.bool_),
    "BFloat16Storage": lambda: np.dtype(np.uint16),  # raw bits, widened in persistent_load
    "ComplexFloatStorage": lambda: np.dtype(np.complex64),
    "ComplexDoubleStorage": lambda: np.dtype(np.complex128),
}


class _StorageType:
    def __init__(self, name: str):
        self.dtype = _STORAGE_DTYPES[name]()
        self.bfloat16 = name == "BFloat16Storage"


def _rebuild_tensor(storage: np.ndarray, storage_offset: int, size, stride,
                    *_unused) -> np.ndarray:
    """numpy reimplementation of ``torch._utils._rebuild_tensor_v2``
    (ignores requires_grad / backward hooks / metadata trailers)."""
    size = tuple(int(s) for s in size)
    storage_offset = int(storage_offset)
    if not 0 <= storage_offset <= storage.size:
        raise ValueError(f"tensor storage_offset {storage_offset} outside "
                         f"storage of {storage.size} elements")
    if not size:
        if storage_offset >= storage.size:
            raise ValueError("scalar tensor offset out of bounds")
        return storage[storage_offset].copy().reshape(())
    # Bounds-check the strided extent against the storage BEFORE building the
    # view: as_strided trusts its arguments, so a crafted checkpoint could
    # otherwise read arbitrary process memory (this loader's whole point is
    # safe parsing of untrusted downloads).
    stride = tuple(int(s) for s in stride)
    if any(s < 0 for s in stride) or any(d < 0 for d in size):
        raise ValueError(f"negative tensor stride/size {stride}/{size}")
    max_index = storage_offset + sum(
        s * (d - 1) for s, d in zip(stride, size) if d > 0)
    n_elems = 1
    for d in size:
        n_elems *= d
    if n_elems > 0 and max_index >= storage.size:
        raise ValueError(
            f"tensor extent {max_index + 1} exceeds storage of "
            f"{storage.size} elements (size={size}, stride={stride})")
    itemsize = storage.dtype.itemsize
    byte_strides = tuple(s * itemsize for s in stride)
    view = np.lib.stride_tricks.as_strided(
        storage[storage_offset:], shape=size, strides=byte_strides)
    return np.ascontiguousarray(view)


def _rebuild_parameter(data: np.ndarray, _requires_grad=True, *_unused) -> np.ndarray:
    return data


_SAFE_GLOBALS: tp.Dict[tp.Tuple[str, str], tp.Any] = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("collections", "defaultdict"): collections.defaultdict,
    ("fractions", "Fraction"): fractions.Fraction,
    ("builtins", "complex"): complex,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "bytearray"): bytearray,
    ("torch", "Size"): tuple,
    ("torch._utils", "_rebuild_tensor"): _rebuild_tensor,
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
    ("torch._utils", "_rebuild_tensor_v3"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch.serialization", "_get_layout"): lambda name: name,
    ("numpy", "dtype"): np.dtype,
    ("numpy", "ndarray"): np.ndarray,
    # numpy's ndarray reduce encodes raw bytes via _codecs.encode
    ("_codecs", "encode"): __import__("codecs").encode,
}

# numpy moved its internals core -> _core; accept the GLOBAL spelling of both
# serializer generations.
_np_multiarray = getattr(np, "_core", None) or np.core  # type: ignore[attr-defined]
for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
    _SAFE_GLOBALS[(_mod, "_reconstruct")] = _np_multiarray.multiarray._reconstruct
    _SAFE_GLOBALS[(_mod, "scalar")] = _np_multiarray.multiarray.scalar

# Untrusted-but-expected class globals from the serializing environment. Only
# the *names* are meaningful to us; they resolve to inert stubs.
_STUB_ROOTS = ("demucs", "diffq", "omegaconf", "dora")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[key]
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(name)
        if module.split(".", 1)[0] in _STUB_ROOTS:
            return ClassStub(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not on the checkpoint allowlist "
            "(refusing to resolve untrusted pickled code)")


def _unpickle(data: bytes, persistent_load) -> tp.Any:
    up = _RestrictedUnpickler(io.BytesIO(data), encoding="utf-8")
    up.persistent_load = persistent_load
    return up.load()


def read_th(path) -> tp.Any:
    """Parse a torch-serialized object hermetically -> plain python structure
    with tensors as numpy arrays and foreign classes as :class:`ClassStub`.

    Supports torch's zip container (torch >= 1.6 default — all released
    demucs checkpoints) and the pre-1.6 legacy stream."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head[:4] == b"PK\x03\x04":
        return _read_zip(path)
    return _read_legacy(path)


def _read_zip(path) -> tp.Any:
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("/data.pkl")]
        if not pkl_names:
            raise pickle.UnpicklingError(f"{path}: no data.pkl in torch zip archive")
        prefix = pkl_names[0][: -len("data.pkl")]
        byteorder = "little"
        bo_name = prefix + "byteorder"
        if bo_name in zf.namelist():
            byteorder = zf.read(bo_name).decode().strip() or "little"
        storages: tp.Dict[str, np.ndarray] = {}

        def persistent_load(saved_id):
            typename, storage_type, key, _location, numel = saved_id
            tag = typename.decode() if isinstance(typename, bytes) else typename
            if tag != "storage":
                raise pickle.UnpicklingError(f"unknown persistent id tag {tag!r}")
            if key not in storages:
                dtype = storage_type.dtype
                raw = zf.read(f"{prefix}data/{key}")
                arr = np.frombuffer(raw, dtype=dtype, count=int(numel))
                if byteorder != "little" and dtype.itemsize > 1:  # pragma: no cover
                    arr = arr.byteswap()
                if storage_type.bfloat16:  # the high half of a float32
                    arr = (arr.astype(np.uint32) << 16).view(np.float32)
                storages[key] = np.array(arr)  # writable copy
            return storages[key]

        return _unpickle(zf.read(pkl_names[0]), persistent_load)


def _read_legacy(path) -> tp.Any:
    """Pre-torch-1.6 streams (and anything else that isn't a zip container)
    are rejected: every released demucs checkpoint (2021+,
    ``demucs/remote/files.txt``) uses the zip serialization, and the
    reference itself requires ``tools/convert.py`` for older dev
    checkpoints, a migration the JAX package does not carry either."""
    raise pickle.UnpicklingError(
        f"{path}: not a torch zip archive. Pre-2021 legacy checkpoints are "
        "not supported; convert them with the reference's tools/convert.py "
        "first.")
