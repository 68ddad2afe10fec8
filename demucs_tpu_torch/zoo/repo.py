"""Model repositories: the remote zoo, local folders, bag definitions
(port of ``demucs_tpu/zoo/repo.py``; behavioral reference ``demucs/repo.py``).

The signature -> URL registry and the released bag definitions are the JAX
package's tables, copied. A local folder holds ``.th`` (the reference's
packages, ``zoo/convert.py::load_th_model``) and ``.dmx`` files
(``zoo/native.py``), named ``<sig>.<ext>`` or ``<sig>-<8 hex of the file's
sha256>.<ext>`` (the hex is checked), and bag files ``<name>.yaml``. Bag
files are read by :func:`read_bag_file`, the port's own reader of the flat
subset the bags use (``models``, ``weights``, ``segment``), so no YAML
package is needed. Repositories return models on the CPU.
"""

from __future__ import annotations

import ast
import re
import typing as tp
from hashlib import sha256
from pathlib import Path

from demucs_tpu_torch.models.registry import BagOfModels, Model

ROOT_URL = "https://dl.fbaipublicfiles.com/demucs/"

# Signature -> URL, from the reference's remote/files.txt.
REMOTE_FILES = {
    # MDX models (root: mdx_final/)
    **{
        sig_file.split("-", 1)[0]: ROOT_URL + "mdx_final/" + sig_file
        for sig_file in [
            "0d19c1c6-0f06f20e.th", "5d2d6c55-db83574e.th", "7d865c68-3d5dd56b.th",
            "7ecf8ec1-70f50cc9.th", "a1d90b5c-ae9d2452.th", "c511e2ab-fe698775.th",
            "cfa93e08-61801ae1.th", "e51eebcc-c1b80bdd.th", "6b9c2ca1-3fd82607.th",
            "b72baf4e-8778635e.th", "42e558d4-196e0e1b.th", "305bc58f-18378783.th",
            "14fc6a69-a89dd0ee.th", "464b36d7-e5a9386e.th", "7fd6ef75-a905dd85.th",
            "83fc094f-4a16d450.th", "1ef250f1-592467ce.th", "902315c2-b39ce9c9.th",
            "9a6b4851-03af0aa6.th", "fa0cb7f9-100d8bf4.th",
        ]
    },
    # Hybrid Transformer models (root: hybrid_transformer/)
    **{
        sig_file.split("-", 1)[0]: ROOT_URL + "hybrid_transformer/" + sig_file
        for sig_file in [
            "955717e8-8726e21a.th", "f7e0c4bc-ba3fe64a.th", "d12395a8-e57c48e6.th",
            "92cfc3b6-ef3bcb9c.th", "04573f0d-f3cf25b2.th", "75fc33f5-1941ce65.th",
            "5c90dfd2-34c22ccb.th",
        ]
    },
}

# Bag definitions, from the reference's remote/*.yaml.
_MDX_WEIGHTS = [[1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 1.0, 1.0],
                [1.0, 0.0, 1.0, 1.0]]
REMOTE_BAGS: tp.Dict[str, dict] = {
    "htdemucs": {"models": ["955717e8"]},
    "htdemucs_ft": {
        "models": ["f7e0c4bc", "d12395a8", "92cfc3b6", "04573f0d"],
        "weights": [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
                    [0.0, 0.0, 0.0, 1.0]],
    },
    "htdemucs_6s": {"models": ["5c90dfd2"]},
    "hdemucs_mmi": {"models": ["75fc33f5"], "segment": 44},
    "mdx": {"models": ["0d19c1c6", "7ecf8ec1", "c511e2ab", "7d865c68"],
            "weights": _MDX_WEIGHTS, "segment": 44},
    "mdx_extra": {"models": ["e51eebcc", "a1d90b5c", "5d2d6c55", "cfa93e08"], "segment": 44},
    "mdx_q": {"models": ["6b9c2ca1", "b72baf4e", "42e558d4", "305bc58f"],
              "weights": _MDX_WEIGHTS, "segment": 44},
    "mdx_extra_q": {"models": ["83fc094f", "464b36d7", "14fc6a69", "7fd6ef75"], "segment": 44},
    "repro_mdx_a": {"models": ["9a6b4851", "1ef250f1", "fa0cb7f9", "902315c2"], "segment": 44},
    "repro_mdx_a_time_only": {
        "models": ["9a6b4851", "9a6b4851", "1ef250f1", "1ef250f1"], "segment": 44},
    "repro_mdx_a_hybrid_only": {
        "models": ["fa0cb7f9", "902315c2", "fa0cb7f9", "902315c2"], "segment": 44},
}


class ModelLoadingError(RuntimeError):
    pass


def check_checksum(path: Path, checksum: str) -> None:
    """Raise unless the sha256 of ``path`` starts with ``checksum``."""
    sha = sha256()
    with open(path, "rb") as file:
        for buf in iter(lambda: file.read(2**20), b""):
            sha.update(buf)
    actual = sha.hexdigest()[: len(checksum)]
    if actual != checksum:
        raise ModelLoadingError(
            f"Invalid checksum for file {path}, expected {checksum} but got {actual}")


def _model_from_file(file: Path) -> Model:
    if file.suffix == ".dmx":
        from demucs_tpu_torch.zoo.native import load_native_model

        return load_native_model(file, device="cpu")
    from demucs_tpu_torch.zoo.convert import load_th_model

    return load_th_model(file)


_BAG_KEYS = ("models", "weights", "segment")


def _scalar(text: str):
    """A plain or quoted YAML 1.1 scalar: a float needs its dot (so a
    signature such as ``955717e8`` stays a string, as PyYAML reads it)."""
    text = text.strip()
    if text[:1] in "'\"":
        return ast.literal_eval(text)
    if re.fullmatch(r"[-+]?[0-9]+", text):
        return int(text)
    if re.fullmatch(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?", text):
        return float(text.replace("_", ""))
    return text


def _flow(text: str):
    """A YAML flow sequence of scalars and flow sequences, ``[a, 'b', [1., 0]]``."""
    tokens = re.findall(r"\[|\]|,|'[^']*'|\"[^\"]*\"|[^\[\],\s][^\[\],]*", text)
    pos = 0

    def value():
        nonlocal pos
        token = tokens[pos]
        pos += 1
        if token != "[":
            return _scalar(token)
        items = []
        while tokens[pos] != "]":
            items.append(value())
            if tokens[pos] == ",":
                pos += 1
        pos += 1
        return items

    out = value()
    if pos != len(tokens):
        raise ValueError(f"trailing text after a flow sequence: {text!r}")
    return out


def _block(lines: tp.List[tp.Tuple[int, str]]) -> list:
    """A YAML block sequence from ``(indent, text)`` lines, each item a
    scalar, a flow sequence or a nested block sequence (``- - 1.0``)."""
    base = lines[0][0]
    items = []
    i = 0
    while i < len(lines):
        indent, text = lines[i]
        if indent != base or not text.startswith("-"):
            raise ValueError(f"a line of a block sequence without its '-': {text!r}")
        j = i + 1
        while j < len(lines) and lines[j][0] > base:
            j += 1
        rest = text[1:]
        item = rest.strip()
        children = lines[i + 1 : j]
        if item.startswith("-"):  # a nested sequence begins on this line
            items.append(_block([(base + 1 + len(rest) - len(rest.lstrip()), item)] + children))
        elif item.startswith("["):
            items.append(_flow(" ".join([item] + [t for _, t in children])))
        elif not item and children:
            items.append(_block(children))
        elif children:
            raise ValueError(f"text under the scalar {item!r}")
        else:
            items.append(_scalar(item))
        i = j
    return items


def read_bag_file(path) -> dict:
    """A bag definition file -> ``{"models": [...], "weights"?: [[...]], "segment"?: x}``.

    Reads the subset of YAML the bags are written in: top-level ``key:
    value`` lines for ``models``, ``weights`` and ``segment``, where a value
    is a scalar, a flow sequence (``[...]``, over several lines if need be)
    or a block sequence (``- item`` lines, nested ones included); ``#``
    comments. Anything else raises, naming the file."""
    path = Path(path)
    entries: tp.Dict[str, tp.List[tp.Tuple[int, str]]] = {}
    key = None
    for raw in path.read_text().splitlines():
        line = re.sub(r"\s+#.*$|^\s*#.*$", "", raw).rstrip()
        if not line.strip():
            continue
        match = re.match(r"^([A-Za-z_]\w*)\s*:(.*)$", line)
        if match:
            key = match.group(1)
            if key not in _BAG_KEYS or key in entries:
                raise ValueError(f"{path}: unexpected or repeated key {key!r}")
            value = match.group(2).strip()
            entries[key] = [(1, value)] if value else []
        elif key is None:
            raise ValueError(f"{path}: text before the first key: {raw!r}")
        else:
            entries[key].append((len(line) - len(line.lstrip()), line.strip()))
    bag: tp.Dict[str, tp.Any] = {}
    try:
        for key, lines in entries.items():
            texts = [t for _, t in lines]
            if texts and texts[0].startswith("-"):
                bag[key] = _block(lines)
            elif texts and texts[0].startswith("["):
                bag[key] = _flow(" ".join(texts))
            elif len(texts) == 1:
                bag[key] = _scalar(texts[0])
            else:
                raise ValueError(f"cannot read the value of {key!r}")
    except (ValueError, IndexError, SyntaxError) as err:
        raise ValueError(f"{path}: not a bag definition this reader understands ({err})") \
            from None
    if not isinstance(bag.get("models"), list):
        raise ValueError(f"{path}: a bag needs a list of models")
    bag["models"] = [str(sig) for sig in bag["models"]]
    return bag


class ModelOnlyRepo:
    def has_model(self, sig: str) -> bool:
        raise NotImplementedError()

    def get_model(self, sig: str) -> Model:
        raise NotImplementedError()

    def list_model(self) -> tp.Dict[str, tp.Union[str, Path]]:
        raise NotImplementedError()


class RemoteRepo(ModelOnlyRepo):
    """The reference's released ``.th`` packages, from a local cache folder,
    downloaded into it with ``urllib`` when missing (checked against the
    file name's sha256 prefix before the file enters the cache)."""

    def __init__(self, models: tp.Optional[tp.Dict[str, str]] = None,
                 cache_dir: tp.Optional[Path] = None):
        self._models = dict(REMOTE_FILES if models is None else models)
        self.cache_dir = Path(cache_dir or Path.home() / ".cache" / "demucs_tpu" / "checkpoints")

    def has_model(self, sig: str) -> bool:
        return sig in self._models

    def get_model(self, sig: str) -> Model:
        try:
            url = self._models[sig]
        except KeyError:
            raise ModelLoadingError(
                f"Could not find a pre-trained model with signature {sig}.") from None
        filename = url.rsplit("/", 1)[-1]
        target = self.cache_dir / filename
        checksum = filename.rsplit("-", 1)[-1].split(".", 1)[0]
        if not target.exists():
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            import urllib.request

            tmp = target.with_suffix(".tmp")
            try:
                urllib.request.urlretrieve(url, tmp)
                check_checksum(tmp, checksum)  # before the file enters the cache
                tmp.rename(target)
            except OSError as exc:
                raise ModelLoadingError(
                    f"Could not download {url} ({exc}). Without network access, place "
                    f"the checkpoint at {target} or use a local --repo folder.") from None
            except ModelLoadingError:
                tmp.unlink(missing_ok=True)
                raise
        else:
            check_checksum(target, checksum)
        return _model_from_file(target)

    def list_model(self) -> tp.Dict[str, tp.Union[str, Path]]:
        return dict(self._models)


class LocalRepo(ModelOnlyRepo):
    """The ``*.th`` and ``*.dmx`` files of a folder, by signature
    (``demucs/repo.py:76-110``)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.scan()

    def scan(self) -> None:
        self._models: tp.Dict[str, Path] = {}
        self._checksums: tp.Dict[str, str] = {}
        for file in sorted(self.root.iterdir()):
            if file.suffix not in (".th", ".dmx"):
                continue
            stem, dash, tail = file.stem.rpartition("-")
            if dash and len(tail) == 8 and all(c in "0123456789abcdef" for c in tail):
                sig = stem
                self._checksums[sig] = tail
            else:  # other dashes belong to the name itself
                sig = file.stem
            if sig in self._models:
                raise ModelLoadingError(
                    f"Duplicate pre-trained model exist for signature {sig}. "
                    "Please delete all but one.")
            self._models[sig] = file

    def has_model(self, sig: str) -> bool:
        return sig in self._models

    def get_model(self, sig: str) -> Model:
        try:
            file = self._models[sig]
        except KeyError:
            raise ModelLoadingError(
                f"Could not find pre-trained model with signature {sig}.") from None
        if sig in self._checksums:
            check_checksum(file, self._checksums[sig])
        return _model_from_file(file)

    def list_model(self) -> tp.Dict[str, tp.Union[str, Path]]:
        return dict(self._models)


class BagOnlyRepo:
    """Bag definitions: the released ones, or the ``*.yaml`` files of a local
    folder (``demucs/repo.py:113-145``)."""

    def __init__(self, root: tp.Optional[Path], model_repo: ModelOnlyRepo,
                 bags: tp.Optional[tp.Dict[str, dict]] = None):
        self.root = Path(root) if root is not None else None
        self.model_repo = model_repo
        self._static_bags = dict(REMOTE_BAGS if bags is None else bags)
        self.scan()

    def scan(self) -> None:
        self._bags: tp.Dict[str, tp.Union[dict, Path]] = dict(self._static_bags)
        if self.root is not None and self.root.is_dir():
            self._bags = {file.stem: file for file in sorted(self.root.iterdir())
                          if file.suffix == ".yaml"}

    def has_model(self, name: str) -> bool:
        return name in self._bags

    def get_model(self, name: str) -> BagOfModels:
        try:
            bag = self._bags[name]
        except KeyError:
            raise ModelLoadingError(
                f"{name} is neither a single pre-trained model or a bag of models.") from None
        if isinstance(bag, Path):
            bag = read_bag_file(bag)
        models = [self.model_repo.get_model(sig) for sig in bag["models"]]
        return BagOfModels(models, bag.get("weights"), bag.get("segment"))

    def list_model(self) -> tp.Dict[str, tp.Union[str, Path, dict]]:
        return dict(self._bags)


class AnyModelRepo:
    def __init__(self, model_repo: ModelOnlyRepo, bag_repo: BagOnlyRepo):
        self.model_repo = model_repo
        self.bag_repo = bag_repo

    def has_model(self, name_or_sig: str) -> bool:
        return self.model_repo.has_model(name_or_sig) or self.bag_repo.has_model(name_or_sig)

    def get_model(self, name_or_sig: str) -> tp.Union[Model, BagOfModels]:
        if self.model_repo.has_model(name_or_sig):
            return self.model_repo.get_model(name_or_sig)
        return self.bag_repo.get_model(name_or_sig)

    def list_model(self) -> tp.Dict[str, tp.Union[str, Path, dict]]:
        models = self.model_repo.list_model()
        models.update(self.bag_repo.list_model())
        return models
