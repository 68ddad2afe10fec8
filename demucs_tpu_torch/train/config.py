"""Training configuration tree and XP signatures (port of
``demucs_tpu/train/config.py``; behavioral reference ``conf/config.yaml`` and
Dora's config-delta hashing, ``docs/training.md:45-83``).

``TrainArgs`` and its sections are copies of the JAX package's dataclasses,
with the same fields and defaults (``tests/test_torch_train.py`` holds them
field by field), so an XP has the same signature in both packages.
Command-line overrides are Hydra-style ``key=value`` tokens whose values are
read as YAML 1.1 flow scalars by a small reader of the port's own (no PyYAML
on the card's machine).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
import typing as tp

__all__ = ["TrainArgs", "apply_overrides", "parse_cli_overrides", "expand_presets",
           "xp_signature", "DSET_PRESETS"]


@dataclasses.dataclass
class DsetConfig:
    musdb: str = ""
    musdb_samplerate: int = 44100
    use_musdb: bool = True
    wav: tp.Optional[str] = None
    wav2: tp.Optional[str] = None
    wav2_weight: tp.Optional[float] = None
    wav2_valid: bool = False
    segment: float = 11
    shift: float = 1
    train_valid: bool = False
    full_cv: bool = True
    samplerate: int = 44100
    channels: int = 2
    normalize: bool = True
    metadata: str = "./metadata"
    sources: tp.Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    valid_samples: tp.Optional[int] = None
    valid_tracks: tp.Optional[tp.Tuple[str, ...]] = None


@dataclasses.dataclass
class TestConfig:
    save: bool = False
    best: bool = True
    nonhq: tp.Optional[str] = None  # the compressed MUSDB (.stem.mp4) for evaluation
    workers: int = 2
    every: int = 20
    split: bool = True
    shifts: int = 1
    overlap: float = 0.25
    sdr: bool = True
    metric: str = "loss"
    length_bucket_seconds: tp.Optional[float] = None  # the device engine's length buckets


@dataclasses.dataclass
class OptimConfig:
    lr: float = 3e-4
    momentum: float = 0.9
    beta2: float = 0.999
    loss: str = "l1"
    optim: str = "adam"
    weight_decay: float = 0.0
    clip_grad: float = 0.0


@dataclasses.dataclass
class RepitchConfig:
    proba: float = 0.2
    max_tempo: float = 12


@dataclasses.dataclass
class RemixConfig:
    proba: float = 1.0
    group_size: int = 4


@dataclasses.dataclass
class ScaleConfig:
    proba: float = 1.0
    min: float = 0.25
    max: float = 1.25


@dataclasses.dataclass
class AugmentTreeConfig:
    shift_same: bool = False
    repitch: RepitchConfig = dataclasses.field(default_factory=RepitchConfig)
    remix: RemixConfig = dataclasses.field(default_factory=RemixConfig)
    scale: ScaleConfig = dataclasses.field(default_factory=ScaleConfig)
    flip: bool = True


@dataclasses.dataclass
class EmaConfig:
    batch: tp.Tuple[float, ...] = ()
    epoch: tp.Tuple[float, ...] = ()


@dataclasses.dataclass
class SvdConfig:
    penalty: float = 0.0
    min_size: float = 0.1
    dim: int = 1
    niters: int = 2
    powm: bool = False
    proba: float = 1.0
    conv_only: bool = False
    convtr: bool = False
    bs: int = 1


@dataclasses.dataclass
class QuantConfig:
    diffq: tp.Optional[float] = None
    qat: tp.Optional[int] = None
    min_size: float = 0.2
    group_size: int = 8


@dataclasses.dataclass
class MiscConfig:
    num_workers: int = 2
    num_prints: int = 4
    show: bool = False
    verbose: bool = False
    async_checkpoint: bool = False  # write checkpoints in a background thread


@dataclasses.dataclass
class TrainArgs:
    """Root config: the ``conf/config.yaml`` equivalents."""

    dset: DsetConfig = dataclasses.field(default_factory=DsetConfig)
    test: TestConfig = dataclasses.field(default_factory=TestConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    augment: AugmentTreeConfig = dataclasses.field(default_factory=AugmentTreeConfig)
    ema: EmaConfig = dataclasses.field(default_factory=EmaConfig)
    svd: SvdConfig = dataclasses.field(default_factory=SvdConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    misc: MiscConfig = dataclasses.field(default_factory=MiscConfig)

    epochs: int = 360
    batch_size: int = 64
    remat: bool = False  # recompute the encoder and decoder layers in the backward
    max_batches: tp.Optional[int] = None
    seed: int = 42
    debug: bool = False
    valid_apply: bool = True
    flag: tp.Optional[str] = None
    save_every: tp.Optional[int] = None
    weights: tp.Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    continue_from: tp.Optional[str] = None
    continue_pretrained: tp.Optional[str] = None
    pretrained_repo: tp.Optional[str] = None
    continue_best: bool = True
    continue_opt: bool = False

    model: str = "htdemucs"
    model_segment: tp.Optional[float] = None
    # per-model hyperparameters merged into the model's config, e.g. {"channels": 48}
    model_args: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)

    out_dir: str = "./outputs"


def _to_plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


def _set_dotted(args, key: str, value) -> None:
    parts = key.split(".")
    node = args
    for part in parts[:-1]:
        if not hasattr(node, part):
            raise KeyError(f"unknown config section {part!r} in override {key!r}")
        node = getattr(node, part)
    name = parts[-1]
    # a typo would train the default value under the default signature
    if dataclasses.is_dataclass(node) and name not in {f.name for f in dataclasses.fields(node)}:
        raise KeyError(f"unknown config key {key!r}")
    if isinstance(getattr(node, name, None), tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(node, name, value)


def apply_overrides(args: TrainArgs, overrides: tp.Mapping[str, tp.Any]) -> TrainArgs:
    """Apply dotted-key overrides, e.g. ``{"optim.lr": 1e-4, "epochs": 2}``."""
    for key, value in overrides.items():
        _set_dotted(args, key, value)
    return args


_BOOLS = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}
_TOKENS = re.compile(r"\s*([\[\]{},:]|'[^']*'|\"[^\"]*\"|[^\[\]{},:]+)")


def _scalar(text: str):
    """A YAML 1.1 plain or quoted scalar, as PyYAML reads one, except that an
    unquoted exponent without a mantissa dot (``1e-4``) is a float (the JAX
    package's rule)."""
    text = text.strip()
    if text[:1] in "'\"":
        return ast.literal_eval(text)
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text.lower() in _BOOLS and text in (text.lower(), text.capitalize(), text.upper()):
        return _BOOLS[text.lower()]
    if re.fullmatch(r"[-+]?(0|[1-9][0-9_]*)", text):
        return int(text.replace("_", ""))
    if re.fullmatch(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", text):
        return float(text)
    if text.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(text.replace(".", ""))
    return text


def parse_value(text: str):
    """A scalar, flow sequence ``[a, b]`` or flow mapping ``{k: v}``."""
    tokens = [t for t in _TOKENS.findall(text)]
    if not tokens or tokens[0] not in "[{":
        return _scalar(text)
    pos = 0

    def value():
        nonlocal pos
        token = tokens[pos]
        pos += 1
        if token == "[":
            items = []
            while tokens[pos] != "]":
                items.append(value())
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return items
        if token == "{":
            items = {}
            while tokens[pos] != "}":
                key = value()
                if tokens[pos] != ":":
                    raise ValueError(f"a flow mapping's key without ':' in {text!r}")
                pos += 1
                items[key] = value()
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return items
        return _scalar(token)

    out = value()
    if pos != len(tokens):
        raise ValueError(f"trailing text in {text!r}")
    return out


def parse_cli_overrides(tokens: tp.Sequence[str]) -> tp.Dict[str, tp.Any]:
    """Parse Hydra-style ``key=value`` tokens (values as :func:`parse_value`)."""
    out = {}
    for token in tokens:
        if "=" not in token:
            raise ValueError(f"Override {token!r} must be key=value")
        key, value = token.split("=", 1)
        out[key] = parse_value(value)
    return out


# The reference's dataset presets (conf/dset/*.yaml, selected with
# ``dset=NAME``), as in the JAX package: structural knobs inlined, the wav
# roots placeholders to override (``dset.wav=/path``).
DSET_PRESETS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "musdb44": {"dset.samplerate": 44100, "dset.channels": 2},
    "extra44": {"dset.wav": "<ALLSTEMS_44>", "dset.samplerate": 44100,
                "dset.channels": 2, "epochs": 320},
    "extra_test": {"dset.wav": "<ALLSTEMS_TEST_44>", "dset.samplerate": 44100,
                   "dset.channels": 2, "epochs": 320, "max_batches": 700,
                   "test.sdr": False, "test.every": 500},
    "extra_mmi_goodclean": {
        "dset.wav": "<ALLSTEMS_44>", "dset.wav2": "<MMI44_GOODCLEAN>",
        "dset.wav2_weight": None, "dset.wav2_valid": False,
        "dset.valid_samples": 100, "dset.samplerate": 44100,
        "dset.channels": 2, "epochs": 1200},
    "auto_mus": {
        "dset.wav": "<AUTOMIX_MUSDB>", "dset.samplerate": 44100,
        "dset.channels": 2, "epochs": 360, "max_batches": 300,
        "test.every": 4, "augment.shift_same": True,
        "augment.scale.proba": 0.5, "augment.remix.proba": 0,
        "augment.repitch.proba": 0},
    "auto_extra_test": {
        "dset.wav": "<AUTOMIX_EXTRA_TEST>", "dset.samplerate": 44100,
        "dset.channels": 2, "epochs": 320, "max_batches": 500,
        "augment.shift_same": True, "augment.scale.proba": 0.0,
        "augment.remix.proba": 0, "augment.repitch.proba": 0},
    "aetl": {
        "dset.wav": "<AETL>", "dset.samplerate": 44100, "dset.channels": 2,
        "epochs": 320, "max_batches": 500, "augment.shift_same": True,
        "augment.scale.proba": 0.0, "augment.remix.proba": 0,
        "augment.repitch.proba": 0},
    "sdx23_bleeding": {
        "dset.wav": "<MOISESDB23_BLEEDING>", "dset.use_musdb": False,
        "dset.samplerate": 44100, "dset.channels": 2, "epochs": 320},
    "sdx23_labelnoise": {
        "dset.wav": "<MOISESDB23_LABELNOISE>", "dset.use_musdb": False,
        "dset.samplerate": 44100, "dset.channels": 2, "epochs": 320},
}


def expand_presets(overrides: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Expand ``dset=NAME`` into its preset's overrides; explicit keys win."""
    if "dset" not in overrides:
        return dict(overrides)
    name = overrides["dset"]
    if name not in DSET_PRESETS:
        raise KeyError(f"unknown dset preset {name!r}; available: {sorted(DSET_PRESETS)}")
    out = dict(DSET_PRESETS[name])
    out.update((k, v) for k, v in overrides.items() if k != "dset")
    return out


def xp_signature(args: TrainArgs) -> str:
    """Dora-style XP signature: sha1 of the delta from the default config."""
    default = _to_plain(TrainArgs())
    current = _to_plain(args)

    def delta(d, c, prefix=""):
        out = {}
        for key, cur in c.items():
            ref = d.get(key)
            if isinstance(cur, dict) and isinstance(ref, dict):
                out.update(delta(ref, cur, prefix + key + "."))
            elif cur != ref:
                out[prefix + key] = cur
        return out

    payload = json.dumps(delta(default, current), sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:8]
