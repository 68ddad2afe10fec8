"""Models by name (port of ``demucs_tpu/zoo/pretrained.py``; behavioral
reference ``demucs/pretrained.py``).

``get_model(name, repo, device)``: ``demucs_unittest`` (a tiny HDemucs made
in process); else ``name`` is a bag name or a model signature, looked up in
the local folder ``repo`` (``.th``, ``.dmx`` and bag ``.yaml`` files), or,
without one, in the released registry through the download cache
(``zoo/repo.py``). The model, or every bag member, goes to ``device``.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

from demucs_tpu_torch.models.registry import BagOfModels, Model
from demucs_tpu_torch.zoo.repo import (AnyModelRepo, BagOnlyRepo, LocalRepo, ModelLoadingError,
                                       RemoteRepo)

__all__ = ["SOURCES", "DEFAULT_MODEL", "demucs_unittest", "add_model_flags", "make_repo",
           "get_model", "list_models", "ModelLoadingError"]

SOURCES = ("drums", "bass", "other", "vocals")
DEFAULT_MODEL = "htdemucs"


def demucs_unittest() -> Model:
    """A tiny HDemucs (channels 4) with the seed-0 weights, equal to the JAX
    package's ``demucs_unittest`` (``demucs/pretrained.py:27-29``)."""
    from demucs_tpu_torch.models.hdemucs import HDemucsConfig, init_hdemucs

    cfg = HDemucsConfig(sources=SOURCES, channels=4)
    return Model("hdemucs", cfg, init_hdemucs(cfg, seed=0).eval())


def add_model_flags(parser) -> None:
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("-s", "--sig", help="Locally trained XP signature.")
    group.add_argument("-n", "--name", default=DEFAULT_MODEL,
                       help="Pretrained model name or signature. Default is htdemucs.")
    parser.add_argument("--repo", type=Path,
                        help="Folder containing all pre-trained models for use with -n.")


def make_repo(repo: tp.Optional[Path] = None) -> AnyModelRepo:
    if repo is None:
        model_repo: tp.Any = RemoteRepo()
        bag_repo = BagOnlyRepo(None, model_repo)
    else:
        repo = Path(repo)
        if not repo.is_dir():
            raise ModelLoadingError(f"{repo} must exist and be a directory.")
        model_repo = LocalRepo(repo)
        bag_repo = BagOnlyRepo(repo, model_repo)
    return AnyModelRepo(model_repo, bag_repo)


def get_model(name: str, repo: tp.Optional[Path] = None,
              device="cuda") -> tp.Union[Model, BagOfModels]:
    """The model or bag ``name`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    from demucs_tpu_torch import resolve_device

    dev = resolve_device(device)  # raises before any loading
    if name == "demucs_unittest":
        return demucs_unittest().to(dev)
    return make_repo(repo).get_model(name).to(dev)


def list_models(repo: tp.Optional[Path] = None) -> tp.Dict[str, tp.Dict[str, tp.Any]]:
    """``{"single": ..., "bag": ...}``, the models and bags ``repo`` offers."""
    any_repo = make_repo(repo)
    return {"single": any_repo.model_repo.list_model(), "bag": any_repo.bag_repo.list_model()}
