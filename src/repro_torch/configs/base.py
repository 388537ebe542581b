"""Architecture registry (counterpart of ``repro.configs.base``).

Every ported architecture registers an ``ArchSpec`` with its published
config and a reduced same-family config for tests.  Ported so far: the
dense GQA models ``gemma3-1b`` and ``smollm-135m``; the other eight need
MoE, MLA, SSM blocks or modality frontends and come with later slices
(``get_arch`` raises ``KeyError`` for them, as for any unknown name).
The dry run's shape registry (``SHAPES``, ``input_specs``,
``materialize_batch``) belongs to a later slice too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    config: ModelConfig
    reduced: ModelConfig
    family: str                          # dense | moe | hybrid | ssm | ...
    long_context: bool                   # sub-quadratic ⇒ long_500k applies
    source: str
    notes: str = ""


_MODULES = ["smollm_135m", "gemma3_1b"]

ARCHS: Dict[str, ArchSpec] = {}


def _load() -> None:
    if ARCHS:
        return
    for m in _MODULES:
        spec: ArchSpec = importlib.import_module(
            f"repro_torch.configs.{m}").SPEC
        ARCHS[spec.name] = spec


def list_archs() -> List[str]:
    _load()
    return sorted(ARCHS)


def get_arch(name: str) -> ArchSpec:
    _load()
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported architecture {name!r}; "
                       f"ported: {sorted(ARCHS)}") from None


def reduced_config(name: str) -> ModelConfig:
    return get_arch(name).reduced
