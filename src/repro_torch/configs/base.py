"""Architecture registry and per-shape input specs (counterpart of
``repro.configs.base``).

Every architecture registers an ``ArchSpec`` with its published config
and a reduced same-family config for tests, the same as the JAX
package's.  ``input_specs`` gives the inputs of one (arch, shape) cell as
tensors on the ``meta`` device (shapes and types, nothing allocated; the
JAX package's ``ShapeDtypeStruct`` stand-ins), decode caches included;
``materialize_batch`` fills the same structure with small random values.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    config: ModelConfig
    reduced: ModelConfig
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    long_context: bool           # sub-quadratic ⇒ long_500k applies
    source: str
    notes: str = ""


_MODULES = [
    "llama4_scout_17b_a16e",
    "deepseek_v3_671b",
    "smollm_135m",
    "qwen1_5_110b",
    "gemma3_1b",
    "gemma3_27b",
    "hymba_1_5b",
    "musicgen_medium",
    "xlstm_125m",
    "paligemma_3b",
]

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
        raise KeyError(f"unknown architecture {name!r}; "
                       f"known: {sorted(ARCHS)}") from None


def reduced_config(name: str) -> ModelConfig:
    return get_arch(name).reduced


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(applicable?, reason if not): the 500k decode cell needs
    sub-quadratic state."""
    a = get_arch(arch)
    s = SHAPES[shape]
    if s.name == "long_500k" and not a.long_context:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic state")
    return True, ""


# ------------------------------------------------------------ input specs --


def input_specs(cfg: ModelConfig, shape: Shape,
                compute_dtype=torch.bfloat16) -> Dict:
    """``meta`` tensors for one (arch, shape) cell:

    train:   {batch: {tokens/embeds, positions, labels}}
    prefill: {batch: {tokens/embeds, positions}}
    decode:  {tokens, index, cache}  (the per-layer cache list)
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        batch: Dict = dict(positions=tok((B, S)))
        if cfg.frontend == "audio_stub":
            batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                          dtype=compute_dtype, device="meta")
            batch["tokens"] = None
        elif cfg.frontend == "vision_stub":
            p = cfg.vision_prefix
            batch["embeds"] = torch.empty((B, p, cfg.d_model),
                                          dtype=compute_dtype, device="meta")
            batch["tokens"] = tok((B, S - p))
        else:
            batch["tokens"] = tok((B, S))
        if shape.kind == "train":
            batch["labels"] = tok((B, S))
        return dict(batch=batch)

    # decode: one new token against a seq_len-deep cache
    from repro_torch.models import transformer

    return dict(tokens=tok((B, 1)), index=tok(()),
                cache=transformer.init_cache(cfg, B, S, compute_dtype,
                                             "meta"))


def materialize_batch(cfg: ModelConfig, shape: Shape, seed: int = 0,
                      compute_dtype=torch.bfloat16, device="cuda") -> Dict:
    """Small-scale concrete inputs with ``input_specs``' structure on
    ``device``: ids uniform below min(vocab, 1000), floats normal (one
    ``torch.Generator`` seeded with ``seed``), positions 0..S-1 and the
    decode index S-1."""
    from repro_torch.kernels import resolve_device
    from repro_torch.models.params import tree_map

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    hi = max(2, min(cfg.vocab_size, 1000))

    def fill(t):
        if t.dtype == torch.int32:
            return torch.randint(0, hi, t.shape, generator=gen,
                                 dtype=torch.int32, device=dev)
        return torch.randn(t.shape, generator=gen, dtype=torch.float32,
                           device=dev).to(t.dtype)

    mat = tree_map(fill, input_specs(cfg, shape, compute_dtype))
    B, S = shape.global_batch, shape.seq_len
    if "batch" in mat:
        mat["batch"]["positions"] = torch.arange(
            S, dtype=torch.int32, device=dev)[None].expand(B, S).contiguous()
    if "index" in mat:
        mat["index"] = torch.tensor(S - 1, dtype=torch.int32, device=dev)
    return mat
