"""Gemma-3 27B — 5:1 local:global sliding-window attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt family; unverified]

62 = 10×6 + 2: ten scanned (5 local + 1 global) groups plus two unrolled
local layers.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

_UNIT = ("attn_local",) * 5 + ("attn",)

CONFIG = ModelConfig(
    name="gemma3-27b",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21_504,
    vocab_size=262_144,
    layer_unit=_UNIT,
    suffix_layers=("attn_local", "attn_local"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

REDUCED = ModelConfig(
    name="gemma3-27b-reduced",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    layer_unit=("attn_local",) * 2 + ("attn",),
    suffix_layers=("attn_local", "attn_local"),
    sliding_window=16,
    tie_embeddings=True,
    embed_scale=True,
)

SPEC = ArchSpec(
    name="gemma3-27b",
    config=CONFIG,
    reduced=REDUCED,
    family="dense",
    long_context=True,
    source="hf:google/gemma-3-27b-pt (unverified)",
    notes="5:1 local:global SWA",
)
