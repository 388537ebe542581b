"""Gemma-3 1B — 5:1 local:global sliding-window attention, 128k context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]

Layer pattern: repeating (5 × local SWA, 1 × global); 26 = 4×6 + 2, the
two remainder layers are local blocks (suffix).  Window layers keep
O(window) ring-buffer caches; the global layers' caches hold every
position.  The same config as the JAX package's.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

_UNIT = ("attn_local",) * 5 + ("attn",)

CONFIG = ModelConfig(
    name="gemma3-1b",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    layer_unit=_UNIT,
    suffix_layers=("attn_local", "attn_local"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    # too small to fill a 16-wide TP axis: pure-DP layout
    sharding_profile="dp",
)

REDUCED = ModelConfig(
    name="gemma3-1b-reduced",
    num_layers=8,
    d_model=48,
    num_heads=2,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=512,
    layer_unit=("attn_local",) * 2 + ("attn",),
    suffix_layers=("attn_local", "attn_local"),
    sliding_window=16,
    tie_embeddings=True,
    embed_scale=True,
)

SPEC = ArchSpec(
    name="gemma3-1b",
    config=CONFIG,
    reduced=REDUCED,
    family="dense",
    long_context=True,
    source="hf:google/gemma-3-1b-pt (unverified)",
    notes="5:1 local:global SWA; window caches bound 5/6 of KV state",
)
