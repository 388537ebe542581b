"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
[arXiv:2306.05284; hf:facebook/musicgen-medium]

Backbone only as in the JAX package: the EnCodec frontend is a stub —
``input_specs()`` supplies precomputed frame embeddings (B, S, d_model);
decode consumes codebook token ids.  Text-conditioning cross-attention is
out of scope (backbone spec).
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    layer_unit=("attn",),
    frontend="audio_stub",
)

REDUCED = ModelConfig(
    name="musicgen-reduced",
    num_layers=3,
    d_model=48,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=64,
    layer_unit=("attn",),
    frontend="audio_stub",
)

SPEC = ArchSpec(
    name="musicgen-medium",
    config=CONFIG,
    reduced=REDUCED,
    family="audio",
    long_context=False,
    source="arXiv:2306.05284",
    notes="EnCodec frontend stubbed: frame embeddings in, token ids out",
)
