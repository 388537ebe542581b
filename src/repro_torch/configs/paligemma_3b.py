"""PaliGemma-3B — SigLIP vision encoder + Gemma decoder (VLM).

Backbone: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
[arXiv:2407.07726; hf:google/paligemma-3b-pt-224]

The SigLIP frontend is a stub as in the JAX package: ``input_specs()``
supplies 256 precomputed patch embeddings that are prepended to the text
tokens; attention is prefix-LM (bidirectional over the image prefix,
causal over text).
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16_384,
    vocab_size=257_216,
    layer_unit=("attn",),
    prefix_lm=True,
    vision_prefix=256,
    frontend="vision_stub",
    tie_embeddings=True,
    embed_scale=True,
)

REDUCED = ModelConfig(
    name="paligemma-reduced",
    num_layers=2,
    d_model=48,
    num_heads=2,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=512,
    layer_unit=("attn",),
    prefix_lm=True,
    vision_prefix=8,
    frontend="vision_stub",
    tie_embeddings=True,
    embed_scale=True,
)

SPEC = ArchSpec(
    name="paligemma-3b",
    config=CONFIG,
    reduced=REDUCED,
    family="vlm",
    long_context=False,
    source="arXiv:2407.07726",
    notes="SigLIP frontend stubbed: patch embeddings in; prefix-LM mask",
)
