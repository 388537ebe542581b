"""SmolLM-135M — llama-architecture small dense model.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    layer_unit=("attn",),
    tie_embeddings=True,
    # too small to fill a 16-wide TP axis: pure-DP layout
    sharding_profile="dp",
)

REDUCED = ModelConfig(
    name="smollm-reduced",
    num_layers=3,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    layer_unit=("attn",),
    tie_embeddings=True,
)

SPEC = ArchSpec(
    name="smollm-135m",
    config=CONFIG,
    reduced=REDUCED,
    family="dense",
    long_context=False,
    source="hf:HuggingFaceTB/SmolLM-135M",
    notes="dense; LB technique attaches at the data level only "
          "(distributed/data_balance.py)",
)
