"""Qwen1.5-110B — large dense model with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
[hf:Qwen/Qwen1.5-110B; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    layer_unit=("attn",),
    qkv_bias=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    layer_unit=("attn",),
    qkv_bias=True,
)

SPEC = ArchSpec(
    name="qwen1.5-110b",
    config=CONFIG,
    reduced=REDUCED,
    family="dense",
    long_context=False,
    source="hf:Qwen/Qwen1.5-110B",
    notes="QKV bias; dense ⇒ data-level LB only",
)
