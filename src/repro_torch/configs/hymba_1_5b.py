"""Hymba-1.5B — hybrid parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]

Every block runs attention and a selective-SSM (mamba) head bank in
parallel on the same normed input, combined with learned per-block scalars
(the paper's mean-combination with β gates).  Most blocks use sliding-
window attention; the first and last are global (the paper keeps 3 global
layers incl. the middle one — the middle global layer is folded into the
scanned window pattern, as in the JAX package's config).  Sub-quadratic state
⇒ runs the 500k decode cell.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    prefix_layers=("hymba_g",),
    layer_unit=("hymba",),
    suffix_layers=("hymba_g",),
    sliding_window=1024,
    ssm_state=16,
)

REDUCED = ModelConfig(
    name="hymba-reduced",
    num_layers=4,
    d_model=50,
    num_heads=5,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=512,
    prefix_layers=("hymba_g",),
    layer_unit=("hymba",),
    suffix_layers=("hymba_g",),
    sliding_window=16,
    ssm_state=4,
)

SPEC = ArchSpec(
    name="hymba-1.5b",
    config=CONFIG,
    reduced=REDUCED,
    family="hybrid",
    long_context=True,
    source="arXiv:2411.13676",
    notes="parallel attn+mamba heads; SWA + SSM state bounds 500k decode",
)
