"""Llama-4 Scout 17B-active / 16-expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 + 1 shared expert (every layer MoE — Scout's interleave step is 1).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Early-fusion multimodality is out of scope as in the JAX package (text
backbone only).  The paper's diffusion balancer attaches via EP placement
(the JAX package's ``repro.distributed.ep_balance``): with 16 experts on a
16-wide EP axis, balancing migrates replica shares.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    layer_unit=("moe",),
    moe=MoEConfig(num_experts=16, top_k=1, d_expert=8192, num_shared=1),
    rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama4-scout-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    layer_unit=("moe",),
    moe=MoEConfig(num_experts=4, top_k=1, d_expert=128, num_shared=1,
                  impl="dense"),
)

SPEC = ArchSpec(
    name="llama4-scout-17b-a16e",
    config=CONFIG,
    reduced=REDUCED,
    family="moe",
    long_context=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
    notes="MoE 16e top-1 + shared; text backbone only (early fusion skipped)",
)
