"""DeepSeek-V3 671B (37B active).

61L d_model=7168 128H MLA d_ff(expert)=2048 vocab=129280, MoE 1 shared +
256 routed top-8, MTP head.  First 3 layers use a dense 18432-wide MLP
(arXiv:2412.19437 Table 1); the rest are MoE.  [arXiv:2412.19437; hf]

This is the primary EP-balance target for the paper's technique: 256
experts over a 16-wide EP axis = 16 experts/rank, with persistent top-8
co-activation statistics forming the object communication graph.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    d_ff_dense=18432,
    vocab_size=129_280,
    prefix_layers=("attn", "attn", "attn"),
    layer_unit=("moe",),
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    mtp=True,
)

REDUCED = ModelConfig(
    name="deepseek-v3-reduced",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    d_ff_dense=160,
    vocab_size=512,
    prefix_layers=("attn",),
    layer_unit=("moe",),
    attention="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, num_shared=1,
                  impl="dense"),
    mtp=True,
)

SPEC = ArchSpec(
    name="deepseek-v3-671b",
    config=CONFIG,
    reduced=REDUCED,
    family="moe",
    long_context=False,
    source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
    notes="MLA (absorbed form), 1 shared + 256 routed top-8, MTP",
)
