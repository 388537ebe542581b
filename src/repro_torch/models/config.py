"""Unified model configuration (counterpart of ``repro.models.config``):
plain frozen dataclasses, the same fields and defaults."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    impl: str = "auto"           # auto | dense | a2a


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 ⇒ d_model // num_heads
    d_ff_dense: int = 0               # dense-MLP width when it differs from
                                      # d_ff (deepseek: d_ff is the expert dim)
    # block stack: repeating unit of block kinds, scanned over groups.
    # kinds: "attn" | "moe" | "attn_local" | "moe_local" | "hymba"
    #        | "mlstm" | "slstm"
    layer_unit: Tuple[str, ...] = ("attn",)
    prefix_layers: Tuple[str, ...] = ()   # unrolled before the scanned groups
    suffix_layers: Tuple[str, ...] = ()   # unrolled after
    # attention
    attention: str = "gqa"            # gqa | mla
    qkv_bias: bool = False
    sliding_window: int = 0           # window for *_local blocks
    rope_theta: float = 10000.0
    prefix_lm: bool = False           # bidirectional prefix (paligemma)
    # extras
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm_state: int = 16
    ssm_expand: int = 1
    mtp: bool = False                 # deepseek multi-token-prediction head
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"      # "bfloat16" ⇒ fp32 master in optimizer
    # sharding profile (EXPERIMENTS.md §Perf):
    #   "2d" — batch→(pod,data), heads/ffn/vocab/experts→model (default)
    #   "dp" — batch→(pod,data,model), params replicated over model; the
    #          right layout for models too small to fill a 16-wide TP axis
    sharding_profile: str = "2d"
    # expert-parallel axes for MoE ("model" = within-TP EP; ("data","model")
    # = EP-wide: one expert group per chip, no ZeRO-3 expert gathers)
    ep_axes: Tuple[str, ...] = ("model",)
    # modality frontend: "none" | "audio_stub" | "vision_stub"
    frontend: str = "none"
    vision_prefix: int = 256          # stub patch-token count (paligemma)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_groups(self) -> int:
        n = self.num_layers - len(self.prefix_layers) - len(self.suffix_layers)
        assert n % len(self.layer_unit) == 0, (
            f"{self.name}: {n} scanned layers not divisible by unit "
            f"{len(self.layer_unit)}"
        )
        return n // len(self.layer_unit)

    def all_layers(self) -> Tuple[str, ...]:
        return (self.prefix_layers
                + self.layer_unit * self.num_groups
                + self.suffix_layers)

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        _ = self.num_groups
        if any(k.startswith("moe") for k in self.all_layers()):
            assert self.moe is not None
        if self.attention == "mla":
            assert self.mla is not None
