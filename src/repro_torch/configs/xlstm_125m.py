"""xLSTM-125M — alternating mLSTM (matrix memory) and sLSTM (scalar
memory) blocks.

12L d_model=768 4H d_ff=0 vocab=50304.  [arXiv:2405.04517; unverified]

d_ff=0 ⇒ no separate FFN sub-blocks (the cells carry their own
projections).  Recurrent state is O(heads·hd²) ⇒ the 500k decode cell is
trivially bounded.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    layer_unit=("mlstm", "slstm"),
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="xlstm-reduced",
    num_layers=2,
    d_model=48,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    layer_unit=("mlstm", "slstm"),
    tie_embeddings=True,
)

SPEC = ArchSpec(
    name="xlstm-125m",
    config=CONFIG,
    reduced=REDUCED,
    family="ssm",
    long_context=True,
    source="arXiv:2405.04517 (unverified)",
    notes="sLSTM steps sequentially (recurrent gates); mLSTM chunkwise",
)
