"""GQA flash attention (K6): the hand-written kernel behind every attention
layer of the served model, and its plain version."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
)
