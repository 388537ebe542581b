"""Sort-free counting-scatter kernel (migration manifest build)."""
from repro_torch.kernels.migrate.ops import (  # noqa: F401
    MAX_C,
    bucket_ranks,
    preferred_method,
    scatter_dest,
)
