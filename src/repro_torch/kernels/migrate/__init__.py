"""Sort-free counting-scatter kernel (migration manifest build)."""
from repro_torch.kernels.migrate.ops import (  # noqa: F401
    bucket_ranks,
    preferred_method,
    scatter_dest,
)
