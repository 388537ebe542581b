"""Architecture configs (``--arch <id>``) of the ported model families."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, ArchSpec, get_arch, list_archs, reduced_config,
)

__all__ = ["ARCHS", "ArchSpec", "get_arch", "list_archs", "reduced_config"]
