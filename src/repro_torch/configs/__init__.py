"""Architecture configs (``--arch <id>``): the ten model families of the
JAX package, and the shape registry of its input specs."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, SHAPES, ArchSpec, Shape, get_arch, input_specs, list_archs,
    materialize_batch, reduced_config, shape_applicable,
)

__all__ = ["ARCHS", "SHAPES", "ArchSpec", "Shape", "get_arch", "input_specs",
           "list_archs", "materialize_batch", "reduced_config",
           "shape_applicable"]
