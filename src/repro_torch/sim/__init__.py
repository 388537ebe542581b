"""Load-balancing simulation infrastructure (paper §V) in PyTorch."""
from repro_torch.sim.simulator import (BatchSeriesResult, CompareRow,
                                       SeriesResult, compare, format_table,
                                       run_series, run_series_batch)
from repro_torch.sim.stencil import stencil_2d, stencil_3d
from repro_torch.sim.synthetic import hotspot, mod7, random_pm

__all__ = [
    "BatchSeriesResult",
    "CompareRow",
    "SeriesResult",
    "compare",
    "format_table",
    "hotspot",
    "mod7",
    "random_pm",
    "run_series",
    "run_series_batch",
    "stencil_2d",
    "stencil_3d",
]
