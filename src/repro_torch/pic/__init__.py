"""PIC PRK benchmark (paper §VI) in PyTorch."""
from repro_torch.pic.chares import build_problem, initial_mapping
from repro_torch.pic.driver import CostModel, PICConfig, PICResult, run
from repro_torch.pic.grid import alternating_grid
from repro_torch.pic.particles import Particles, initialize

__all__ = [
    "CostModel", "PICConfig", "PICResult", "Particles",
    "alternating_grid", "build_problem", "initial_mapping",
    "initialize", "run",
]
