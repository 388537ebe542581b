"""Core library: communication-aware diffusion load balancing (the paper's
contribution), its coordinate variant, and metrics — in PyTorch."""
from repro_torch.core.api import (LBPlan, STRATEGIES, diffusion_lb,
                                  run_strategy)
from repro_torch.core.comm_graph import (
    LBProblem,
    make_problem,
    node_comm_matrix,
    node_loads,
    object_node_bytes,
)
from repro_torch.core.metrics import evaluate

__all__ = [
    "LBPlan", "LBProblem", "STRATEGIES", "diffusion_lb", "evaluate",
    "make_problem", "node_comm_matrix", "node_loads", "object_node_bytes",
    "run_strategy",
]
