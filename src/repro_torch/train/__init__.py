"""Training (counterpart of ``repro.train``): AdamW (:mod:`.optimizer`),
the train step (:mod:`.train_step`), checkpoints (:mod:`.checkpoint`),
the data pipeline (:mod:`.data`), the supervised restart loop,
heartbeats and the straggler balancer (:mod:`.fault_tolerance`), and live
MoE expert rebalancing (:mod:`.ep_runtime`: the EP replay, the
real-weight relocation and the train-loop rebalancer)."""
from repro_torch.train.ep_runtime import (
    EPRebalancer,
    EPReplayResult,
    RoutingTrace,
    RoutingWorkload,
    apply_order_to_moe,
    execute_placement,
    expert_param_bytes,
    record_routing,
    run_ep_replay,
)

__all__ = [
    "EPRebalancer", "EPReplayResult", "RoutingTrace", "RoutingWorkload",
    "apply_order_to_moe", "execute_placement", "expert_param_bytes",
    "record_routing", "run_ep_replay",
]
