"""Online rebalancing runtime: ``triggers`` decides when to rebalance,
``migrate`` executes the exchange, ``cost`` prices the trade-off."""
from repro_torch.runtime import cost, migrate, triggers  # noqa: F401
from repro_torch.runtime.cost import RuntimeCostModel  # noqa: F401
from repro_torch.runtime.triggers import (  # noqa: F401
    EveryTrigger, PredictiveTrigger, ThresholdTrigger, TriggerState,
)
