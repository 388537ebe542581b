"""Sharded planning and replay (counterpart of ``repro.distributed``'s
mesh modules): :mod:`.mesh` (the D-shard mesh with named axes, on one
device or one rank a shard), :mod:`.autodiff` (its collectives with a
gradient), :mod:`.sharding` (the partition rules), :mod:`.lb_shard` (the
mesh-sharded planner) and :mod:`.replay_shard` (the sharded series, PIC
and serving replays) — :mod:`.ep_balance`, the paper's balancer on the
MoE expert placement, and the training helpers :mod:`.data_balance` and
:mod:`.grad_compress`."""
