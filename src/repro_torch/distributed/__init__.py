"""Sharded planning and replay (counterpart of ``repro.distributed``'s
mesh modules): :mod:`.mesh` (the D-shard mesh on one device),
:mod:`.lb_shard` (the mesh-sharded planner) and :mod:`.replay_shard` (the
sharded series, PIC and serving replays) — :mod:`.ep_balance`, the
paper's balancer on the MoE expert placement, and the training helpers
:mod:`.data_balance` and :mod:`.grad_compress`."""
