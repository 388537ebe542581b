"""Diffusion kernels (stage 2 of the balancer): the fused S-sweep chunk and
the streaming two-pass sweep, and the rule that picks one."""
from repro_torch.kernels.diffusion.ops import (  # noqa: F401
    diffusion_nsweeps, diffusion_sweep, sweep_impl,
)
