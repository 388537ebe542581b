"""Fused diffusion S-sweep kernel (stage 2 of the balancer)."""
from repro_torch.kernels.diffusion.ops import diffusion_nsweeps  # noqa: F401
