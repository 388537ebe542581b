"""Plain PyTorch oracle for the fused diffusion S-sweep kernel.

It is the balancer's own chunk (``core/virtual_lb.py``), re-exported so the
kernel tests and ``chip_smoke.py`` have one canonical oracle path.
"""
from repro_torch.core.virtual_lb import reference_nsweeps

diffusion_nsweeps_ref = reference_nsweeps

__all__ = ["diffusion_nsweeps_ref"]
