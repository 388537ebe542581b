"""PyTorch/CUDA port of the communication-aware diffusion load balancer.

Counterpart of the JAX package ``repro`` (the reference, which this package
never imports).  Entry points run on ``cuda`` by default and raise where no
card is present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
