"""Benchmarks and paper scripts of the PyTorch/CUDA port."""
