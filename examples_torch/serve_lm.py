#!/usr/bin/env python3
"""Batched serving on the port: continuous batching + diffusion scheduling
(counterpart of ``examples/serve_lm.py``; ``repro_torch.launch.serve``).

Run from the repository root:
    python3 examples_torch/serve_lm.py [--arch smollm-135m] [--device cuda|cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    return serve.main(argv)


if __name__ == "__main__":
    main()
