#!/usr/bin/env python3
"""End-to-end LM training on the port: a ~100M model for a few hundred
steps with checkpointing (counterpart of ``examples/train_lm.py``;
``repro_torch.launch.train``).

Run from the repository root:
    python3 examples_torch/train_lm.py            # ~100M, 200 steps
    python3 examples_torch/train_lm.py --smoke    # tiny, 20 steps

The default run instantiates smollm-135m's reduced config (``--full-width``:
its published width and depth) at a reduced sequence length and batch.
``--arch`` picks any other architecture's config; ``--device`` the card
(the default) or the CPU.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import RunConfig, train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--full-width", action="store_true",
                    help="use the arch's FULL config (needs memory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    steps = args.steps or (20 if args.smoke else 200)
    with tempfile.TemporaryDirectory() as d:
        cfg = RunConfig(
            arch=args.arch,
            reduced=not args.full_width,
            steps=steps,
            seq_len=64 if args.smoke else 256,
            global_batch=4 if args.smoke else 8,
            lr=1e-3,
            warmup=steps // 10,
            save_every=max(steps // 4, 1),
            ckpt_dir=d,
            log_every=max(steps // 20, 1),
            device=args.device,
        )
        out = train(cfg)
        print(f"\nfinal loss {out['final_loss']:.4f} "
              f"(start {out['losses'][0]:.4f}) in {out['seconds']:.1f}s — "
              f"loss must decrease on the synthetic stream")
    return out


if __name__ == "__main__":
    main()
