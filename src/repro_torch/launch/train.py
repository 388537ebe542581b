"""Training launcher (counterpart of ``repro.launch.train``): the data
pipeline, the train step, periodic checkpoints and live MoE expert
rebalancing, on one card.

    python -m repro_torch.launch.train --arch smollm-135m --steps 100
    python -m repro_torch.launch.train --full --arch smollm-135m \
        --seq-len 2048 --batch 8 --steps 20 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --device cpu     # plain versions

:func:`train` resumes from the latest checkpoint under ``ckpt_dir``,
saves every ``save_every`` steps and at the end, logs through the
``obs.metrics`` registry, and with ``profile_dir`` writes a
``torch.profiler`` trace of the loop there.  For a MoE config with
``ep_balance_every`` the train step collects the router's statistics and
an ``EPRebalancer`` relocates every MoE layer's experts in place when its
trigger fires (the optimizer moments stay with their slots, as in the JAX
launcher).  The card is the default device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import resolve_device
from repro_torch.launch.serve import profiled
from repro_torch.models import transformer
from repro_torch.models.params import init_params
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import ep_runtime
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod


@dataclasses.dataclass
class RunConfig:
    arch: str = "smollm-135m"
    reduced: bool = True            # False: the published config
    steps: int = 50
    seq_len: int = 128
    global_batch: int = 8
    lr: float = 3e-4
    warmup: int = 10
    save_every: int = 20
    ckpt_dir: Optional[str] = None
    resume: bool = True
    remat: str = "none"
    ep_balance_every: int = 0       # MoE expert rebalance cadence (0 = off)
    ep_strategy: str = "diff-comm"  # any registered strategy (+ "greedy")
    ep_trigger: Optional[str] = None  # None: strategy default / cadence
    ep_num_ranks: int = 0           # EP ranks (0 = min(4, E))
    seed: int = 0
    log_every: int = 10
    profile_dir: Optional[str] = None  # torch.profiler trace of the loop
    device: str = "cuda"


def build(cfg: RunConfig):
    """``(model config, params, opt state, step fn, data pipeline)`` on
    ``cfg.device``."""
    dev = resolve_device(cfg.device)
    spec = get_arch(cfg.arch)
    mcfg = spec.reduced if cfg.reduced else spec.config
    params = init_params(transformer.model_specs(mcfg), cfg.seed, dev)
    ocfg = opt_mod.OptConfig(lr=cfg.lr, warmup_steps=cfg.warmup,
                             total_steps=cfg.steps)
    opt_state = opt_mod.init(params, device=dev)
    collect = bool(cfg.ep_balance_every) and mcfg.moe is not None
    step_fn = ts_mod.make_train_step(mcfg, ocfg, remat=cfg.remat,
                                     collect_router_stats=collect)
    dcfg = data_mod.DataConfig(vocab_size=mcfg.vocab_size,
                               seq_len=cfg.seq_len,
                               global_batch=cfg.global_batch, seed=cfg.seed)
    pipe = data_mod.DataPipeline(dcfg, num_ranks=1, device=dev)
    return mcfg, params, opt_state, step_fn, pipe


def train(cfg: RunConfig) -> Dict:
    """Run ``cfg.steps`` steps (from the latest checkpoint if resuming);
    returns losses, grad norms, each step's seconds (the step and the wait
    for its loss), the total seconds, the final params and opt state, and
    the expert rebalancer's history."""
    dev = resolve_device(cfg.device)
    mcfg, params, opt_state, step_fn, pipe = build(cfg)
    start = 0
    if (cfg.ckpt_dir and cfg.resume
            and ckpt.latest_step(cfg.ckpt_dir) is not None):
        params, opt_state, start, ds = ckpt.restore(
            cfg.ckpt_dir, params, opt_state, device=dev)
        if ds:
            pipe.state = data_mod.PipelineState.from_dict(ds)
        print(f"resumed from step {start}")

    rebalancer = None
    if cfg.ep_balance_every and mcfg.moe is not None:
        E = mcfg.moe.num_experts
        R = cfg.ep_num_ranks or min(4, E)
        rebalancer = ep_runtime.EPRebalancer(
            E, R, strategy=cfg.ep_strategy, trigger=cfg.ep_trigger,
            lb_every=cfg.ep_balance_every, device=dev)

    hist, gnorms, step_s = [], [], []
    t0 = time.time()
    with profiled(cfg.profile_dir):
        for step in range(start, cfg.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipe.next_batch().items()}
            ts = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])           # waits for the step
            step_s.append(time.perf_counter() - ts)
            hist.append(loss)
            gnorms.append(float(m["grad_norm"]))
            # registry first, log lines from the snapshot: one source
            obs_metrics.counter("train/steps").inc()
            obs_metrics.gauge("train/loss").set(loss)
            obs_metrics.gauge("train/grad_norm").set(gnorms[-1])
            obs_metrics.gauge("train/lr").set(float(m["lr"]))
            obs_metrics.gauge("train/seconds").set(time.time() - t0)
            if cfg.log_every and step % cfg.log_every == 0:
                s = obs_metrics.snapshot()
                print(f"step {step:5d} loss {s['train/loss']:.4f} "
                      f"gnorm {s['train/grad_norm']:.3f} "
                      f"lr {s['train/lr']:.2e} "
                      f"({s['train/seconds']:.1f}s)", flush=True)
            if (cfg.ckpt_dir and cfg.save_every
                    and (step + 1) % cfg.save_every == 0):
                ckpt.save(cfg.ckpt_dir, step + 1, params, opt_state,
                          data_state=pipe.state.to_dict())
                obs_metrics.counter("train/checkpoints").inc()
            if rebalancer is not None:
                params, info = _rebalance_experts(params, rebalancer, m,
                                                  step)
                if info.get("fired"):
                    _log_fire(info, cfg.log_every)
    if cfg.ckpt_dir and ckpt.latest_step(cfg.ckpt_dir) != cfg.steps:
        ckpt.save(cfg.ckpt_dir, cfg.steps, params, opt_state,
                  data_state=pipe.state.to_dict())
    return dict(losses=hist, grad_norms=gnorms, step_seconds=step_s,
                final_loss=hist[-1] if hist else float("nan"),
                seconds=time.time() - t0, params=params,
                opt_state=opt_state, config=mcfg,
                ep_history=None if rebalancer is None
                else rebalancer.history)


def _log_fire(info: Dict, log_every: int) -> None:
    obs_metrics.counter("train/ep_fires").inc()
    obs_metrics.counter("train/ep_moved_experts").inc(
        int(info["moved_experts"]))
    obs_metrics.counter("train/ep_moved_bytes").inc(
        float(info["moved_bytes"]))
    obs_metrics.gauge("train/ep_last_moved").set(int(info["moved_experts"]))
    obs_metrics.gauge("train/ep_last_bytes").set(float(info["moved_bytes"]))
    obs_metrics.gauge("train/ep_max_avg").set(float(info["max_avg"]))
    if log_every:
        s = obs_metrics.snapshot()
        print(f"  [ep-balance] moved {int(s['train/ep_last_moved'])} "
              f"experts ({s['train/ep_last_bytes']:.0f} B), max/avg "
              f"{s['train/ep_max_avg']:.3f}", flush=True)


def _moe_blocks(params) -> list:
    """Indices in ``params["layers"]`` of every layer holding a MoE FFN."""
    return [i for i, blk in enumerate(params["layers"])
            if isinstance(blk, dict) and "moe" in blk]


def _rebalance_experts(params, rebalancer: "ep_runtime.EPRebalancer",
                       metrics: Dict, step: int):
    """One live-rebalancing tick on the real parameters: the train step's
    router statistics go to the rebalancer, which decides, plans and, on a
    fire, relocates every MoE layer's expert tensors in place."""
    where = _moe_blocks(params)
    layers, info = rebalancer.step(
        step, metrics["router_counts"], metrics["router_coact"],
        [params["layers"][i]["moe"] for i in where], in_place=True)
    for i, moe in zip(where, layers):
        params["layers"][i]["moe"] = moe
    return params, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the loop to DIR")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = RunConfig(arch=args.arch, reduced=not args.full, steps=args.steps,
                    seq_len=args.seq_len, global_batch=args.batch,
                    lr=args.lr, ckpt_dir=args.ckpt_dir, remat=args.remat,
                    profile_dir=args.profile_dir, device=args.device)
    out = train(cfg)
    print(f"done: final loss {out['final_loss']:.4f} in "
          f"{out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
