#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the seven CUDA kernels from ``src/repro_torch/csrc``, then:

  1. drives the PIC path — the PIC PRK driver with the diff-comm balancer
     (``repro_torch.pic.driver.run``) at the paper's setup (L = 1000, 12×12
     chares, GEOMETRIC ρ = 0.9, 8 PEs), 2^24 particles, 100 steps, LB every
     10 — with every launch count set to 0 just before and read just after,
     and checks its invariants against a ``strategy="none"`` run of the
     same configuration;
  2. checks a small PIC run on the card against the same run on the CPU
     (plain PyTorch versions), under diff-comm and under greedy-refine;
     then drives the same full-size PIC configuration under
     ``greedy-refine`` (a host planner: NumPy on the host at each fired
     step, the exchange on the card), the launch counts set to 0 just
     before and read just after (K5 and K4 every step, K3 at each
     exchange), its mean max/avg held below the ``none`` run's;
  3. drives the simulator path — ``repro_torch.sim.simulator.run_series``
     on the ``stencil-wave`` scenario at grid 1024 × 1024 (2^20 objects,
     5-point edges) over 8192 nodes tiled 64 × 128, diff-comm k = 8, 30
     steps, LB every 10 — with the launch counts set to 0 just before and
     read just after, and checks it against a ``strategy="none"`` replay;
     stage 2 takes K1's grid form there;
  4. plans the first fired step's snapshot through
     ``LBEngine(step_fn=ops.diffusion_sweep)`` (K2's path, with the launch
     counts set to 0 just before and read just after) and the default
     engine, and stage 2 through the selected chunk (K1) against the
     streaming one (K2 in a replayed CUDA graph); holds K4's ordered form
     (the card's f32 segment sums) at the PIC path's PE loads and the
     snapshot's node loads and node-pair bytes against the CPU, bit for
     bit;
  5. runs the port's Table I and Fig 2 scripts on the card, and a small
     replay on the card against the same replay on the CPU; a small
     ``greedy-refine`` replay and a small batched replay of every
     registered scenario against the CPU's (fire steps and final
     assignments equal); then Table II, Fig 4 and Fig 5 at their
     published sizes with their assertions, each with the launch counts
     set to 0 just before and read just after;
  6. drives the serving path — what ``repro_torch.launch.serve`` does, at
     gemma3-1b's full width (26 layers, d_model 1152, vocab 262144,
     window 1024, random weights from seed 0): a ``DiffusionScheduler``
     places 8 requests (prompts of 512 to 1000 tokens) on 2 replicas and
     rebalances, and two ``ServeEngine``s (4 slots, max_len 1056, bf16
     cache) drain them with 32 new tokens each, so the two longest decode
     past position 1024 and wrap the window layers' rings — with the
     launch counts set to 0 just before and read just after; the flash
     attention kernel must have run once per attention call;
  7. serves the reduced gemma3-1b (f32) on the card and on the CPU: equal
     tokens, logits within 1e-3;
  8. drives the serving spill — a ``DiffusionScheduler`` of 63 replicas
     rebalancing 4116 sessions under a slot budget that defers moves
     (``spill_owner`` over 64^2 pair buckets), with the launch counts set
     to 0 just before and read just after — and holds its sessions,
     deferred sessions and moved KV bytes equal to the same scheduler on
     the CPU given the card's plan; then ``spill_owner`` at 64 nodes over
     2^18 items against the CPU, and at 64 and 257 nodes (4096 and 66049
     pair buckets) over 2^20 items against an argsort oracle;
  9. drives the serving fleet replay — ``repro_torch.serve.replay.
     run_serve_replay`` on ``ServeWorkload(num_sessions=131072,
     num_replicas=64, seed=1)``, 30 ticks, LB every 10, diff-comm under the
     fixed cadence — with the launch counts set to 0 just before and read
     just after (K1 at each plan, K3 at each exchange, K4 every tick),
     checks that sessions and each session's KV bytes are conserved, times
     it and reads its device idle share under the profiler; runs it again
     with ``telemetry="full"`` under a slot budget, holds the records
     against the result and its Chrome trace to the port's checker; holds
     the serve bench's two gates (p95 max/avg, moved KV) on both its
     workloads; holds a 4096-session fleet under diff-comm+predictive and
     a slot budget on the card equal to the CPU's (fire steps, placements,
     moved sessions, deferred counts, moved KV);
 10. two-level placement: the LPT threads (T = 16) of the simulator path's
     snapshot on the card equal the host oracle's, with their thread
     loads; a 20-step replay of that configuration records thread
     max/avg; a small PIC run's thread max/avg is equal on the card and
     the CPU;
 11. holds each kernel against its plain PyTorch version on the card at the
     shapes its path gives it, timing kernel, plain version and the
     one-call PyTorch yardstick where there is one: K3 in both orders the
     PIC path gives it (initial, and bucketed by PE) in every form that
     takes C = 8, with padding, twice bit for bit, dest the inverse of a
     stable argsort, with device and host time; K4 in both orders,
     with f32 weights twice bit for bit; K1 in every form that takes each
     of P = 8, K = 4 (PIC), P = 8192, K = 8 (simulator) and P = 32768,
     K = 8, each form twice bit for bit, the selected one timed with its
     device time; K6 in the form its selection
     rule names for each case (split decode, tensor-core bf16 prefill,
     SIMT f32 prefill), and its decode also cold: 26 caches, one a layer,
     rotated from call to call as on the serving path; and at MLA's
     full-width latent shapes (G = 128, hd = 576, values [ckv | 0]) in
     decode and prefill, with device time, bound and SDPA's time; K6's
     backward against the autograd of its plain version at phase 15
     (a)'s attention call (B 8, S 2048, bf16, causal; its forward output
     against the plain attention too, and the forward's times), at B 2,
     a window, a prefix-LM and the reduced MLA latents, in the form its
     rule names (tensor-core mma for every bf16 case), twice bit for
     bit, with its time, bound, the plain version's, SDPA's backward and
     the SIMT form's (held to the mma form's gradients) at the main case.
     Device times are CUDA events around calls queued behind a sleep
     kernel, not the profiler's (which records only part of the runs
     this late in the process).

 12. the sharded paths, each on one card with the D shards as the leading
     axis of its tensors (``distributed.mesh.ShardMesh``): the PIC
     configuration of 1. with ``sharded_replay=True`` over 8 shards (K5 on
     every slab, K4 on the per-shard chare histograms, K3 at every ring
     hop; launch counts set to 0 just before and read just after), at the
     slabs' default capacity and at its run's tight one, each equal to the
     single-device run in the eight PIC fields, steps/s and the idle share
     printed; the simulator path over 8 shards (fire steps, max/avg there
     and the final assignment's SHA-256 equal to 3.'s); a fault schedule
     (die, slow, recover) on a reduced series and a reduced PIC run, card
     against CPU, the evacuation complete, the checkpointed replay with
     injected failures equal to the uninterrupted one; ``migrate_sharded``
     over 2^24 items, 8 shards, 8192 nodes (strict == ``apply_manifest``,
     spill == the CPU's); the fleet over 8 shards equal to 9.'s; Fig 5
     with the sharded planner as well; and K3, K4 and K5 against their
     plain versions at the sharded PIC path's shapes.

 13. the other model families on the serving path, at their published
     widths with random weights (seed 0), each with the launch counts set
     to 0 just before and read just after: deepseek-v3-671b (MLA with
     G = 128 query heads on hd = 576 latents, 256 experts top-8, depth cut
     to 2 layers: the dense MLA layer and one MoE layer, bf16 weights) and
     llama4-scout-17b-a16e (2 layers, bf16 weights) served by one
     ``ServeEngine`` each, 4 requests of 256 to 512 prompt tokens and 16
     new tokens, deepseek's routing counts summing to tokens x 8;
     hymba-1.5b and xlstm-125m whole, served the same way (hymba's prompts
     up to 1000 tokens with 32 new ones, so its window rings wrap in
     decode); qwen1.5-110b (2 layers), gemma3-27b (8 layers: one 5+1 group
     and its two suffix layers), paligemma-3b (whole, 256 vision-prefix
     embeddings under the prefix-LM rule) and musicgen-medium (whole, audio
     frame embeddings) through ``prefill`` and 8 ``decode_step``s; K6 once
     per attention call in the form ``flash_form`` names; then every other
     reduced config (f32) served on the card and on the CPU: equal tokens,
     logits within 1e-3.  K6 is held against its plain version at MLA's
     full-width decode and prefill shapes in 11.

 14. expert balancing (``repro_torch.train.ep_runtime``): (a) the EP
     replay at deepseek-v3's routing shape — 256 experts top-8 on 32 EP
     ranks, 4096 tokens a step, 48 steps, LB every 8, diff-comm under the
     fixed cadence — with the launch counts set to 0 just before and read
     just after (K1 at each plan, K3 at each exchange, K4 every step):
     the device-resident loop equal to the host loop on the card and to
     the CPU's run, every fire capacity-exact; steps/s and its idle share
     under the profiler; (b) inside 13., while deepseek-v3's weights are
     resident, an ``EPRebalancer`` fed the router's statistics of one
     prompt relocates the 256 experts over 32 EP ranks in place
     (``wi``/``wg``/``wo``, 22.5 GB in bf16, and the router's columns):
     slot_expert a permutation, 8 experts a rank, moved bytes = moved
     experts × bytes a slot, the prompt's logits within 1e-3 of before
     with the same greedy token, the router's physical counts the old
     ones permuted; the exchange's time against 2 × moved bytes / 3.35
     TB/s; (c) the replay of (a) over 8 shards equal to one device; (d)
     the gates of ``benchmarks_torch/moe_bench.py`` and
     ``ep_balance_bench.py``.


 15. training (``repro_torch.launch.train``): (a) smollm-135m whole at its
     published config, 20 steps of 8 x 2048 tokens with checkpoints every
     10, the launch counts set to 0 just before and read just after: every
     loss and grad norm finite, every parameter changed, K6 forward and
     backward once per attention call (30 a step); step ms, tokens/s,
     peak memory, and two more steps under the profiler (idle share, top
     kernels, one dq and one dk/dv mma kernel run a backward launch); (b)
     under deterministic algorithms, ``run_resilient`` with one injected
     failure restores its checkpoint and ends on the uninterrupted run's
     parameters bit for bit (full width, 2 x 256 tokens, the backward's
     mma form alone); (c) one f32 train step of every reduced config on the card
     against the CPU; (d) the reduced deepseek-v3 (MLA, MoE, MTP) with the
     a2a over ShardMesh(4): its loss against the dense loss, then 8 steps
     with an ``EPRebalancer`` every 2 (fires at the cadence, experts
     relocated in place, the multiset kept, decisions equal to the CPU's);
     (e) the data pipeline's rebalance over 8 ranks equal to the CPU's.

It prints the card's name and power limit, one JSON line of the sharded
phases' numbers, one of the model families', one of expert balancing,
one of training, one JSON line of per-kernel numbers (K6's backward
beside K6, and inside its row), and as its last line
``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once where ``torch.cuda.is_available()`` is False.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# phase 15 (b) runs under torch.use_deterministic_algorithms, whose cuBLAS
# calls need a fixed workspace configuration before cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12       # also used for the kernels' 32-bit integer ops
PEAK_BF16_PER_S = 989e12     # dense tensor-core rate

PIC = dict(L=1000, n_particles=1 << 24, steps=100, cx=12, cy=12,
           num_pes=8, rho=0.9, mode="GEOMETRIC", lb_every=10,
           strategy="diff-comm", strategy_kwargs={"k": 4})
PIC_KERNELS = ("diffusion_nsweeps", "histogram", "pic_push", "scatter_dest")

# the simulator path: stencil-wave at 2^20 objects over 8192 nodes
SIM_SCENARIO = dict(grid=1024, num_nodes=8192, mapping="tiled")
SIM = dict(steps=30, lb_every=10, strategy="diff-comm",
           strategy_kwargs={"k": 8})
SIM_KERNELS = ("diffusion_nsweeps", "histogram")   # K4: segment sums
# K2 (the streaming sweep) runs where a caller plans with
# LBEngine(step_fn=ops.diffusion_sweep): the snapshot's plan in sim_engines
STEP_KERNELS = ("diffusion_sweep",)

# the serving path: gemma3-1b at full width on two replicas; prompts stay
# within the 1024-token window (a longer prefill would write several
# positions into one ring slot at once), and the two longest decode past it
SERVE_ARCH = "gemma3-1b"
SERVE_FULL = True            # the published config; a rehearsal: reduced
SERVE = dict(replicas=2, slots=4, max_len=1056, dtype="bfloat16",
             max_new=32,
             prompt_lens=(1000, 996, 512, 576, 640, 704, 768, 832))
SERVE_KERNELS = ("flash_attention", "scatter_dest")
# the host-planner PIC path: the PIC configuration under greedy-refine
PIC_HOST = dict(PIC, strategy="greedy-refine", strategy_kwargs={})
PIC_HOST_KERNELS = ("histogram", "pic_push", "scatter_dest")
# the paper scripts that assert against the host baselines, at their
# published sizes (``run(device=..., **kw)``; a rehearsal shrinks them),
# and the kernels each must launch
PAPER_HOST = {"table2_strategies": {}, "fig4_pic_lb": {},
              "fig5_scaling": {}}
PAPER_HOST_KERNELS = {"table2_strategies": ("diffusion_nsweeps",),
                      "fig4_pic_lb": PIC_KERNELS,
                      "fig5_scaling": PIC_KERNELS}
DEV = "cuda"   # the card; a rehearsal on the CPU sets "cpu"
# K1's and K3's calls by form on each path's run (filled as the paths run)
K1_PATH_FORMS: dict = {}
K3_PATH_FORMS: dict = {}
K3_LAUNCHES: dict = {}       # K3's launches on each path's run
K4_PATH_FORMS: dict = {}     # K4's calls by form on each path's run
K4_ORDERED_MS: dict = {}     # K4's ordered form by case (k4_ordered_check)
# the serving spill: a scheduler of 63 replicas and a park node (64^2 pair
# buckets) whose slot budget defers moves; heavy sessions on the first
# half of the replicas, the second half full of light ones
SPILL_SERVE = dict(replicas=63, heavy=44, light=86, slot_capacity=86)
# spill_owner at the sizes a fleet gives it: 64 nodes (C = 4096) and 257
# (C = 66049) over 2^20 items, and 64 over 2^18 against the CPU
SPILL_SIZES = ((64, 1 << 20), (257, 1 << 20))
SPILL_CPU = (64, 1 << 18)
# the serving fleet replay at the scale of the JAX serve bench's scale
# entry: 131072 sessions on 64 replicas, 30 ticks, LB every 10, diff-comm
# under the fixed cadence; its telemetry run under a slot budget above the
# 2048 sessions the initial block placement puts on each replica
FLEET = dict(num_sessions=131_072, num_replicas=64, seed=1)
FLEET_RUN = dict(steps=30, lb_every=10, strategy="diff-comm",
                 trigger="every")
FLEET_TEL_CAPACITY = 2150
FLEET_KERNELS = ("diffusion_nsweeps", "histogram", "scatter_dest")
# the serve bench's gated comparison (serve_bench.WORKLOADS, 120 ticks)
SERVE_BENCH = dict(steps=120)
# the fleet on the card against the CPU: 4096 sessions on 16 replicas,
# 60 ticks of diff-comm+predictive under a slot budget above the 256
# sessions a replica starts with
FLEET_CPU = dict(num_sessions=4096, num_replicas=16, steps=60,
                 slot_capacity=288)
# two-level placement: T threads a node at the simulator path's snapshot,
# a 20-step replay of that configuration, and a small PIC run
HIER_T = 16
HIER_SIM = dict(steps=20, lb_every=10, strategy="diff-comm",
                strategy_kwargs={"k": 8})
HIER_PIC = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
                lb_every=10, threads_per_node=4)
# the sharded paths: the PIC configuration over 8 shards of one card (the
# slabs' default capacity, then the run's tight one), the simulator path
# over 8 shards, the fleet over 8
SHARDED_PIC = dict(sharded_replay=True, replay_shards=8)
SHARDED_PIC_KERNELS = ("histogram", "pic_push", "scatter_dest")
SHARDED_SIM_KERNELS = ("histogram",)          # K4: segment sums
SHARDED_EXCHANGE_KERNELS = ("scatter_dest",)
SHARDED_FLEET_KERNELS = ("histogram", "scatter_dest")
PIC_FIELDS = ("max_avg", "ext_bytes", "int_bytes", "migrations",
              "migrated_bytes", "lb_steps", "final_x", "final_y")
SERIES_FIELDS = ("max_avg", "ext_int", "migrations", "lb_fired",
                 "max_load", "migrated_load", "final_assignment")
SHARDED_SIM_SHARDS = 8
FLEET_SHARDS = 8
# resilience: one die, one slow, one recover on a reduced series (4 shards
# of 16 nodes) and a reduced sharded PIC run (4 shards of 4 PEs; cpu_parity's
# configuration, whose particles the card pushes into the CPU's chares);
# the checkpointed replay's cadence and injected failures
RESIL_SIM = dict(scenario=dict(grid=32, num_nodes=16), steps=24, lb_every=4,
                 strategy_kwargs={"k": 3}, shards=4,
                 events=((6, 1, "die"), (9, 2, "slow"), (14, 1, "recover")),
                 every=5, fail_at=(1, 3))
RESIL_PIC = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
                 lb_every=10, strategy="diff-comm", shards=4,
                 events=((12, 3, "die"), (18, 1, "slow"), (26, 3, "recover")))
# the exchange alone: 2^24 items over 8 shards and 8192 nodes
EXCHANGE = dict(n=1 << 24, shards=8, nodes=8192)
# Fig 5 with the sharded planner as well, over 4 shards (dividing every PE
# count of the figure)
FIG5_SHARDED = dict(sharded=True, shards=4)
# phase 13: the other model families at their published widths.  ``cut``:
# the depth cut (dataclasses.replace fields; None: whole), ``dtype``: the
# parameters' type (bf16 where f32 with the per-call casts would not fit)
FAM_FULL = True              # the published configs; a rehearsal: reduced
FAM_SLOTS = 4
FAM_SERVE = {
    "deepseek-v3-671b": dict(cut=dict(num_layers=2, prefix_layers=("attn",)),
                             dtype="bfloat16", max_new=16,
                             prompt_lens=(256, 352, 448, 512)),
    "llama4-scout-17b-a16e": dict(cut=dict(num_layers=2), dtype="bfloat16",
                                  max_new=16,
                                  prompt_lens=(256, 352, 448, 512)),
    "hymba-1.5b": dict(cut=None, dtype="float32", max_new=32,
                       prompt_lens=(1000, 960, 700, 500)),
    "xlstm-125m": dict(cut=None, dtype="float32", max_new=16,
                       prompt_lens=(512, 384, 256, 128)),
}
FAM_STEP = {
    "qwen1.5-110b": dict(cut=dict(num_layers=2), dtype="bfloat16"),
    "gemma3-27b": dict(cut=dict(num_layers=8), dtype="bfloat16"),
    "paligemma-3b": dict(cut=None, dtype="float32"),
    "musicgen-medium": dict(cut=None, dtype="float32"),
}
FAM_STEP_SHAPE = dict(batch=2, prompt=512, steps=8)
FAM_KERNELS = ("flash_attention",)
# phase 14: expert balancing.  (a) the EP replay at deepseek-v3's routing
# shape: the JAX moe bench's scale entry (256 experts on 32 EP ranks, 4096
# tokens a step, Zipf 0.5, hot block x3, seed 1) with deepseek-v3's top-8,
# the EP32 deployment of arXiv:2412.19437 §3.4; 48 steps, LB every 8,
# diff-comm under the fixed cadence; (c) the same over 8 shards
EP = dict(num_experts=256, num_ranks=32, top_k=8, tokens_per_step=4096,
          alpha=0.5, hot_amp=2.0, trace_len=48, seed=1)
EP_RUN = dict(steps=48, lb_every=8, strategy="diff-comm", trigger="every")
EP_SHARDS = 8
EP_KERNELS = ("diffusion_nsweeps", "histogram", "scatter_dest")
# (b) deepseek-v3's experts (phase 13's weights) relocated over 32 EP ranks
EP_ARCH = "deepseek-v3-671b"
EP_RELOCATE_RANKS = 32
# (d) the two benches' gates at their own sizes (a rehearsal shrinks them)
EP_BENCH = dict(moe_steps=96, scale={}, ep_balance={})
EPB: dict = {}          # phase 14's numbers (one JSON line)
EP_LAUNCHES: dict = {}  # K1/K3/K4 launches on phase 14's paths
# phase 15: training.  (a) smollm-135m whole at its published config
# through the port's train launcher, 20 steps of 8 x 2048 tokens,
# checkpoints every 10; (b) crash and resume at full width, short rows;
# (c) one step of every reduced config (f32) card vs CPU; (d) the reduced
# deepseek-v3 (MLA, MoE, MTP) with the a2a over 4 EP shards and expert
# rebalancing every 2 steps over 8, f32 so the CPU's routing is the
# card's; (e) the data pipeline's rebalance over 8 ranks
TRAIN_FULL = True            # the published config; a rehearsal: reduced
TRAIN = dict(arch="smollm-135m", steps=20, seq_len=2048, global_batch=8,
             save_every=10)
TRAIN_RESUME = dict(steps=6, seq_len=256, batch=2, fail_at=3, save_every=2)
TRAIN_EP = dict(arch="deepseek-v3-671b", steps=8, ep_balance_every=2,
                ep_shards=4, seq_len=64, global_batch=4)
TRAIN_EP_ZIPF = 1.1          # the EP run's token ids: Zipf(1.1)
TRAIN_EP_RANKS = 2           # EP ranks of the rebalancer (4 experts each)
TRAIN_EP_KERNELS = ("flash_attention", "flash_attention_bwd",
                    "diffusion_nsweeps", "histogram", "scatter_dest")
TRAIN_DATA = dict(num_ranks=8, num_shards=128, seq_len=2048, seed=0,
                  threshold=1.05)
TRAINING: dict = {}     # phase 15's numbers (one JSON line)
TRAIN_LAUNCHES: dict = {}   # launches on phase 15's paths, by path
SMI = ""             # the card's name and power limit (nvidia-smi)
RESULTS: dict = {}   # single-device results the sharded phases are held to
SHARDED: dict = {}   # the sharded phases' numbers (one JSON line)
FAMILIES: dict = {}  # phase 13's numbers (one JSON line)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """``(fn(), ms)``: one call timed by CUDA events (on the CPU, by the
    host clock) — for plain versions too slow to repeat."""
    import torch

    if DEV != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def host_ms(fn, reps: int = 20) -> float:
    """Host time to issue ``fn()`` (a perf_counter around back-to-back
    calls that are not waited for), after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def bound_ms(nbytes: float, ops: float, peak_ops=PEAK_F32_PER_S):
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def spacing(v) -> float:
    """f32 spacing at max |v| (one ulp there)."""
    import torch

    s = v.abs().max()
    return float(torch.nextafter(s, s + 1) - s)


# ------------------------------------------------------------ main path --


def k1_forms_since(before, path, P, K, launches):
    """K1's calls by form since ``before`` (a copy of
    ``ops.form_launches``), recorded for ``path``; every call must have
    taken the form ``k1_form(P, K)`` names."""
    from repro_torch.kernels.diffusion import ops as dops

    forms = {f: n - before[f] for f, n in dops.form_launches.items()}
    K1_PATH_FORMS[path] = forms
    want = dops.k1_form(P, K)
    check(forms[want] == launches == sum(forms.values()),
          f"{path} path: K1 forms {forms}, not {launches} calls of the "
          f"{want} form")
    return forms


def k3_forms_since(before, path, launches):
    """K3's calls by form since ``before`` (a copy of
    ``ops.form_launches``), recorded for ``path``; on a path of single
    passes (no radix call) they must add up to the registry's
    ``launches``."""
    from repro_torch.kernels.migrate import ops as mops

    forms = {f: n - before[f] for f, n in mops.form_launches.items()}
    K3_PATH_FORMS[path] = forms
    if not forms["radix"]:
        check(sum(forms.values()) == launches, f"{path} path: K3 forms "
              f"{forms} do not add up to its {launches} launches")
    return forms


def main_path():
    from repro_torch import kernels
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.pic import driver

    from repro_torch.kernels.migrate import ops as mops

    from repro_torch.kernels.histogram import ops as hops

    kernels.reset_launch_counts()
    k1_0 = dict(dops.form_launches)
    k3_0 = dict(mops.form_launches)
    k4_0 = dict(hops.form_launches)
    t0 = time.perf_counter()
    res = driver.run(driver.PICConfig(**PIC, device="cuda"))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    K4_PATH_FORMS["PIC"] = {f: n - k4_0[f]
                            for f, n in hops.form_launches.items()}
    k1_forms_since(k1_0, "PIC", PIC["num_pes"], PIC["strategy_kwargs"]["k"],
                   counts["diffusion_nsweeps"])
    forms = k3_forms_since(k3_0, "PIC", counts["scatter_dest"])
    want = mops.scatter_form(PIC["n_particles"], PIC["num_pes"])
    check(forms[want] == counts["scatter_dest"], f"PIC path: K3 forms "
          f"{forms}, not {counts['scatter_dest']} calls of the {want} form")
    print(f"PIC path: {PIC['n_particles']} particles, {PIC['steps']} steps "
          f"in {wall:.3f} s end to end ({res.wall_seconds:.3f} s step loop, "
          f"{PIC['steps'] / res.wall_seconds:.2f} steps/s); launches "
          f"{counts}")
    for name in PIC_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the PIC "
              "path")

    check_pic_result(res, PIC)
    none = driver.run(driver.PICConfig(**{**PIC, "strategy": "none"},
                                       device="cuda"))
    bal, ref = res.summary()["mean_max_avg"], none.summary()["mean_max_avg"]
    print(f"mean max/avg: diff-comm {bal:.6f} vs none {ref:.6f}; migrated "
          f"{res.migrated_bytes.sum():.0f} B over {int(res.lb_steps.sum())} "
          "rebalances")
    check(bal < ref, "diff-comm did not lower mean max/avg below none")
    return counts, res, none


def host_pic_path(diff, none):
    """The PIC configuration above under ``greedy-refine``, a host planner
    (NumPy on the host at each fired step, the exchange on the card), with
    the launch counts set to 0 just before and read just after: K5 and K4
    every step, K3 at each exchange, no K1; its mean max/avg below the
    ``none`` run's.  Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.pic import driver

    from repro_torch.kernels.histogram import ops as hops

    cfg = PIC_HOST
    kernels.reset_launch_counts()
    k4_0 = dict(hops.form_launches)
    t0 = time.perf_counter()
    res = driver.run(driver.PICConfig(**cfg, device=DEV))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    k4 = K4_PATH_FORMS["PIC greedy-refine"] = {
        f: n - k4_0[f] for f, n in hops.form_launches.items()}
    fired = int(res.lb_steps.sum())
    print(f"PIC path under greedy-refine: {cfg['n_particles']} particles, "
          f"{cfg['steps']} steps in {wall:.3f} s end to end "
          f"({res.wall_seconds:.3f} s step loop, "
          f"{cfg['steps'] / res.wall_seconds:.2f} steps/s against "
          f"diff-comm's {diff['steps'] / diff['wall_seconds']:.2f}); "
          f"{fired} host plans, {res.lb_seconds:.6f} s of planning "
          f"(diff-comm charged {diff['lb_seconds']:.6f}); launches {counts}"
          f", K4 calls by form {k4}")
    for name in PIC_HOST_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "greedy-refine PIC path")
    if PIC_HOST_KERNELS:
        # K4: the chare loads (private form) every step, the segment sums
        # of the PE loads and the trigger's statistics (ordered form)
        want = dict(pic_push=cfg["steps"], scatter_dest=fired,
                    diffusion_nsweeps=0, private=cfg["steps"],
                    histogram=k4["private"] + k4["ordered"])
        got = {**{k: counts[k] for k in ("pic_push", "scatter_dest",
                                          "diffusion_nsweeps", "histogram")},
               "private": k4["private"]}
        check(got == want and k4["ordered"] >= cfg["steps"],
              f"greedy-refine PIC path: launches {got}, K4 forms {k4}, not "
              f"{want}")
    check_pic_result(res, cfg)
    bal, ref = res.summary()["mean_max_avg"], none.summary()["mean_max_avg"]
    print(f"mean max/avg: greedy-refine {bal:.6f} vs none {ref:.6f}; "
          f"migrated {res.migrated_bytes.sum():.0f} B over {fired} "
          "rebalances")
    check(bal < ref, "greedy-refine did not lower mean max/avg below none")
    return counts


def check_pic_result(res, cfg):
    """A PIC run's invariants: particles conserved, finite and on the
    grid, chare loads summing to the particle count, the fixed cadence's
    rebalances fired, particles migrated."""
    import numpy as np
    import torch
    from repro_torch.kernels.histogram.ops import histogram
    from repro_torch.pic import chares

    N = cfg["n_particles"]
    fx, fy = res.final_x, res.final_y
    check(fx.shape == (N,) and fy.shape == (N,), "particles not conserved")
    check(np.isfinite(fx).all() and np.isfinite(fy).all(),
          "non-finite positions")
    check(((fx >= 0) & (fx <= cfg["L"]) & (fy >= 0)
           & (fy <= cfg["L"])).all(), "positions left the grid")
    xt = torch.as_tensor(fx, device=DEV)
    yt = torch.as_tensor(fy, device=DEV)
    loads = histogram(chares.chare_of_device(xt, yt, cfg["L"], cfg["cx"],
                                             cfg["cy"]),
                      torch.ones_like(xt), C=cfg["cx"] * cfg["cy"])
    check(float(loads.sum()) == N, f"chare loads sum to {float(loads.sum())}"
          f", not {N}")
    fired = int(res.lb_steps.sum())
    check(fired == (cfg["steps"] - 1) // cfg["lb_every"],
          f"LB fired {fired} times")
    check(res.migrated_bytes.sum() > 0, "no particle was migrated")


def cpu_parity():
    """A small PIC run on the card equals the same run on the CPU, under
    diff-comm and under greedy-refine (a host planner)."""
    import numpy as np
    from repro_torch.pic import driver

    for strategy in ("diff-comm", "greedy-refine"):
        small = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8,
                     num_pes=4, lb_every=10, strategy=strategy)
        g = driver.run(driver.PICConfig(**small, device="cuda"))
        c = driver.run(driver.PICConfig(**small, device="cpu"))
        for f in ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
                  "int_bytes", "max_avg"):
            check(np.array_equal(getattr(g, f), getattr(c, f)),
                  f"small PIC run ({strategy}): {f} differs between cuda "
                  "and cpu")
        err = max(np.abs(g.final_x - c.final_x).max(),
                  np.abs(g.final_y - c.final_y).max())
        check(err <= 1e-3, f"small PIC run ({strategy}): positions differ "
              f"by {err}")
        print(f"small PIC run ({strategy}) on cuda == cpu (positions "
              f"within {err:.3g})")


# ------------------------------------------------------- simulator path --


def _sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def sim_path():
    """The stencil-wave replay at full size; returns its launch counts and
    the snapshot of its first fired step (the initial assignment)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.sim import scenarios, simulator

    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device=DEV, **SIM_SCENARIO)
    P, K = SIM_SCENARIO["num_nodes"], SIM["strategy_kwargs"]["k"]
    N = SIM_SCENARIO["grid"] ** 2
    print(f"sweep_impl({P}, {K}) = {dops.sweep_impl(P, K, DEV)!r} (the "
          f"fused kernel up to P*K = {dops.FUSED_MAX_PK}), k1_form = "
          f"{dops.k1_form(P, K)!r}")
    from repro_torch.kernels.histogram import ops as hops

    kernels.reset_launch_counts()
    k1_0 = dict(dops.form_launches)
    k4_0 = dict(hops.form_launches)
    t0 = time.perf_counter()
    res = simulator.run_series(problem, evolve, **SIM)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    K4_PATH_FORMS["simulator"] = {f: n - k4_0[f]
                                  for f, n in hops.form_launches.items()}
    if "diffusion_nsweeps" in SIM_KERNELS:
        k1_forms_since(k1_0, "simulator", P, K, counts["diffusion_nsweeps"])
    fired = np.nonzero(res.lb_fired)[0].tolist()
    plan_s = [float(res.plan_step_seconds[t]) for t in fired]
    print(f"simulator path: stencil-wave, {N} objects, {P} nodes, "
          f"{SIM['steps']} steps in {wall:.3f} s end to end "
          f"({res.wall_seconds:.3f} s replay loop); fired at steps {fired}, "
          f"plan seconds {plan_s}; launches {counts}")
    for name in SIM_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "simulator path")
    check(res.scanned, "the replay did not take the device-resident loop")
    check(fired == [10, 20], f"LB fired at steps {fired}, not [10, 20]")
    check(np.isfinite(res.max_avg).all() and np.isfinite(res.ext_int).all()
          and np.isfinite(res.migrated_load).all(), "non-finite records")
    fa = res.final_assignment
    check(fa.shape == (N,) and fa.min() >= 0 and fa.max() < P,
          "final assignment out of range")
    check((res.migrations[fired] > 0).all(), "a fired plan moved nothing")
    none = simulator.run_series(problem, evolve,
                                **{**SIM, "strategy": "none"})
    for t in fired:
        check(res.max_avg[t] < none.max_avg[t],
              f"step {t}: max/avg {res.max_avg[t]} not below none's "
              f"{none.max_avg[t]}")
    print("max/avg at the fired steps: diff-comm "
          f"{[float(res.max_avg[t]) for t in fired]} vs none "
          f"{[float(none.max_avg[t]) for t in fired]}; ext/int "
          f"{[float(res.ext_int[t]) for t in fired]} vs "
          f"{[float(none.ext_int[t]) for t in fired]}; moved "
          f"{[float(res.migrations[t]) for t in fired]} of the objects")
    RESULTS["sim"] = res
    return counts, evolve(problem, fired[0])


def sim_engines(snap):
    """Plan the snapshot through ``LBEngine(step_fn=ops.diffusion_sweep)``
    (K2's path: the launch counts set to 0 just before and read just after)
    and the default engine, then stage 2 through the selected chunk (K1)
    against the streaming one; returns the stage-2 inputs ``(loads, nbr,
    mask)`` and the launch counts of the step_fn plan."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import comm_graph, engine, metrics
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import object_selection as osel
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops

    K = SIM["strategy_kwargs"]["k"]
    kernels.reset_launch_counts()
    step = engine.LBEngine(k=K, step_fn=dops.diffusion_sweep,
                           device=DEV).plan(snap)
    step_counts = kernels.launch_counts()
    for name in STEP_KERNELS:
        check(step_counts[name] > 0, f"kernel {name} was not launched by "
              "the step_fn plan")
    default = engine.get_engine(k=K, device=DEV).plan(snap)
    print(f"full-size plan: LBEngine(step_fn=diffusion_sweep) "
          f"{step.info['plan_seconds']:.3f} s, default engine "
          f"{default.info['plan_seconds']:.3f} s; "
          f"{default.info['diffusion_iters']} sweeps, "
          f"{default.info['protocol_rounds']} handshake rounds")
    check(step.info["diffusion_iters"] == default.info["diffusion_iters"],
          "step_fn engine and default engine differ in sweeps")
    check(np.array_equal(step.assignment, default.assignment),
          "step_fn engine and default engine differ in assignment")

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        return out, time.perf_counter() - t0

    nres, s1 = timed(lambda: ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(snap)), k=K))
    nl = comm_graph.node_loads(snap)
    args = (nl, nres.nbr_idx, nres.nbr_mask)
    # stage 2 three ways: the selected chunk (K1 by sweep_impl), the
    # streaming chunk (K2 in a replayed CUDA graph) and K2 issued sweep by
    # sweep (step_fn); the first two timed warm (graph captured)
    vlb.virtual_balance(*args, chunk_fn=dops.streaming_nsweeps)
    fused, s2f = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.diffusion_nsweeps))
    stream, s2s = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.streaming_nsweeps))
    eager, s2e = timed(lambda: vlb.virtual_balance(
        *args, step_fn=dops.diffusion_sweep))
    a_f, s3 = timed(lambda: osel.select_objects(
        snap, nres.nbr_idx, nres.nbr_mask, fused.flows).assignment)
    a_s = osel.select_objects(snap, nres.nbr_idx, nres.nbr_mask,
                              stream.flows).assignment
    print(f"stages at full size: 1 (neighbor selection) {s1:.3f} s, "
          f"{int(nres.rounds)} rounds; 2 selected ("
          f"{dops.sweep_impl(*nres.nbr_idx.shape, DEV)}) {s2f:.3f} s / "
          "streaming "
          f"{s2s:.3f} s / step_fn {s2e:.3f} s; 3 (object selection) "
          f"{s3:.3f} s")
    check(all(torch.equal(a, b) for a, b in zip(stream, eager)),
          "stage 2: the graph-replayed and the step_fn streaming paths "
          "differ")
    check(int(fused.iters) == int(stream.iters),
          f"stage 2: fused {int(fused.iters)} vs streaming "
          f"{int(stream.iters)} sweeps")
    ulp = spacing(nl)
    err = max(float((fused.target_loads - stream.target_loads).abs().max()),
              float((fused.flows - stream.flows).abs().max()))
    print(f"stage 2 fused vs streaming: {int(fused.iters)} sweeps each, "
          f"max_abs_err {err:.6g} ({err / ulp:.1f} ulp of the largest "
          "load); the streaming graph and step_fn paths equal bit for bit")
    check(err <= 64 * ulp, "stage 2: fused and streaming more than 64 ulp "
          "apart")
    n_diff = int((a_f != a_s).sum())
    if n_diff:
        m_f = metrics.evaluate(snap, a_f)
        m_s = metrics.evaluate(snap, a_s)
        print(f"stage 3: assignments differ on {n_diff} objects (a float "
              f"tie); max/avg {m_f['max_avg_load']} vs "
              f"{m_s['max_avg_load']}, ext/int {m_f['ext_int_comm']} vs "
              f"{m_s['ext_int_comm']}")
        for key in ("max_avg_load", "ext_int_comm"):
            check(abs(m_f[key] - m_s[key]) <= 1e-4 * abs(m_s[key]),
                  f"stage 3: {key} differs by more than 1e-4 relative")
    else:
        print("stage 3: the fused and streaming flows give equal "
              "assignments")
    return args, step_counts


def paper_scripts_and_small_replay():
    """Table I and Fig 2 on the card (their assertions hold), and a small
    replay on the card against the CPU."""
    import numpy as np
    from benchmarks_torch import fig2_stencil, table1_neighbor_count
    from repro_torch.sim import scenarios, simulator

    table1_neighbor_count.run(device=DEV)
    fig2_stencil.run(device=DEV)
    kw = dict(steps=24, lb_every=6, strategy="diff-comm")
    small = dict(grid=16, num_nodes=8)
    cpu = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
        device="cpu", **small), **kw)
    for scan in (True, False):
        g = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
            device=DEV, **small), scan=scan, **kw)
        for f in ("lb_fired", "final_assignment"):
            check(np.array_equal(getattr(g, f), getattr(cpu, f)),
                  f"small replay (scan={scan}): {f} differs between cuda "
                  "and cpu")
    print("small stencil-wave replay on cuda == cpu on both loops "
          f"(fired {int(cpu.lb_fired.sum())} times)")


def k4_ordered_check(snap):
    """K4's ordered form — the card's f32 segment sums — at the fleet's
    replica loads (131072 sessions into 64 replicas), the PIC path's PE
    loads (144 chares into 8 PEs, the unsorted walk) and the simulator
    snapshot's shapes (node loads: 2^20 objects into 8192 nodes; pair
    bytes: the edges into P^2 node pairs), and on loads of three
    magnitudes, bit for bit against its plain version on the CPU, timed;
    then ``comm_graph.ordered_sum`` (its window form) over 131072 items."""
    import numpy as np
    import torch
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.histogram.ref import histogram_ref

    P = snap.num_nodes
    a = snap.assignment.long()
    valid = snap.edges_src >= 0
    pair = torch.where(valid, a[snap.edges_src.clamp(min=0).long()] * P
                       + a[snap.edges_dst.clamp(min=0).long()], 0)
    n = snap.num_objects
    rng = np.random.default_rng(0)
    mixed = torch.as_tensor((rng.random(n) * 1000).astype(np.float32)
                            * rng.choice(np.array([1e-3, 1, 1e3],
                                                  np.float32), n),
                            device=DEV)
    C_pic = PIC["cx"] * PIC["cy"]
    # the fleet's replica loads: its sessions in the initial block
    # placement, their floored loads at tick 0 (the sorted-runs route)
    from repro_torch.serve import replay as sr

    fw = sr.ServeWorkload(**FLEET)
    S, R = FLEET["num_sessions"], FLEET["num_replicas"]
    uid = torch.arange(S, dtype=torch.int32, device=DEV)
    cases = {"fleet replica loads": (
                 torch.div(uid * R, S, rounding_mode="floor"),
                 torch.clamp(fw.loads_at(0, uid), min=1e-3), R),
             "PIC PE loads (unsorted walk)": (
                 torch.as_tensor(rng.integers(0, PIC["num_pes"], C_pic),
                                 device=DEV), mixed[:C_pic],
                 PIC["num_pes"]),
             "node loads": (a, snap.loads, P),
             "pair bytes": (pair, torch.where(valid, snap.edges_bytes, 0.0),
                            P * P),
             "mixed loads": (a, mixed, P)}
    for name, (ids, w, C) in cases.items():
        got = hops.histogram_ordered(ids, w, C=C)
        want = histogram_ref(ids.cpu(), w.cpu(), C=C)
        check(torch.equal(got.cpu(), want), f"K4 ordered form ({name}): "
              "differs from the plain version")
        ms = time_ms(lambda: hops.histogram_ordered(ids, w, C=C), reps=5) \
            if DEV == "cuda" else float("nan")
        K4_ORDERED_MS[name] = ms
        print(f"K4 ordered form, {name}: {ids.shape[0]} items into {C} "
              f"bins equal to the CPU's bit for bit, {ms:.4f} ms")
    # comm_graph.ordered_sum over the fleet's sessions: one ordered-form
    # launch over 32-item windows a level (131072 → 4096 → 128 → 4 → 1)
    from repro_torch.core.comm_graph import ordered_sum

    check(torch.equal(ordered_sum(mixed[:S]).cpu(),
                      ordered_sum(mixed[:S].cpu())),
          "ordered_sum on the card differs from the CPU's")
    ms = time_ms(lambda: ordered_sum(mixed[:S]), reps=5) \
        if DEV == "cuda" else float("nan")
    K4_ORDERED_MS["ordered_sum of the fleet's sessions"] = ms
    print(f"ordered_sum over {S} items equal to the CPU's bit for bit, "
          f"{ms:.4f} ms")


def host_and_batched_replays():
    """A small greedy-refine replay (the host loop) and a small batched
    replay (every registered scenario, diff-comm) on the card, each
    against the same replay on the CPU: fire steps and final assignments
    equal."""
    import numpy as np
    from repro_torch.sim import scenarios, simulator

    kw = dict(steps=24, lb_every=6, strategy="greedy-refine")
    small = dict(grid=16, num_nodes=8)
    cpu = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
        device="cpu", **small), **kw)
    g = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
        device=DEV, **small), **kw)
    check(not g.scanned, "greedy-refine did not take the host loop")
    for f in ("lb_fired", "final_assignment"):
        check(np.array_equal(getattr(g, f), getattr(cpu, f)),
              f"greedy-refine replay: {f} differs between {DEV} and cpu")
    bkw = dict(steps=24, lb_every=6, strategy="diff-comm",
               strategy_kwargs=dict(k=3))
    bc = simulator.run_series_batch(scenarios.batch_instances(
        8, grid=16, num_nodes=8, device="cpu"), **bkw)
    inst = scenarios.batch_instances(8, grid=16, num_nodes=8, device=DEV)
    bg = simulator.run_series_batch(inst, **bkw)
    for (name, _, _), lg, lc in zip(inst, bg.series, bc.series):
        for f in ("lb_fired", "final_assignment"):
            check(np.array_equal(getattr(lg, f), getattr(lc, f)),
                  f"batched replay, lane {name}: {f} differs between "
                  f"{DEV} and cpu")
    print(f"greedy-refine replay on {DEV} == cpu (fired "
          f"{int(cpu.lb_fired.sum())} times, {g.plan_seconds:.6f} s of "
          f"planning); batched replay of {bg.batch} lanes on {DEV} == cpu "
          f"({bg.wall_seconds:.3f} s, {bg.lane_steps_per_sec:.1f} "
          "lane-steps/s)")


def paper_scripts_host():
    """Table II, Fig 4 and Fig 5 on the card, their assertions holding,
    each with the launch counts set to 0 just before and read just after;
    prints each script's wall time, Table II's plan seconds and Fig 5's
    planning seconds."""
    import importlib

    from repro_torch import kernels

    out = {}
    for name, kw in PAPER_HOST.items():
        mod = importlib.import_module(f"benchmarks_torch.{name}")
        kernels.reset_launch_counts()
        _sync()
        t0 = time.perf_counter()
        res = mod.run(device=DEV, **kw)
        _sync()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        print(f"{name}: {wall:.3f} s on {DEV}; launches {counts}")
        for k in PAPER_HOST_KERNELS[name]:
            check(counts[k] > 0, f"kernel {k} was not launched by {name}")
        out[name] = res
    t2 = out["table2_strategies"]
    print("table2 plan seconds: " + ", ".join(
        f"{pes} PEs " + " ".join(
            f"{s}={t2[pes][s]['plan_seconds']!r}" for s in t2[pes])
        for pes in t2 if isinstance(pes, int)))
    print("table2 trigger policies (wall s): " + ", ".join(
        f"{s}={v['wall_seconds']!r} (plans {v['plan_seconds']!r})"
        for s, v in t2["trigger_policies"].items()))
    f4 = out["fig4_pic_lb"]
    print("fig4 step-loop wall s: " + ", ".join(
        f"{s}={v['wall_seconds']!r}" for s, v in f4.items()))
    f5 = out["fig5_scaling"]
    print("fig5 modeled s / lb s / wall s: " + "; ".join(
        f"{pes} PEs " + " ".join(
            f"{s}={c['modeled_time']!r}/{c['lb_seconds']!r}/"
            f"{c['wall_seconds']!r}" for s, c in f5[pes].items())
        for pes in f5 if isinstance(pes, int)))
    print(f"fig5 batched sweep: {f5['batched_scenarios']['wall_seconds']!r}"
          f" s, {f5['batched_scenarios']['lane_steps_per_sec']!r} "
          "lane-steps/s")


# --------------------------------------------------------- serving path --


def instrument_engine(e, prefill_s, tick_s):
    """Synchronized timing around the engine's own prefill and tick
    (seconds appended to the lists), and the finiteness of every logits
    row they produce."""
    import torch

    prefill, tick = e._prefill_slot, e.tick

    def timed_prefill(prompt, slot):
        _sync()
        t = time.perf_counter()
        logits = prefill(prompt, slot)
        _sync()
        prefill_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()), "non-finite logits "
              "from a prefill")
        return logits

    def timed_tick():
        _sync()
        t = time.perf_counter()
        tick()
        _sync()
        tick_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(e.last_logits).all()),
              "non-finite logits from a tick")

    e._prefill_slot, e.tick = timed_prefill, timed_tick


def serve_path():
    """Two ServeEngines behind a DiffusionScheduler at gemma3-1b's full
    width, as ``repro_torch.launch.serve`` wires them; returns the launch
    counts of the run."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import DiffusionScheduler, Session

    spec = get_arch(SERVE_ARCH)
    cfg = spec.config if SERVE_FULL else spec.reduced
    specs = transformer.model_specs(cfg)
    _sync()
    t0 = time.perf_counter()
    params = init_params(specs, 0, device=DEV)
    _sync()
    print(f"serving path: {cfg.name}, {count_params(specs)} parameters "
          f"(f32, random, seed 0) made in {time.perf_counter() - t0:.3f} s")
    R, V = SERVE["replicas"], cfg.vocab_size
    sched = DiffusionScheduler(R, device=DEV)
    engines = [ServeEngine(cfg, params, ServeConfig(
        num_slots=SERVE["slots"], max_len=SERVE["max_len"],
        dtype=SERVE["dtype"]), device=DEV) for _ in range(R)]
    prefill_s, tick_s = [], []
    for e in engines:
        instrument_engine(e, prefill_s, tick_s)
    rng = np.random.default_rng(0)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    from repro_torch.kernels.migrate import ops as mops

    kernels.reset_launch_counts()
    forms0 = dict(fops.form_launches)
    k1_0 = dict(dops.form_launches)
    k3_0 = dict(mops.form_launches)
    _sync()
    t0 = time.perf_counter()
    for i, plen in enumerate(SERVE["prompt_lens"]):
        prompt = rng.integers(1, V, size=plen)
        r = sched.place_new(Session(uid=i, replica=0, tokens_per_s=1.0,
                                    prefix_group=i % 2))
        engines[r].submit(Request(uid=i, prompt=prompt,
                                  max_new_tokens=SERVE["max_new"]))
    info = sched.rebalance()
    done = []
    for e in engines:
        done += e.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_req, new = len(SERVE["prompt_lens"]), SERVE["max_new"]
    check(sorted(r.uid for r in done) == list(range(n_req)),
          f"served {sorted(r.uid for r in done)}, not all {n_req} requests")
    check(all(len(r.out) == new for r in done), "a request did not get "
          f"{new} tokens")
    toks = np.concatenate([r.out for r in done])
    check(((toks >= 0) & (toks < V)).all(), "a token out of the vocabulary")
    n_layers, ticks = len(cfg.all_layers()), sum(e.ticks for e in engines)
    check(len(prefill_s) == n_req, f"{len(prefill_s)} prefills for {n_req} "
          "requests")
    want = (n_layers * (n_req + ticks)
            if "flash_attention" in SERVE_KERNELS else 0)
    check(counts["flash_attention"] == want, f"flash_attention launched "
          f"{counts['flash_attention']} times, not {n_layers} layers x "
          f"({n_req} prefills + {ticks} ticks) = {want}")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "serving path")
    # K6's forms on the path: bf16 prefills on the tensor cores, decode
    # ticks split over the key axis
    forms = {f: n - forms0[f] for f, n in fops.form_launches.items()}
    K1_PATH_FORMS["serving"] = {f: n - k1_0[f]
                                for f, n in dops.form_launches.items()}
    k3_forms_since(k3_0, "serving", counts["scatter_dest"])
    want_forms = ({"split": n_layers * ticks, "mma": n_layers * n_req,
                   "simt": 0} if "flash_attention" in SERVE_KERNELS
                  else {f: 0 for f in forms})
    check(forms == want_forms, f"flash_attention forms {forms}, not "
          f"{want_forms}")
    local = cfg.all_layers().index("attn_local")
    ring = engines[0].cache[local]["kv"]["pos"]
    ring_max = int(ring[ring < 2 ** 29].max())      # written slots only
    check(ring_max >= ring.shape[1], "no window ring wrapped")
    decode_s = sum(tick_s) - sum(prefill_s)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda"
            else float("nan"))
    print(f"serving path: {n_req} requests on {R} replicas, "
          f"{len(toks)} tokens in {wall:.3f} s end to end "
          f"({len(toks) / wall:.2f} generated tokens/s); prefill "
          f"{1e3 * np.mean(prefill_s):.3f} ms a request "
          f"({[round(1e3 * t, 3) for t in prefill_s]} ms for prompts "
          f"{list(SERVE['prompt_lens'])}), decode "
          f"{1e3 * decode_s / ticks:.3f} ms a tick over {ticks} ticks of "
          f"{SERVE['slots']} slots; peak device memory {peak:.3f} GiB; "
          f"K6 forms {forms}; "
          f"the window ring holds positions up to {ring_max} in "
          f"{ring.shape[1]} slots")
    print(f"scheduler: max/avg load {info['max_avg_load']:.6f}, ext/int "
          f"{info['ext_int_comm']:.6f}, moved {info['moved_sessions']} "
          f"sessions / {info['moved_kv_bytes']:.0f} KV bytes, prefix-local "
          f"{info['prefix_local']:.6f}, {info.get('diffusion_iters')} "
          f"sweeps; launches {counts} (diffusion_nsweeps "
          f"{counts['diffusion_nsweeps']}: a balanced placement may plan "
          "no sweep)")
    return counts


def serve_cpu_parity(arch=SERVE_ARCH):
    """A reduced config in f32 served on the card and on the CPU: equal
    tokens, and prefill/decode logits within 1e-3 (a frontend's prefill
    from its embeddings as well)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_to
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch(arch).reduced,
                              compute_dtype="float32")
    p_cpu = init_params(transformer.model_specs(cfg), 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (9, 14, 11)]
    emb = frontend_batch(cfg, 1, 12, 0, "cpu")
    outs, logits = {}, {}
    for dev in ("cpu", DEV):
        p = tree_to(p_cpu, dev)
        e = ServeEngine(cfg, p, ServeConfig(num_slots=2, max_len=40),
                        device=dev)
        for i, pr in enumerate(prompts):
            e.submit(Request(uid=i, prompt=pr, max_new_tokens=12))
        outs[dev] = [(r.uid, r.out) for r in e.run_until_drained()]
        cache = transformer.init_cache(cfg, 1, 40, torch.float32, dev)
        toks = torch.as_tensor(prompts[1], device=dev)[None]
        pos = torch.arange(toks.shape[1], dtype=torch.int32, device=dev)[None]
        lg, cache = transformer.prefill(p, cfg, dict(tokens=toks,
                                                     positions=pos), cache)
        seq = [lg[:, 0]]
        for i, tok in enumerate(outs["cpu"][1][1][:10]):
            lg, cache = transformer.decode_step(
                p, cfg, torch.tensor([[tok]], device=dev),
                toks.shape[1] + i, cache)
            seq.append(lg[:, 0])
        if cfg.frontend != "none":
            cache = transformer.init_cache(cfg, 1, 40, torch.float32, dev)
            lg, _ = transformer.prefill(p, cfg, tree_to(emb, dev), cache)
            seq.append(lg[:, 0])
        logits[dev] = torch.cat(seq).cpu()
    check(outs["cpu"] == outs[DEV], f"reduced {arch}: tokens differ "
          f"between {DEV} and cpu")
    err = float((logits["cpu"] - logits[DEV]).abs().max())
    check(err <= 1e-3, f"reduced {arch}: logits differ by {err}")
    front = ("" if cfg.frontend == "none"
             else " (and a prefill from the frontend embeddings)")
    print(f"reduced {arch} served on {DEV} == cpu: 3 requests, equal "
          f"tokens; prefill and 10 decode steps' logits{front} within "
          f"{err:.3g}")
    return err


def spill_scheduler(dev):
    """The SPILL_SERVE scheduler on ``dev``: sessions made from seed 7
    (whole KV bytes, so sums of them are exact in any order)."""
    import numpy as np
    from repro_torch.serve.scheduler import DiffusionScheduler, Session

    cfg = SPILL_SERVE
    R = cfg["replicas"]
    sched = DiffusionScheduler(R, k=3, device=dev)
    rng = np.random.default_rng(7)
    uid = 0
    for r in range(R):
        heavy = r < R // 2
        for _ in range(cfg["heavy"] if heavy else cfg["light"]):
            sched.add(Session(
                uid=uid, replica=r, prefix_group=uid // 5,
                tokens_per_s=float(rng.uniform(3, 5) if heavy
                                   else rng.uniform(0.2, 0.6)),
                kv_bytes=float(rng.integers(10, 200))))
            uid += 1
    return sched


def serve_spill():
    """A DiffusionScheduler of 63 replicas rebalancing about 4100 sessions
    under a slot budget that defers moves (spill_owner over 64^2 pair
    buckets), with the launch counts set to 0 just before and read just
    after.  The same scheduler on the CPU, given the card's plan (stage 2
    sums its floats in another order there, which may move a few sessions
    of the plan), must end with equal sessions, deferred sessions and
    moved KV bytes.  Returns the launch counts."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.kernels.migrate import ops as mops

    base = engine.get_strategy("diff-comm")
    plans = []

    def recorded(problem, **params):
        assignment, stats = base.plan_fn(problem, **params)
        plans.append((assignment, stats))
        return assignment, stats

    def replayed(problem, **params):
        assignment, stats = plans[0]
        return assignment.to(problem.device), stats

    for name, fn in (("diff-comm-recorded", recorded),
                     ("diff-comm-replayed", replayed)):
        engine.register(dataclasses.replace(base, name=name, plan_fn=fn))
    cap = SPILL_SERVE["slot_capacity"]
    card = spill_scheduler(DEV)
    kernels.reset_launch_counts()
    k3_0 = dict(mops.form_launches)
    _sync()
    t0 = time.perf_counter()
    got = card.rebalance(strategy="diff-comm-recorded", slot_capacity=cap)
    _sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    forms = k3_forms_since(k3_0, "serving spill", counts["scatter_dest"])
    check(counts["scatter_dest"] > 0, "kernel scatter_dest was not launched "
          "by the serving spill")
    cpu = spill_scheduler("cpu")
    want = cpu.rebalance(strategy="diff-comm-replayed", slot_capacity=cap)
    check(card.sessions == cpu.sessions, "serving spill: sessions differ "
          "between cuda and cpu")
    for key in ("deferred_sessions", "moved_sessions", "moved_kv_bytes"):
        check(got[key] == want[key], f"serving spill: {key} {got[key]} on "
              f"cuda, {want[key]} on cpu")
    check(want["deferred_sessions"] > 0, "serving spill: no move deferred")
    own = spill_scheduler("cpu")
    own_info = own.rebalance(strategy="diff-comm", slot_capacity=cap)
    print(f"serving spill: {len(cpu.sessions)} sessions on "
          f"{SPILL_SERVE['replicas']} replicas, slot budget {cap}: moved "
          f"{got['moved_sessions']}, deferred {got['deferred_sessions']}, "
          f"{got['moved_kv_bytes']:.0f} KV bytes, equal to the cpu on the "
          f"card's plan (the cpu's own plan: moved "
          f"{own_info['moved_sessions']}, deferred "
          f"{own_info['deferred_sessions']}); rebalance {wall:.3f} s on the "
          f"card; K3 forms {forms}; launches {counts}")
    return counts


def spill_case(P, n, seed):
    """Owners of ``n`` items on ``P`` nodes in slab order, half of them
    moving to the first half of the nodes, and a budget of 1.25 n / P."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    old = torch.as_tensor((np.arange(n) * P) // n, dtype=torch.int32)
    new = torch.where(torch.as_tensor(rng.random(n) < 0.5),
                      torch.as_tensor(rng.integers(0, P // 2, n),
                                      dtype=torch.int32), old)
    return old, new, int(1.25 * n / P)


def argsort_ranks(keys):
    """Stable within-key ranks by an independent route: a stable argsort,
    rank = position - the key's first position."""
    import torch

    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.empty_like(keys)
    rank[order] = (torch.arange(keys.shape[0], device=keys.device)
                   - first).to(keys.dtype)
    return rank


def spill_sizes():
    """spill_owner on the card past 32 nodes: at 64 nodes over 2^18 items
    against the CPU (the plain version), and at 64 and 257 nodes over 2^20
    items against an argsort oracle; returns the times by node count."""
    import torch
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.runtime import migrate as rt

    P, n = SPILL_CPU
    old, new, cap = spill_case(P, n, 3)
    t0 = time.perf_counter()
    want = rt.spill_owner(old, new, num_nodes=P, capacity=cap)
    cpu_s = time.perf_counter() - t0
    got = rt.spill_owner(old.to(DEV), new.to(DEV), num_nodes=P, capacity=cap)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          f"spill_owner at {P} nodes over {n} items: cuda differs from cpu")
    print(f"spill_owner at {P} nodes over {n} items: cuda == cpu "
          f"({int(want[1].sum())} deferred; the cpu's plain version "
          f"{cpu_s:.1f} s)")
    out = {}
    for P, n in SPILL_SIZES:
        old, new, cap = (t.to(DEV) if isinstance(t, torch.Tensor) else t
                         for t in spill_case(P, n, P))
        C = P * P
        keys = torch.where(new != old, old * P + new, C)
        rank, counts = mops.bucket_ranks(keys, C=C)
        want_rank = argsort_ranks(keys)
        check(torch.equal(torch.where(keys < C, want_rank, -1), rank),
              f"bucket_ranks over {C} buckets: differs from the argsort "
              "oracle")
        eff, deferred = rt.spill_owner(old, new, num_nodes=P, capacity=cap)
        # the oracle: the same admissions from the argsort ranks
        F = torch.bincount(keys[keys < C], minlength=C).reshape(P, P)
        A = rt.spill_admissions(F, torch.bincount(old, minlength=P), cap)
        quota = A.reshape(-1)[keys.clamp(0, C - 1).long()]
        admitted = (keys < C) & (want_rank < quota)
        want_def = (keys < C) & ~admitted
        check(torch.equal(deferred, want_def) and torch.equal(
            eff, torch.where(want_def, old, new)),
            f"spill_owner at {P} nodes: differs from the argsort oracle")
        form = mops.scatter_form(n, C)
        ms = time_ms(lambda: rt.spill_owner(old, new, num_nodes=P,
                                            capacity=cap), reps=5)
        rk = time_ms(lambda: mops.bucket_ranks(keys, C=C), reps=10)
        out[P] = dict(n=n, C=C, form=form, deferred=int(deferred.sum()),
                      spill_ms=ms, bucket_ranks_ms=rk)
        print(f"spill_owner at {P} nodes over {n} items ({C} pair buckets, "
              f"{form} form): equal to the argsort oracle, "
              f"{int(deferred.sum())} deferred; {ms:.4f} ms a call, its "
              f"ranks {rk:.4f} ms")
    return out


# ------------------------------------------------- serving fleet replay --


def fleet_path():
    """The serving fleet replay at full size (launch counts set to 0 just
    before and read just after), its invariants, its device idle share
    (a second run under the profiler), its telemetry run and trace;
    returns the launch counts of the first run."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.serve import replay as sr

    w = sr.ServeWorkload(**FLEET)
    S, R, T = FLEET["num_sessions"], FLEET["num_replicas"], \
        FLEET_RUN["steps"]
    sr.run_serve_replay(w, **dict(FLEET_RUN, steps=min(11, T)),
                        device=DEV)                          # warm-up
    _sync()
    kernels.reset_launch_counts()
    k1_0, k3_0 = dict(dops.form_launches), dict(mops.form_launches)
    k4_0 = dict(hops.form_launches)
    t0 = time.perf_counter()
    res = sr.run_serve_replay(w, **FLEET_RUN, device=DEV)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    K4_PATH_FORMS["fleet"] = {f: n - k4_0[f]
                              for f, n in hops.form_launches.items()}
    k3_forms_since(k3_0, "fleet", counts["scatter_dest"])
    if "diffusion_nsweeps" in FLEET_KERNELS:
        k1_forms_since(k1_0, "fleet", R, min(4, R - 1),
                       counts["diffusion_nsweeps"])
    for name in FLEET_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "fleet path")
    check(res.scanned, "the fleet did not take the device-resident loop")
    fired = np.flatnonzero(res.lb_fired).tolist()
    want = [t for t in range(1, T) if t % FLEET_RUN["lb_every"] == 0]
    check(fired == want and len(fired) > 0,
          f"fleet fired at ticks {fired}, not {want}")
    check(np.isfinite(res.max_avg).all() and np.isfinite(
        res.prefix_local).all(), "fleet: non-finite max/avg")
    check(res.total_moved_kv > 0 and res.moved_sessions.sum() > 0,
          "fleet: no exchange moved a session")
    # sessions conserved: the slots hold a permutation of the fleet
    check(np.array_equal(np.sort(res.final_uid), np.arange(S)),
          "fleet: sessions not conserved")
    # KV conserved: each session's final KV is its initial KV plus its
    # decode growth, added in the same order (exchanges add nothing)
    uid = torch.arange(S, dtype=torch.int32, device=DEV)
    kv = w.kv0_of(uid)
    for t in range(T):
        kv = kv + w.kv_per_token * w.loads_at(t, uid)
    kv_by_uid = np.empty(S, np.float32)
    kv_by_uid[res.final_uid] = res.final_kv
    check(np.array_equal(kv_by_uid, kv.cpu().numpy()),
          "fleet: KV bytes not conserved across the exchanges")
    p95 = float(np.percentile(res.max_avg, 95))
    print(f"fleet path: {S} sessions on {R} replicas, {T} ticks in "
          f"{wall:.3f} s end to end ({res.wall_seconds:.3f} s tick loop, "
          f"{S * T / res.wall_seconds:.6g} session-ticks/s); fired at "
          f"{fired}, moved {int(res.moved_sessions.sum())} sessions and "
          f"{res.total_moved_kv:.1f} KV bytes, p95 max/avg {p95:.6f}, mean "
          f"prefix-local {res.prefix_local.mean():.6f}; launches {counts}; "
          f"K3 forms {K3_PATH_FORMS['fleet']}, K4 forms "
          f"{K4_PATH_FORMS['fleet']}")
    if DEV == "cuda":
        from benchmarks_torch.serve_replay_profile import profile_replay

        _, prof = profile_replay(
            lambda: sr.run_serve_replay(w, **FLEET_RUN, device=DEV))
        top = ", ".join(f"{r['name'][:40]} {r['device_ms']:.3f} ms "
                        f"x{r['count']}" for r in prof["kernels"][:8])
        print(f"fleet path under the profiler: tick loop "
              f"{prof['loop_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle share "
              f"{prof['idle_share']:.4f}; top device time: {top}")
    fleet_telemetry(w, res)
    RESULTS["fleet"] = res
    return counts


def fleet_telemetry(w, off):
    """The fleet again with ``telemetry="full"`` under a slot budget: its
    records agree with its own result arrays, its Chrome trace passes the
    port's checker; its wall time beside the ``off`` run's."""
    import json as _json

    import numpy as np
    from repro_torch.obs import trace_export
    from repro_torch.serve import replay as sr

    T, R = FLEET_RUN["steps"], FLEET["num_replicas"]
    res = sr.run_serve_replay(w, **FLEET_RUN, device=DEV, telemetry="full",
                              slot_capacity=FLEET_TEL_CAPACITY)
    snap = res.telemetry
    check(snap is not None and snap.steps_total == T and snap.dropped == 0,
          "fleet telemetry: not one record a tick")
    check(res.occ_max.max() <= FLEET_TEL_CAPACITY,
          "fleet telemetry: a replica above its slot budget")
    check(np.array_equal(np.sort(res.final_uid),
                         np.arange(FLEET["num_sessions"])),
          "fleet telemetry: sessions not conserved")
    for col, arr in (("t", np.arange(T)), ("fired", res.lb_fired),
                     ("moved_items", res.moved_sessions),
                     ("moved_bytes", res.moved_kv_bytes),
                     ("deferred", res.deferred)):
        check(np.array_equal(snap.column(col),
                             np.asarray(arr, np.float32)),
              f"fleet telemetry: record {col} disagrees with the result")
    check(snap.node_loads.shape == (T, R), "fleet telemetry: lane shape")
    check(np.allclose(snap.node_loads.mean(axis=1), snap.column("avg_load"),
                      rtol=1e-5), "fleet telemetry: lanes and avg disagree")
    trace = trace_export.export_chrome_trace(snap, label="serve-replay")
    errs = trace_export.validate_chrome_trace(trace)
    errs += trace_export.validate_chrome_trace(
        _json.loads(_json.dumps(trace)))
    check(not errs, f"fleet telemetry: trace invalid: {errs[:3]}")
    print(f"fleet telemetry (full, slot_capacity {FLEET_TEL_CAPACITY}): "
          f"tick loop {res.wall_seconds:.3f} s against {off.wall_seconds:.3f}"
          f" s off; fired {int(res.lb_fired.sum())}, deferred "
          f"{int(res.deferred.sum())}, max occupancy "
          f"{int(res.occ_max.max())}; trace of "
          f"{len(trace['traceEvents'])} events valid")


def serve_bench_gates():
    """The serve bench's gated comparison on the card: diff-comm +
    predictive no worse than greedy + every in p95 max/avg and moved KV on
    both workloads (serve_bench asserts both gates)."""
    from benchmarks_torch import serve_bench

    out = {}
    t0 = time.perf_counter()
    serve_bench.bench_policies(out, device=DEV, repeats=1, **SERVE_BENCH)
    for wname, e in out["workloads"].items():
        check(all(e["gates"].values()), f"serve bench {wname}: gates "
              f"{e['gates']}")
    print(f"serve bench gates hold on {sorted(out['workloads'])} in "
          f"{time.perf_counter() - t0:.3f} s")


def fleet_cpu_parity():
    """A 4096-session fleet under diff-comm+predictive (the serve bench's
    cost model, which fires about every other tick) and a slot budget on
    the card equals the same fleet on the CPU: fire steps, placements,
    moved sessions, deferred counts and moved KV."""
    import numpy as np
    from benchmarks_torch import serve_bench
    from repro_torch.serve import replay as sr

    cfg = dict(FLEET_CPU)
    w = sr.ServeWorkload(num_sessions=cfg.pop("num_sessions"),
                         num_replicas=cfg.pop("num_replicas"))
    kw = dict(cfg, lb_every=10,
              **serve_bench.policies()["diff-comm+predictive"])
    g = sr.run_serve_replay(w, **kw, device=DEV)
    c = sr.run_serve_replay(w, **kw, device="cpu")
    check(g.lb_fired.sum() > 0, "fleet on the card vs the CPU: no fire")
    for f in ("lb_fired", "final_replica_by_uid", "moved_sessions",
              "deferred", "moved_kv_bytes", "occ_max"):
        check(np.array_equal(getattr(g, f), getattr(c, f)),
              f"fleet: {f} differs between {DEV} and cpu")
    err = float(np.abs(g.max_avg - c.max_avg).max())
    check(err <= 1e-6 * float(np.abs(c.max_avg).max()),
          f"fleet: max/avg differs by {err}")
    print(f"fleet of {w.num_sessions} sessions on {DEV} == cpu: fired "
          f"{int(g.lb_fired.sum())} times at "
          f"{np.flatnonzero(g.lb_fired).tolist()}, moved "
          f"{g.total_moved_kv:.1f} KV bytes (equal), deferred "
          f"{int(g.deferred.sum())}, max/avg within {err:.3g}")


def two_level(snap):
    """Two-level placement: LPT threads of the simulator snapshot on the
    card equal the host oracle; the simulator replay and a small PIC run
    record thread max/avg (the PIC run's equal on the card and the CPU)."""
    import numpy as np
    import torch
    from repro_torch.core import hierarchical
    from repro_torch.pic import driver
    from repro_torch.sim import scenarios, simulator

    P = snap.num_nodes
    _sync()
    t0 = time.perf_counter()
    thr = hierarchical.lpt_threads(snap.loads, snap.assignment,
                                   num_nodes=P, threads_per_node=HIER_T)
    tl = hierarchical.thread_loads(snap.loads, snap.assignment, thr,
                                   num_nodes=P, threads_per_node=HIER_T)
    _sync()
    ms = 1e3 * (time.perf_counter() - t0)
    loads = snap.loads.cpu().numpy().astype(np.float32)
    a = snap.assignment.cpu().numpy()
    want = hierarchical.within_node_lpt(loads, a, P, HIER_T)
    check(np.array_equal(thr.cpu().numpy(), want),
          "lpt_threads on the card differs from the host oracle")
    want_tl = np.zeros(P * HIER_T, np.float32)
    np.add.at(want_tl, a * HIER_T + want, loads)
    check(np.array_equal(tl.cpu().numpy(), want_tl),
          "thread loads on the card differ from the host oracle's")
    depth = int(np.bincount(a, minlength=P).max())
    print(f"two-level placement: lpt_threads over {a.shape[0]} objects, {P}"
          f" nodes x {HIER_T} threads in {ms:.3f} ms (loop depth {depth}) "
          "== the host oracle, thread loads equal")
    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device=DEV, **SIM_SCENARIO)
    res = simulator.run_series(problem, evolve, threads_per_node=HIER_T,
                               **HIER_SIM)
    tma = res.thread_max_avg
    check(tma is not None and tma.shape == (HIER_SIM["steps"],)
          and np.isfinite(tma).all() and (tma >= 1.0 - 1e-5).all(),
          f"run_series thread_max_avg {tma}")
    g = driver.run(driver.PICConfig(**HIER_PIC, device=DEV))
    c = driver.run(driver.PICConfig(**HIER_PIC, device="cpu"))
    check(np.array_equal(g.thread_max_avg, c.thread_max_avg),
          "PIC thread_max_avg differs between the card and the CPU")
    print(f"two-level replay: {res.wall_seconds:.3f} s for "
          f"{HIER_SIM['steps']} steps, thread max/avg "
          f"{float(tma.min()):.6f}..{float(tma.max()):.6f}; small PIC run "
          f"thread max/avg on {DEV} == cpu (mean "
          f"{float(g.thread_max_avg.mean()):.6f})")



def flash_row(counts):
    """K6 against its plain version (the model's chunked attention) at the
    serving path's shapes, each case in the form ``flash_form`` names; the
    row's times are those of the full-width prefill against the global
    cache, and its ``decode_*`` times those of the decode tick's global
    layers, L2-hot (one cache) and cold (one cache a layer, rotated);
    ``decode_f32_cache_ms`` is that decode over an f32 cache (the serving
    engine's default type) with the bf16 model's q."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (POS_SENTINEL,
                                                         chunked_attention,
                                                         mask)

    dev, KV, G, hd, W = "cuda", 1, 4, 288, 1024
    gen = torch.Generator(dev).manual_seed(0)

    def positions(B, Sq, T, q_last, ring):
        """Query positions ending at ``q_last`` (B,), and the cache's slot
        positions after writing 0..q_last: slot ``p mod T`` for a ring,
        else slot p; unwritten slots hold the sentinel."""
        last = q_last[:, None]
        qp = last - torch.arange(Sq - 1, -1, -1, device=dev)
        s = torch.arange(T, device=dev)[None]
        # a ring's slot s holds the latest position p <= q_last, p = s mod T
        kp = s + (last - s).div(T, rounding_mode="floor") * T if ring else s
        kp = torch.where(s <= last, kp, POS_SENTINEL)
        return qp.to(torch.int32), kp.to(torch.int32).contiguous()

    def within(got, want, tol, label):
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash_attention ({label}): max_abs_err {err} beyond "
              f"{tol} abs + {tol} rel")
        return err

    def sdpa(q, k, v, qp, kp, win):
        # yardstick: one SDPA call on the same inputs (GQA expanded, the
        # position mask as a boolean mask; q in the cache's type, which
        # SDPA needs); timed here only
        B, Sq, KV, G, hd = q.shape
        qs = q.to(k.dtype).reshape(B, Sq, KV * G, hd).transpose(1, 2)
        qs = qs.contiguous()
        ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        am = mask(qp, kp, win, 0)[:, None].contiguous()
        return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=am)

    def bound(q, k, qp, kp, win):
        B, Sq, KV, G, hd = q.shape
        allowed = mask(qp, kp, win, 0)                       # (B, Sq, T)
        nbytes = (2 * q.numel() * q.element_size()
                  + 4 * (qp.numel() + kp.numel())
                  + 2 * int(allowed.any(1).sum()) * KV * hd
                  * k.element_size())
        flops = 4 * hd * G * KV * int(allowed.sum())
        return bound_ms(nbytes, flops, PEAK_BF16_PER_S
                        if q.dtype == k.dtype == torch.bfloat16
                        else PEAK_F32_PER_S)

    bf16, f32 = torch.bfloat16, torch.float32
    tick = [1030, 1026, 543, 607]
    gemma = (KV, G, hd)
    # MLA's latent attention at deepseek-v3's width: one "kv head" of 128
    # query heads at kv_lora 512 + rope 64, values [ckv | 0]; the phase 13
    # serving shapes (prompts up to 512, a 536-slot cache)
    mla = (1, 128, 576)
    mla_tick = [527, 460, 372, 280]
    cases = [  # label, (KV, G, hd), B, Sq, T, window, q_last, q, cache type
        ("prefill, global cache", gemma, 1, 1000, 1056, 0, [999], bf16, bf16),
        ("prefill, window ring", gemma, 1, 1000, W, W, [999], bf16, bf16),
        ("decode, global cache", gemma, 4, 1, 1056, 0, tick, bf16, bf16),
        ("decode, wrapped window ring", gemma, 4, 1, W, W, tick, bf16, bf16),
        ("prefill, global cache, f32", gemma, 1, 1000, 1056, 0, [999], f32,
         f32),
        ("decode, global cache, f32 cache", gemma, 4, 1, 1056, 0, tick, bf16,
         f32),
        ("MLA decode", mla, 4, 1, 536, 0, mla_tick, bf16, bf16),
        ("MLA prefill", mla, 1, 512, 536, 0, [511], bf16, bf16),
    ]
    errs, res = [], {}
    for label, (KV, G, hd), B, Sq, T, win, q_last, dt, kdt in cases:
        q = torch.randn((B, Sq, KV, G, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(kdt)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(kdt)
        if label.startswith("MLA"):
            v = torch.cat([k[..., :512], torch.zeros_like(k[..., 512:])], -1)
        qp, kp = positions(B, Sq, T, torch.tensor(q_last, device=dev),
                           ring=bool(win))
        form = fops.flash_form(B, Sq, T, KV, G, hd, dt, kdt)
        before = fops.form_launches[form]
        got = fops.flash_attention(q, k, v, qp, kp, window=win)
        check(fops.form_launches[form] == before + 1,
              f"flash_attention ({label}) did not take the {form} form")
        check(torch.equal(got, fops.flash_attention(q, k, v, qp, kp,
                                                    window=win)),
              f"flash_attention ({label}): two calls differ")
        want = chunked_attention(q, k, v, qp, kp, window=win)
        torch.cuda.synchronize()
        tol = 2e-2 if bf16 in (dt, kdt) else 2e-3
        err = within(got, want, tol, label)
        errs.append(err)
        ms = time_ms(lambda: fops.flash_attention(q, k, v, qp, kp,
                                                  window=win))
        plain = time_ms(lambda: chunked_attention(q, k, v, qp, kp,
                                                  window=win))
        lib = time_ms(sdpa(q, k, v, qp, kp, win))
        bd = bound(q, k, qp, kp, win)
        print(f"flash_attention ({label}: B={B}, Sq={Sq}, T={T}, KV={KV}, "
              f"G={G}, hd={hd}, window={win}, q {str(dt)[6:]}, cache "
              f"{str(kdt)[6:]}; {form} form): "
              f"max_abs_err {err:.6g} (tolerance {tol}), kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
              f"{bd[0]:.6f} ms ({bd[1]})")
        res[label] = (ms, plain, bd, lib, (q, qp, kp))
        if label.startswith("MLA"):
            res[label] += (device_ms(lambda: fops.flash_attention(
                q, k, v, qp, kp, window=win)), form)

    # the decode tick's global layers as the path reads them: one cache a
    # layer (26 x 4.9 MB, past the 50 MB L2), rotated from call to call
    KV, G, hd = gemma
    q, qp, kp = res["decode, global cache"][4]
    n_layers = 26
    caches = [tuple(torch.randn((4, 1056, KV, hd), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2)) for _ in range(n_layers)]
    for i in (0, n_layers - 1):
        errs.append(within(fops.flash_attention(q, *caches[i], qp, kp),
                           chunked_attention(q, *caches[i], qp, kp), 2e-2,
                           "decode, cold L2"))
    turn = iter(range(10 ** 9))
    cold = time_ms(lambda: fops.flash_attention(
        q, *caches[next(turn) % n_layers], qp, kp), reps=2 * n_layers)
    lib_fns = [sdpa(q, *c, qp, kp, 0) for c in caches]
    turn = iter(range(10 ** 9))
    lib_cold = time_ms(lambda: lib_fns[next(turn) % n_layers](),
                       reps=2 * n_layers)
    d_ms, _, d_bound, d_lib, _ = res["decode, global cache"]
    print(f"flash_attention (decode, cold L2: {n_layers} caches of "
          f"(4, 1056, 1, 288) bf16, rotated; split form of "
          f"{fops.split_keys(4, KV, 1056)} keys a split): kernel "
          f"{cold:.4f} ms against L2-hot {d_ms:.4f} ms and its bound "
          f"{d_bound[0]:.6f} ms ({d_bound[1]}); SDPA cold {lib_cold:.4f} "
          f"ms, hot {d_lib:.4f} ms")
    p_ms, p_plain, p_bound, p_lib, _ = res["prefill, global cache"]
    for what, mine, lib in (("prefill", p_ms, p_lib), ("decode", d_ms, d_lib)):
        print(f"flash_attention {what} at the serving path's shape: kernel "
              f"{mine:.4f} ms, SDPA {lib:.4f} ms "
              f"({'no slower' if mine <= lib else 'SLOWER'} than SDPA)")
    mla_keys = {}
    for what in ("decode", "prefill"):
        ms, plain, bd, lib, _, dms, form = res[f"MLA {what}"]
        mla_keys.update({f"mla_{what}_ms": ms, f"mla_{what}_device_ms": dms,
                         f"mla_{what}_plain_ms": plain,
                         f"mla_{what}_bound_ms": bd[0],
                         f"mla_{what}_bound_by": bd[1],
                         f"mla_{what}_library_ms": lib,
                         f"mla_{what}_form": form})
        print(f"flash_attention MLA {what} (G=128, hd=576, {form} form): "
              f"kernel {ms:.4f} ms (device {dms:.4f} ms a call), plain "
              f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bd[0]:.6f} ms "
              f"({bd[1]}) [{SMI}]")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:96",
                launches=counts["flash_attention"], max_abs_err=max(errs),
                ms=p_ms, plain_ms=p_plain, bound_ms=p_bound[0],
                bound_by=p_bound[1], library_ms=p_lib, decode_ms=d_ms,
                decode_cold_ms=cold, decode_bound_ms=d_bound[0],
                decode_library_ms=d_lib,
                decode_f32_cache_ms=res["decode, global cache, f32 cache"][0],
                **mla_keys)


def flash_bwd_row(counts):
    """K6's backward against its plain version (the autograd of the
    model's chunked attention, on the inputs upcast to f32) at the training
    path's shape — phase 15 (a)'s smollm-135m attention call (B 8, S 2048,
    KV 3, G 3, hd 64, bf16, causal) — and at B 2, a window, a prefix-LM
    and the reduced MLA shape: the form ``bwd_form`` names (the mma form at
    every bf16 case), the error (bf16 within 2e-2 of each gradient's
    largest magnitude, f32 within 1e-4), two calls equal bit for bit, and
    the main case's time beside its bound, the plain version's, SDPA's
    backward and the simt form's (reached through ``_launch_bwd``, its
    gradients held to the mma form's within 2e-2).  Each case's forward
    output, which the
    backward reads, is held to the plain chunked attention as in
    :func:`flash_row` (2e-2 abs + rel for bf16, 2e-3 for f32); at the main
    case the forward's time, bound, plain and SDPA times go under
    ``"training_forward"``, for K6's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         chunked_attention,
                                                         mask)

    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    main_label = "smollm-135m training step, causal"
    cases = [  # label, B, S, KV, G, hd, window, prefix, type
        (main_label, TRAIN["global_batch"], TRAIN["seq_len"], 3, 3, 64, 0, 0,
         bf16),
        ("B 2, causal", 2, 2048, 3, 3, 64, 0, 0, bf16),
        ("window 512", 2, 2048, 3, 3, 64, 512, 0, bf16),
        ("prefix-LM 256", 1, 1024, 3, 3, 64, 0, 256, bf16),
        ("reduced MLA latents", 4, 64, 1, 4, 24, 0, 0, f32),
    ]

    def sdpa_parts(q, k, v, do):
        # yardstick: SDPA at the same shape (GQA expanded, causal), timed
        # here only
        B, S, KV, G, hd = q.shape
        qs = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        ks = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
        gy = do.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        return qs, ks, vs, gy

    errs, res, fwd = [], {}, {}
    for label, B, S, KV, G, hd, win, pre, dt in cases:
        q = torch.randn((B, S, KV, G, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dt)
        do = torch.randn((B, S, KV, G, hd), generator=gen,
                         device=dev).to(dt)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
            B, S).contiguous()
        kw = dict(window=win, prefix_len=pre)
        form = fops.flash_form(B, S, S, KV, G, hd, dt, dt)
        before = fops.form_launches[form]
        o = fops.flash_attention(q, k, v, pos, pos, **kw)
        check(fops.form_launches[form] == before + 1,
              f"flash_attention ({label}) did not take the {form} form")
        o_want = chunked_attention(q, k, v, pos, pos, **kw)
        ftol = 2e-2 if dt == bf16 else 2e-3
        o_diff = (o.float() - o_want.float()).abs()
        o_err = float(o_diff.max())
        check(bool((o_diff <= ftol + ftol * o_want.float().abs()).all()),
              f"flash_attention ({label}): forward max_abs_err {o_err} "
              f"beyond {ftol} abs + {ftol} rel")
        bform = fops.bwd_form(B, S, S, KV, G, hd, dt, dt)
        check(bform == ("mma" if dt == bf16 else "simt"),
              f"flash_attention_bwd ({label}): bwd_form names {bform}")
        before = fops.bwd_form_launches[bform]
        got = fops.flash_attention_bwd(q, k, v, pos, pos, o, do, **kw)
        check(fops.bwd_form_launches[bform] == before + 1,
              f"flash_attention_bwd ({label}) did not take the {bform} "
              "form")
        check(all(torch.equal(a, b) for a, b in zip(got, fops.
              flash_attention_bwd(q, k, v, pos, pos, o, do, **kw))),
              f"flash_attention_bwd ({label}): two calls differ")
        want = attention_bwd_ref(q.float(), k.float(), v.float(), pos, pos,
                                 do.float(), **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if dt == bf16 else 1e-4
        err = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            e = float((a.float() - b).abs().max())
            check(e <= tol * float(b.abs().max()),
                  f"flash_attention_bwd ({label}): {name} {e} beyond "
                  f"{tol} of its largest magnitude {float(b.abs().max())}")
            err = max(err, e)
        errs.append(err)
        del want, o_want, o_diff
        allowed = int(mask(pos[0], pos[0], win, pre).sum()) * B
        # read q, k, v, o, do and the positions once; write dq, dk, dv
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (q, k, v, o, do, q, k, v))
                  + 2 * 4 * pos.numel())
        # 5 products of 2 hd flops per allowed (pair, key): 2.5 x the
        # forward's 2 (scores, PV)
        flops = 2.5 * 4 * hd * G * KV * allowed
        peak = PEAK_BF16_PER_S if dt == bf16 else PEAK_F32_PER_S
        bd = bound_ms(nbytes, flops, peak)
        ms = time_ms(lambda: fops.flash_attention_bwd(q, k, v, pos, pos, o,
                                                      do, **kw), reps=10)
        res[label] = dict(err=err, ms=ms, bound=bd, forward_err=o_err)
        line = (f"flash_attention_bwd ({label}: B={B}, S={S}, KV={KV}, "
                f"G={G}, hd={hd}, window={win}, prefix={pre}, "
                f"{str(dt)[6:]}): forward ({form} form) max_abs_err "
                f"{o_err:.6g} (tolerance {ftol} abs + rel); backward "
                f"({bform} form) max_abs_err {err:.6g} (tolerance {tol} "
                f"of each gradient's largest magnitude), two calls equal "
                f"bit for bit, kernel {ms:.4f} ms, bound {bd[0]:.6f} ms "
                f"({bd[1]})")
        if label == main_label:
            plain = time_ms(lambda: attention_bwd_ref(
                q, k, v, pos, pos, do, **kw), reps=3)
            qs, ks, vs, gy = sdpa_parts(q, k, v, do)
            leaves = [t.requires_grad_() for t in (qs, ks, vs)]
            y = F.scaled_dot_product_attention(*leaves, is_causal=True)
            lib = time_ms(lambda: torch.autograd.grad(
                y, leaves, gy, retain_graph=True), reps=10)
            # the simt form at the same inputs: held to the mma form's
            # gradients, and timed beside it
            simt = fops._launch_bwd(q, k, v, pos, pos, o, do, win, pre,
                                    "simt")
            torch.cuda.synchronize()
            simt_err = 0.0
            for name, a, b in zip(("dq", "dk", "dv"), got, simt):
                e = float((a.float() - b.float()).abs().max())
                check(e <= 2e-2 * float(b.float().abs().max()),
                      f"flash_attention_bwd ({label}): mma and simt forms' "
                      f"{name} differ by {e}")
                simt_err = max(simt_err, e)
            del simt
            simt_ms = time_ms(lambda: fops._launch_bwd(
                q, k, v, pos, pos, o, do, win, pre, "simt"), reps=3)
            res[label].update(plain=plain, lib=lib, simt_ms=simt_ms,
                              simt_err=simt_err)
            line += (f", plain {plain:.4f} ms, SDPA backward {lib:.4f} ms, "
                     f"simt form {simt_ms:.4f} ms (max_abs_err "
                     f"{simt_err:.6g} against the mma form)")
            # the forward at this shape: read q, k, v and the positions,
            # write o; 2 products of 2 hd flops per allowed (pair, key)
            f_bd = bound_ms(
                sum(t.numel() * t.element_size() for t in (q, k, v, o))
                + 2 * 4 * pos.numel(), 4 * hd * G * KV * allowed, peak)
            f_ms = time_ms(lambda: fops.flash_attention(q, k, v, pos, pos,
                                                        **kw))
            f_plain = time_ms(lambda: chunked_attention(q, k, v, pos, pos,
                                                        **kw), reps=3)
            with torch.no_grad():
                f_lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True))
            fwd = dict(shape=[B, S, KV, G, hd], form=form,
                       max_abs_err=o_err, ms=f_ms, plain_ms=f_plain,
                       bound_ms=f_bd[0], bound_by=f_bd[1],
                       library_ms=f_lib)
            print(f"flash_attention ({label}: B={B}, S={S}, KV={KV}, "
                  f"G={G}, hd={hd}, bf16; {form} form): forward kernel "
                  f"{f_ms:.4f} ms, plain {f_plain:.4f} ms, SDPA "
                  f"{f_lib:.4f} ms, bound {f_bd[0]:.6f} ms ({f_bd[1]}) "
                  f"[{SMI}]")
            del leaves, y, qs, ks, vs, gy
        print(line + f" [{SMI}]")
        del q, k, v, do, o, got
    main = res[main_label]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:96",
                launches=counts["flash_attention_bwd"],
                max_abs_err=max(errs), ms=main["ms"],
                plain_ms=main["plain"], bound_ms=main["bound"][0],
                bound_by=main["bound"][1], library_ms=main["lib"],
                form="mma", simt_ms=main["simt_ms"],
                simt_max_abs_diff=main["simt_err"],
                cases={lbl: dict(ms=r["ms"], max_abs_err=r["err"],
                                 forward_max_abs_err=r["forward_err"],
                                 bound_ms=r["bound"][0])
                       for lbl, r in res.items()},
                launches_by_path={f"training {p}": n["flash_attention_bwd"]
                                  for p, n in TRAIN_LAUNCHES.items()
                                  if n["flash_attention_bwd"]},
                training_forward=fwd)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn()`` per call, the launch gaps between its
    kernels included: CUDA events around ``reps`` calls issued behind a
    queued sleep kernel, so that the card never waits on the host between
    them; fails if the host had not issued them all before the sleep
    ended.  (``torch.profiler`` records only part of the runs late in this
    process, and at times none.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    issue_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e6 cycles are at least 1 ms at the card's clock (at most 1.98 GHz)
    torch.cuda._sleep(int(2e6 * (20 + 3 * reps * issue_ms)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    behind = not start.query()
    torch.cuda.synchronize()
    check(behind, f"device_ms: the sleep ended before the host had issued "
          f"{reps} calls ({issue_ms:.3f} ms each to issue)")
    return start.elapsed_time(end) / reps


# ------------------------------------------------- other model families --


def frontend_batch(cfg, B, S, seed, dev):
    """A prefill batch of S positions for ``cfg``'s frontend: token ids,
    audio frame embeddings (every position), or the vision prefix's patch
    embeddings before S - vision_prefix text tokens; seeded on ``dev``."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    batch = dict(positions=pos.contiguous(), tokens=None)
    n_tok = S
    if cfg.frontend != "none":
        n_emb = S if cfg.frontend == "audio_stub" else cfg.vision_prefix
        batch["embeds"] = torch.randn((B, n_emb, cfg.d_model), generator=gen,
                                      device=dev)
        n_tok = S - n_emb
    if n_tok:
        batch["tokens"] = torch.randint(1, cfg.vocab_size, (B, n_tok),
                                        generator=gen, device=dev)
    return batch


def family_config(arch, spec):
    """The published config with its depth cut and parameter type (a
    rehearsal: the reduced config as it is)."""
    import dataclasses

    from repro_torch.configs import get_arch

    if not FAM_FULL:
        return get_arch(arch).reduced
    cfg = get_arch(arch).config
    return dataclasses.replace(cfg, param_dtype=spec["dtype"],
                               **(spec["cut"] or {}))


def attention_shape(cfg):
    """(KV, G, hd) of the model's calls of K6: MLA is one latent "kv head"
    of all heads at kv_lora + rope."""
    if cfg.attention == "mla":
        return 1, cfg.num_heads, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    return cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.hd


def expected_forms(cfg, calls, cache_dtype):
    """K6's launches by form, and their number, for forward calls of
    ``calls`` = [(batch rows, query rows), ...]: each attention layer once
    a call, in the form ``flash_form`` names."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer

    want = {f: 0 for f in fops.FORMS}
    if "flash_attention" not in FAM_KERNELS:
        return want, 0
    n_attn = sum(k not in transformer.XLSTM_KINDS for k in cfg.all_layers())
    KV, G, hd = attention_shape(cfg)
    q_dt = transformer.as_dtype(cfg.compute_dtype)
    kv_dt = transformer.as_dtype(cache_dtype)
    for B, Sq in calls:
        want[fops.flash_form(B, Sq, 0, KV, G, hd, q_dt, kv_dt)] += n_attn
    return want, n_attn * len(calls)


def param_gib(params) -> float:
    from repro_torch.models.params import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(params)) / 2 ** 30


def _peak_gib():
    import torch

    return (torch.cuda.max_memory_allocated() / 2 ** 30 if DEV == "cuda"
            else float("nan"))


def _reset_peak():
    import gc

    import torch

    gc.collect()        # an instrumented engine is a reference cycle
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def family_serve(arch):
    """One ``ServeEngine`` (FAM_SLOTS slots, bf16 cache) serving the
    arch's requests at its published width; launch counts set to 0 just
    before and read just after; returns its numbers."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    spec = FAM_SERVE[arch]
    cfg = family_config(arch, spec)
    lens, new = spec["prompt_lens"], spec["max_new"]
    specs = transformer.model_specs(cfg)
    _reset_peak()
    _sync()
    t0 = time.perf_counter()
    params = init_params(specs, 0, device=DEV)
    _sync()
    init_s = time.perf_counter() - t0
    init_peak = _peak_gib()
    params_gib = param_gib(params)
    _reset_peak()
    max_len = max(lens) + new + 8
    e = ServeEngine(cfg, params, ServeConfig(
        num_slots=FAM_SLOTS, max_len=max_len, dtype="bfloat16"), device=DEV)
    prefill_s, tick_s = [], []
    instrument_engine(e, prefill_s, tick_s)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in lens]
    for i, pr in enumerate(prompts):
        e.submit(Request(uid=i, prompt=pr, max_new_tokens=new))
    kernels.reset_launch_counts()
    forms0 = dict(fops.form_launches)
    _sync()
    t0 = time.perf_counter()
    done = e.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    forms = {f: n - forms0[f] for f, n in fops.form_launches.items()}
    check(sorted(r.uid for r in done) == list(range(len(lens))),
          f"{arch}: served {sorted(r.uid for r in done)}")
    check(all(len(r.out) == new for r in done),
          f"{arch}: a request did not get {new} tokens")
    toks = np.concatenate([r.out for r in done])
    check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
          f"{arch}: a token out of the vocabulary")
    want_forms, want_n = expected_forms(
        cfg, [(1, n) for n in lens] + [(FAM_SLOTS, 1)] * e.ticks, "bfloat16")
    check(counts["flash_attention"] == want_n, f"{arch}: flash_attention "
          f"launched {counts['flash_attention']} times, not {want_n}")
    check(forms == want_forms, f"{arch}: K6 forms {forms}, not {want_forms}")
    for name in FAM_KERNELS:
        check(counts[name] > 0 or want_n == 0, f"kernel {name} was not "
              f"launched on {arch}'s path")
    decode_s = sum(tick_s) - sum(prefill_s)
    out = dict(layers=list(cfg.all_layers()), params=count_params(specs),
               param_dtype=cfg.param_dtype, params_gib=params_gib,
               init_peak_gib=init_peak, init_s=init_s, requests=len(lens),
               prompt_lens=list(lens),
               new_tokens=new, ticks=e.ticks, wall_s=wall,
               prefill_ms=[1e3 * t for t in prefill_s],
               decode_ms_per_tick=1e3 * decode_s / max(e.ticks, 1),
               tokens_per_s=len(toks) / wall, peak_gib=_peak_gib(),
               flash_launches=counts["flash_attention"], flash_forms=forms)
    if cfg.moe is not None:
        # the router's statistics over one prompt's prefill: every token
        # picks top_k experts in each MoE layer
        pr = torch.as_tensor(prompts[-1], device=DEV)[None]
        pos = torch.arange(pr.shape[1], dtype=torch.int32, device=DEV)[None]
        h0, _, (_, st) = transformer.forward(
            params, cfg, dict(tokens=pr, positions=pos),
            collect_router_stats=True, with_aux=True)
        n_moe = sum(k.startswith("moe") for k in cfg.all_layers())
        k = cfg.moe.top_k
        want = pr.shape[1] * k * n_moe
        got = float(st.counts.sum())
        check(got == want, f"{arch}: router counts sum to {got}, not "
              f"{want} = tokens x top_k x MoE layers")
        check(float(st.coact.sum()) == want * (k - 1)
              and bool((st.coact == st.coact.T).all())
              and float(st.coact.diagonal().abs().max()) == 0.0,
              f"{arch}: co-activations not symmetric pair counts")
        out["router"] = dict(tokens=int(pr.shape[1]), counts_sum=got,
                             experts_used=int((st.counts > 0).sum()),
                             max_count=float(st.counts.max()))
    if any(k in ("attn_local", "hymba") for k in cfg.all_layers()):
        i = next(i for i, k in enumerate(cfg.all_layers())
                 if k in ("attn_local", "hymba"))
        ring = e.cache[i]["kv"]["pos"]
        out["ring_max_pos"] = int(ring[ring < 2 ** 29].max())
        out["ring_slots"] = int(ring.shape[1])
        if FAM_FULL:
            check(out["ring_max_pos"] >= out["ring_slots"],
                  f"{arch}: no window ring wrapped")
    cut = "whole" if not FAM_FULL or spec["cut"] is None else \
        f"depth cut to {len(cfg.all_layers())} layers {cfg.all_layers()}"
    print(f"{arch} ({cut}; d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{out['params']} parameters in {cfg.param_dtype}, "
          f"{params_gib:.3f} GiB, made in {init_s:.3f} s at a peak of "
          f"{init_peak:.3f} GiB): {len(lens)} "
          f"requests (prompts {list(lens)}, {new} new tokens each) in "
          f"{wall:.3f} s, {e.ticks} ticks; prefill "
          f"{[round(1e3 * t, 3) for t in prefill_s]} ms, decode "
          f"{out['decode_ms_per_tick']:.3f} ms a tick of {FAM_SLOTS} slots; "
          f"peak {out['peak_gib']:.3f} GiB; K6 {counts['flash_attention']} "
          f"launches {forms}"
          + (f"; router counts {out['router']}" if "router" in out else "")
          + (f"; window ring up to position {out['ring_max_pos']} in "
             f"{out['ring_slots']} slots" if "ring_max_pos" in out else "")
          + f" [{SMI}]")
    del e
    if FAM_FULL and arch == EP_ARCH and EP_RELOCATE_RANKS:
        # phase 14 (b): relocate the resident experts by a plan of this
        # prompt's router statistics
        EPB["relocation"] = ep_relocation(cfg, params, pr, pos, h0, st)
    del params
    return out


def family_steps(arch):
    """``prefill`` of FAM_STEP_SHAPE's batch (the frontend's embeddings
    where the arch has one) and ``decode_step``s at the published width;
    launch counts set to 0 just before and read just after."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer
    from repro_torch.models.params import count_params, init_params

    spec = FAM_STEP[arch]
    cfg = family_config(arch, spec)
    B, S, steps = (FAM_STEP_SHAPE[k] for k in ("batch", "prompt", "steps"))
    specs = transformer.model_specs(cfg)
    _reset_peak()
    _sync()
    t0 = time.perf_counter()
    params = init_params(specs, 0, device=DEV)
    _sync()
    init_s = time.perf_counter() - t0
    init_peak = _peak_gib()
    params_gib = param_gib(params)
    _reset_peak()
    batch = frontend_batch(cfg, B, S, 0, DEV)
    cache = transformer.init_cache(cfg, B, S + steps + 8, torch.bfloat16,
                                   DEV)
    kernels.reset_launch_counts()
    forms0 = dict(fops.form_launches)
    _sync()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, batch, cache)
    _sync()
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits {tuple(logits.shape)} not finite")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_s = []
    for i in range(steps):
        _sync()
        t = time.perf_counter()
        logits, cache = transformer.decode_step(params, cfg, tok, S + i,
                                                cache)
        _sync()
        step_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()),
              f"{arch}: non-finite logits at decode step {i}")
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"{arch}: a token out of the vocabulary")
    counts = kernels.launch_counts()
    forms = {f: n - forms0[f] for f, n in fops.form_launches.items()}
    want_forms, want_n = expected_forms(cfg, [(B, S)] + [(B, 1)] * steps,
                                        "bfloat16")
    check(counts["flash_attention"] == want_n, f"{arch}: flash_attention "
          f"launched {counts['flash_attention']} times, not {want_n}")
    check(forms == want_forms, f"{arch}: K6 forms {forms}, not {want_forms}")
    out = dict(layers=list(cfg.all_layers()), params=count_params(specs),
               param_dtype=cfg.param_dtype, params_gib=params_gib,
               init_peak_gib=init_peak, init_s=init_s, batch=B, prompt=S,
               frontend=cfg.frontend, prefill_ms=1e3 * prefill_s,
               decode_ms_per_step=1e3 * sum(step_s) / steps,
               peak_gib=_peak_gib(), flash_launches=counts["flash_attention"],
               flash_forms=forms)
    cut = "whole" if not FAM_FULL or spec["cut"] is None else \
        f"depth cut to {len(cfg.all_layers())} layers"
    front = {"none": "tokens", "audio_stub": f"{S} audio frame embeddings",
             "vision_stub": f"{cfg.vision_prefix} vision-prefix embeddings "
             f"(prefix-LM) + {S - cfg.vision_prefix} tokens"}[cfg.frontend]
    print(f"{arch} ({cut}; d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.hd}, {out['params']} parameters "
          f"in {cfg.param_dtype}, {params_gib:.3f} GiB): prefill of {B} x "
          f"{S} ({front}) {out['prefill_ms']:.3f} ms (one call), decode "
          f"{out['decode_ms_per_step']:.3f} ms a step over {steps} steps; "
          f"peak {out['peak_gib']:.3f} GiB; K6 {counts['flash_attention']} "
          f"launches {forms} [{SMI}]")
    del params, cache
    return out


def families_path():
    """Phase 13: the other model families at their published widths, then
    every other reduced config on the card against the CPU."""
    from repro_torch.configs import list_archs

    for arch in FAM_SERVE:
        FAMILIES[arch] = family_serve(arch)
    for arch in FAM_STEP:
        FAMILIES[arch] = family_steps(arch)
    errs = {a: serve_cpu_parity(a) for a in list_archs() if a != SERVE_ARCH}
    FAMILIES["reduced_cuda_vs_cpu_max_logit_err"] = errs
    _reset_peak()
    return {a: FAMILIES[a]["flash_launches"]
            for a in (*FAM_SERVE, *FAM_STEP)}


# ---------------------------------------------------- expert balancing --


EP_FIELDS = ("lb_fired", "max_avg", "moved_experts", "moved_bytes",
             "final_placement", "final_slot_expert", "final_wsig")


def _f32_logits(params, cfg, h):
    """Last-position logits in f32 from the hidden states (the head's
    weights cast to f32: a comparison that bf16 rounding of the logits
    would hide)."""
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return h[:, -1].float() @ w.float()


def _relocate(epr, mops, kernels, E, R, cap, st0, moe_layers, tried):
    """One ``EPRebalancer.step`` at t = 1 (the fixed cadence never fires
    at t = 0) under diff-comm, then ep-greedy where diff-comm moved no
    expert; launch counts set to 0 just before each and read just
    after."""
    import numpy as np

    for strategy in ("diff-comm", "ep-greedy"):
        reb = epr.EPRebalancer(E, R, strategy=strategy, trigger="every",
                               lb_every=1, device=DEV)
        check(np.array_equal(reb.placement, np.arange(E) // cap),
              "relocation: the rebalancer does not start from the block "
              "placement")
        kernels.reset_launch_counts()
        k3_0 = dict(mops.form_launches)
        _reset_peak()
        info0 = _peak_gib()            # what is resident before the step
        _sync()
        t0 = time.perf_counter()
        layers, info = reb.step(1, st0.counts, st0.coact, moe_layers,
                                in_place=True)
        _sync()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        tried[strategy] = int(info.get("moved_experts", 0))
        check(info["fired"], f"relocation ({strategy}): the every trigger "
              "did not fire at t = 1")
        if info["moved_experts"] > 0:
            break
    info["resident_gib"] = info0
    info["slot_expert"] = reb.slot_expert
    info["placement"] = reb.placement
    return layers, info, strategy, wall, counts, k3_0


def ep_relocation(cfg, params, pr, pos, h0, st0):
    """Phase 14 (b): deepseek-v3's resident MoE layer relocated by an
    ``EPRebalancer`` over EP_RELOCATE_RANKS ranks, fed the router's
    statistics of one prompt (physical slots = logical experts at the
    start); the same prompt's forward after the relocation against
    before.  diff-comm plans; where it moves no expert on this snapshot,
    ep-greedy does (recorded)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.models import transformer
    from repro_torch.train import ep_runtime as epr

    E, R = cfg.moe.num_experts, EP_RELOCATE_RANKS
    cap = E // R
    logits0 = _f32_logits(params, cfg, h0)
    moe_layers = [params["layers"][i]["moe"]
                  for i, k in enumerate(cfg.all_layers())
                  if k.startswith("moe")]
    bpe = epr.expert_param_bytes(moe_layers)
    expert_bytes = bpe * E - sum(
        layer["router"].numel() * layer["router"].element_size()
        for layer in moe_layers)
    tried, timing = {}, {}
    execute = epr.execute_placement

    def timed_execute(*a, **kw):
        _sync()
        t = time.perf_counter()
        out = execute(*a, **kw)
        _sync()
        timing["s"] = time.perf_counter() - t
        return out

    epr.execute_placement = timed_execute    # the step's exchange, timed
    try:
        layers, info, strategy, wall, counts, k3_0 = _relocate(
            epr, mops, kernels, E, R, cap, st0, moe_layers, tried)
    finally:
        epr.execute_placement = execute
    check(info["moved_experts"] >= 1, f"relocation: no expert moved "
          f"({tried})")
    check(all(a is b for a, b in zip(layers, moe_layers)),
          "relocation: the layers were not relocated in place")
    se = info["slot_expert"]
    check(np.array_equal(np.sort(se), np.arange(E)),
          "relocation: slot_expert is not a permutation")
    check((np.bincount(info["placement"], minlength=R) == cap).all(),
          f"relocation: a rank does not hold {cap} experts")
    check(info["moved_bytes"] == info["moved_experts"] * bpe,
          f"relocation: moved bytes {info['moved_bytes']} != "
          f"{info['moved_experts']} x {bpe}")
    peak = _peak_gib()
    h1, _, (_, st1) = transformer.forward(
        params, cfg, dict(tokens=pr, positions=pos),
        collect_router_stats=True, with_aux=True)
    logits1 = _f32_logits(params, cfg, h1)
    err = float((logits1 - logits0).abs().max())
    check(err <= 1e-3, f"relocation: logits moved by {err} (> 1e-3)")
    tok0, tok1 = int(logits0.argmax()), int(logits1.argmax())
    check(tok0 == tok1, f"relocation: greedy token {tok1}, not {tok0}")
    sel = torch.as_tensor(se, device=st0.counts.device).long()
    check(torch.equal(st1.counts, st0.counts[sel])
          and torch.equal(st1.coact, st0.coact[sel][:, sel]),
          "relocation: the physical router counts are not the old ones "
          "permuted by slot_expert")
    moved_b = info["moved_bytes"]
    bound_s = 2 * moved_b / PEAK_BYTES_PER_S
    ex_s = timing["s"]
    out = dict(strategy=strategy, moved_by_strategy=tried, ranks=R,
               moved_experts=info["moved_experts"], moved_bytes=moved_b,
               bytes_per_expert_slot=bpe, expert_stack_bytes=expert_bytes,
               max_avg_before=info["max_avg"], step_s=wall,
               plan_s=info["plan"].get("plan_seconds"), exchange_s=ex_s,
               bytes_per_s=moved_b / ex_s, hbm_bound_s=bound_s,
               bound_share=bound_s / ex_s, peak_gib=peak,
               resident_gib=info["resident_gib"],
               logits_max_abs_err=err, greedy_token=tok0,
               launches={k: v for k, v in counts.items() if v},
               k3_forms={f: n - k3_0[f]
                         for f, n in mops.form_launches.items()})
    EP_LAUNCHES.setdefault("relocation", {}).update(
        {k: counts[k] for k in EP_KERNELS})
    print(f"relocation of {cfg.name}'s {E} experts over {R} EP ranks "
          f"({strategy}; moved by strategy {tried}): "
          f"{info['moved_experts']} experts, {moved_b:.6g} bytes "
          f"({bpe:.6g} a slot; the expert stack {expert_bytes:.6g} bytes): "
          f"the exchange {1e3 * ex_s:.4f} ms, {moved_b / ex_s / 1e9:.3f} "
          f"GB/s, HBM bound (2 x moved bytes / 3.35 TB/s) "
          f"{1e3 * bound_s:.4f} ms = {bound_s / ex_s:.4f} of it; the whole "
          f"step {1e3 * wall:.3f} ms (plan {out['plan_s']} s); peak "
          f"{peak:.3f} GiB ({info['resident_gib']:.3f} resident before "
          f"it); logits "
          f"within {err:.3g} of before, greedy token {tok0} kept; router "
          f"counts permuted exactly; launches {out['launches']} [{SMI}]")
    return out


def ep_replay_phase():
    """Phase 14 (a): the EP replay at EP on the card — the device-resident
    loop with the launch counts set to 0 just before and read just after,
    the host loop (each fire's repair checked capacity-exact) and the CPU
    equal to it; steps/s and the idle share under the profiler.  Returns
    the device-resident run's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import ep_balance as eb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.train import ep_runtime as epr

    w = epr.RoutingWorkload(**EP)
    E, R, T = EP["num_experts"], EP["num_ranks"], EP_RUN["steps"]
    cap = E // R
    epr.run_ep_replay(w, **dict(EP_RUN, steps=EP_RUN["lb_every"] + 1),
                      device=DEV)                              # warm-up
    _sync()
    kernels.reset_launch_counts()
    k1_0, k3_0 = dict(dops.form_launches), dict(mops.form_launches)
    k4_0 = dict(hops.form_launches)
    res = epr.run_ep_replay(w, **EP_RUN, device=DEV)
    counts = kernels.launch_counts()
    K4_PATH_FORMS["EP replay"] = {f: n - k4_0[f]
                                  for f, n in hops.form_launches.items()}
    k3_forms_since(k3_0, "EP replay", counts["scatter_dest"])
    k1_forms_since(k1_0, "EP replay", R, min(4, R - 1),
                   counts["diffusion_nsweeps"])
    for name in EP_KERNELS:
        check(counts[name] > 0 or DEV != "cuda", f"kernel {name} was not "
              "launched on the EP replay")
    EP_LAUNCHES["replay"] = {k: counts[k] for k in EP_KERNELS}
    check(res.scanned, "the EP replay did not take the device-resident "
          "loop")
    fired = np.flatnonzero(res.lb_fired).tolist()
    want = [t for t in range(1, T) if t % EP_RUN["lb_every"] == 0]
    check(fired == want, f"EP replay fired at {fired}, not {want}")
    check(res.moved_experts.sum() > 0, "EP replay: no expert moved")
    check(np.isfinite(res.max_avg).all(), "EP replay: non-finite max/avg")
    # the host loop on the card, every fire's repair capacity-exact
    repairs = []
    orig = eb.repair_capacity

    def checked(*a, **kw):
        out = orig(*a, **kw)
        repairs.append(torch.bincount(out.long(), minlength=R).cpu())
        return out

    eb.repair_capacity = checked
    try:
        host = epr.run_ep_replay(w, **EP_RUN, scan=False, device=DEV)
    finally:
        eb.repair_capacity = orig
    check(len(repairs) == len(fired) and all(
        bool((c == cap).all()) for c in repairs),
        f"EP replay: a fire was not capacity-exact ({len(repairs)} "
        f"repairs for {len(fired)} fires)")
    _equal_fields(host, res, EP_FIELDS, "EP replay host loop vs "
                  "device-resident")
    check(np.array_equal(np.sort(res.final_slot_expert), np.arange(E))
          and (np.bincount(res.final_placement, minlength=R) == cap).all()
          and np.array_equal(res.final_placement[res.final_slot_expert],
                             np.arange(E) // cap),
          "EP replay: experts not conserved or placement not "
          "capacity-exact")
    check(np.array_equal(np.sort(res.final_wsig, 0), np.sort(
        epr._sig0(E, device="cpu").numpy(), 0)),
        "EP replay: payload rows not conserved")
    t0 = time.perf_counter()
    cpu = epr.run_ep_replay(w, **EP_RUN, device="cpu")
    cpu_s = time.perf_counter() - t0
    exact = tuple(f for f in EP_FIELDS if f != "max_avg")
    _equal_fields(res, cpu, exact, f"EP replay {DEV} vs cpu")
    # max/avg: every sum in the JAX package's CPU order on both devices;
    # held within 2 f32 spacings, the difference printed
    ulps = float((np.abs(res.max_avg - cpu.max_avg) / np.spacing(
        cpu.max_avg.astype(np.float32)).astype(np.float64)).max())
    check(ulps <= 2, f"EP replay {DEV} vs cpu: max/avg {ulps} ulp apart")
    out = dict(workload=EP, run=EP_RUN, fires=fired,
               moved_experts=float(res.moved_experts.sum()),
               moved_bytes=res.total_moved_bytes,
               mean_max_avg=float(res.max_avg.mean()),
               final_max_avg=float(res.max_avg[-1]),
               loop_s=res.wall_seconds, steps_per_s=T / res.wall_seconds,
               host_loop_s=host.wall_seconds,
               host_steps_per_s=T / host.wall_seconds,
               cpu_s=cpu_s, cpu_max_avg_ulps=ulps,
               launches=EP_LAUNCHES["replay"],
               k1_forms=K1_PATH_FORMS["EP replay"],
               k3_forms=K3_PATH_FORMS["EP replay"],
               k4_forms=K4_PATH_FORMS["EP replay"])
    if DEV == "cuda":
        from benchmarks_torch.serve_replay_profile import profile_replay

        _, prof = profile_replay(
            lambda: epr.run_ep_replay(w, **EP_RUN, device=DEV))
        out.update(profiled_loop_ms=prof["loop_ms"],
                   device_busy_ms=prof["device_busy_ms"],
                   idle_share=prof["idle_share"],
                   device_events=sum(r["count"] for r in prof["kernels"]),
                   top_kernels=prof["kernels"][:8])
    EPB["replay"] = out
    RESULTS["ep"] = host
    print(f"EP replay: {E} experts top-{EP['top_k']} on {R} ranks, "
          f"{EP['tokens_per_step']} tokens a step, {T} steps in "
          f"{res.wall_seconds:.3f} s ({out['steps_per_s']:.3f} steps/s; "
          f"host loop {out['host_steps_per_s']:.3f} steps/s; the CPU "
          f"{cpu_s:.3f} s); fired at {fired}, moved "
          f"{int(out['moved_experts'])} experts ({res.total_moved_bytes:.6g}"
          f" bytes), mean max/avg {out['mean_max_avg']:.6f}; host loop and "
          f"CPU equal, every fire capacity-exact; launches "
          f"{EP_LAUNCHES['replay']}, K1 forms {out['k1_forms']}, K3 forms "
          f"{out['k3_forms']}, K4 forms {out['k4_forms']}"
          + (f"; under the profiler: loop {out['profiled_loop_ms']:.1f} ms, "
             f"device busy {out['device_busy_ms']:.1f} ms, idle share "
             f"{out['idle_share']:.4f} ({out['device_events']} device "
             f"events)" if "idle_share" in out else "") + f" [{SMI}]")
    return counts


def ep_sharded_phase():
    """Phase 14 (c): the EP replay over EP_SHARDS shards of one card
    equals the single-device host loop."""
    from repro_torch.train import ep_runtime as epr

    w = epr.RoutingWorkload(**EP)
    t0 = time.perf_counter()
    r = epr.run_ep_replay(w, **EP_RUN, num_shards=EP_SHARDS, device=DEV)
    wall = time.perf_counter() - t0
    check(r.sharded, "EP replay: the sharded run did not shard")
    _equal_fields(r, RESULTS["ep"], EP_FIELDS,
                  f"EP replay over {EP_SHARDS} shards vs one device")
    EPB["sharded"] = dict(shards=EP_SHARDS, loop_s=r.wall_seconds,
                          steps_per_s=EP_RUN["steps"] / r.wall_seconds)
    print(f"EP replay over {EP_SHARDS} shards on one {DEV}: equal to the "
          f"single-device run in {', '.join(EP_FIELDS)}; {wall:.3f} s "
          f"({EPB['sharded']['steps_per_s']:.3f} steps/s)")


def ep_bench_gates():
    """Phase 14 (d): the moe bench's three gates (diffusion + predictive
    beats greedy + every on tokens/s and weight bytes on both workloads,
    the two loops bit for bit, the scale entry fires and moves bytes) and
    the ep_balance bench's two (diff-comm's max/avg below static's, moved
    experts at most greedy's), on the card."""
    from benchmarks_torch import ep_balance_bench, moe_bench

    out = {}
    t0 = time.perf_counter()
    moe_bench.bench_policies(out, steps=EP_BENCH["moe_steps"], device=DEV,
                             repeats=1)
    moe_bench.bench_scale(out, device=DEV, repeats=1, **EP_BENCH["scale"])
    for wname, e in out["workloads"].items():
        check(all(e["gates"].values()), f"moe bench {wname}: gates "
              f"{e['gates']}")
    eb = ep_balance_bench.policies(device=DEV, **EP_BENCH["ep_balance"])
    check(all(eb["gates"].values()), f"ep_balance bench: gates "
          f"{eb['gates']}")
    EPB["benches"] = dict(
        moe={w: dict(gates=e["gates"], **{
            p: {k: r[k] for k in ("tokens_per_second", "moved_weight_bytes",
                                  "rebalances", "wall_seconds")}
            for p, r in e["policies"].items()})
            for w, e in out["workloads"].items()},
        moe_parity_fires=out["parity_fires"], moe_scale=out["scale"],
        ep_balance=dict(gates=eb["gates"], policies=eb["policies"]),
        seconds=time.perf_counter() - t0)
    print(f"moe bench gates hold on {sorted(out['workloads'])}, the loops "
          f"equal ({out['parity_fires']:.0f} fires), the scale entry fired "
          f"{out['scale']['rebalances']:.0f} times "
          f"({out['scale']['steps_per_second']:.3f} steps/s); ep_balance "
          f"bench gates hold {eb['gates']}; "
          f"{EPB['benches']['seconds']:.3f} s")


# --------------------------------------------------------------- training --


def _train_cfg(arch, full, **kw):
    import dataclasses

    from repro_torch.configs import get_arch

    spec = get_arch(arch)
    return dataclasses.replace(spec.config if full else spec.reduced, **kw)


def _attention_calls(cfg) -> int:
    """Attention calls of one forward: the attention-bearing layers and
    the MTP block."""
    from repro_torch.models import transformer

    n = sum(k in transformer.ATTN_KINDS + transformer.HYMBA_KINDS
            for k in cfg.all_layers())
    return n + int(bool(cfg.mtp))


def _launches_since(names):
    from repro_torch import kernels

    got = kernels.launch_counts()
    return {n: got[n] for n in names}


def train_full_width():
    """Phase 15 (a): smollm-135m whole through ``launch.train.train`` with
    the launch counts set to 0 just before and read just after; then two
    steps of it under the profiler."""
    import shutil
    import tempfile
    import types

    import torch
    from repro_torch import kernels
    from repro_torch.launch import train as lt
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    run = lt.RunConfig(**TRAIN, reduced=not TRAIN_FULL, ckpt_dir=tmp,
                       device=DEV, log_every=5, resume=False)
    _reset_peak()
    kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    out = lt.train(run)
    _sync()
    wall = time.perf_counter() - t0
    counts = _launches_since(kernels.registry())
    TRAIN_LAUNCHES[f"({TRAIN['arch']})"] = counts
    peak = _peak_gib()
    cfg = out["config"]
    steps, calls = TRAIN["steps"], _attention_calls(cfg)
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"training: a loss or grad norm is not finite: {out['losses']}, "
          f"{out['grad_norms']}")
    if DEV == "cuda":
        check(counts["flash_attention"] == steps * calls,
              f"training: K6 forward launched {counts['flash_attention']} "
              f"times, not {steps} x {calls}")
        check(counts["flash_attention_bwd"] == steps * calls,
              f"training: K6 backward launched "
              f"{counts['flash_attention_bwd']} times, not {steps} x "
              f"{calls}")
    init = init_params(transformer.model_specs(cfg), 0, DEV)
    changed = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(init), tree_leaves(out["params"])))
    check(changed == len(tree_leaves(init)),
          f"training: {len(tree_leaves(init)) - changed} parameter tensors "
          "unchanged")
    saved = sorted(p.name for p in Path(tmp).iterdir()
                   if p.name.startswith("ckpt_"))
    check(saved[-1] == f"ckpt_{steps:08d}", f"training: checkpoints {saved}")
    shutil.rmtree(tmp, ignore_errors=True)
    warm = sorted(out["step_seconds"][1:])
    step_ms = 1e3 * warm[len(warm) // 2]
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    res = dict(arch=TRAIN["arch"], full=TRAIN_FULL, steps=steps,
               tokens_per_step=tokens, attention_calls_per_step=calls,
               launches=counts, losses=out["losses"],
               grad_norms=out["grad_norms"], wall_s=wall,
               first_step_ms=1e3 * out["step_seconds"][0],
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               peak_gib=peak, checkpoints=saved)
    if DEV == "cuda":
        from benchmarks_torch.serve_replay_profile import profile_replay

        step = ts_mod.make_train_step(cfg, opt_mod.OptConfig(
            lr=run.lr, warmup_steps=run.warmup, total_steps=steps))
        pipe = data_mod.DataPipeline(data_mod.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
            global_batch=TRAIN["global_batch"]), 1, device=DEV)
        batch = {k: torch.as_tensor(v, device=DEV)
                 for k, v in pipe.next_batch().items()}
        state = [out["params"], out["opt_state"]]

        def two_steps():
            t = time.perf_counter()
            for _ in range(2):
                state[0], state[1], m = step(state[0], state[1], batch)
            torch.cuda.synchronize()
            return types.SimpleNamespace(wall_seconds=time.perf_counter()
                                         - t)

        two_steps()
        kernels.reset_launch_counts()
        _, prof = profile_replay(two_steps)
        launched = _launches_since(kernels.registry())
        # the trace is whole: every K6 launch of the two steps is in it, a
        # forward kernel a forward launch, the mma form's dq and dk/dv
        # kernels a backward launch
        seen = {pat: sum(r["count"] for r in prof["kernels"]
                         if f"::{pat}<" in r["name"])
                for pat in ("mma_kernel", "split_kernel", "flash_kernel",
                            "dq_mma_kernel", "dkdv_mma_kernel")}
        fwd = seen["mma_kernel"] + seen["split_kernel"] + seen["flash_kernel"]
        check(fwd == launched["flash_attention"] == 2 * calls
              and seen["dq_mma_kernel"] == seen["dkdv_mma_kernel"]
              == launched["flash_attention_bwd"] == 2 * calls,
              f"training profile: recorded K6 runs {seen} against "
              f"{launched['flash_attention']} forward and "
              f"{launched['flash_attention_bwd']} backward launches (2 x "
              f"{calls} each)")
        res.update(profiled_k6_runs=seen,profiled_ms_per_step=prof["loop_ms"] / 2,
                   device_busy_ms_per_step=prof["device_busy_ms"] / 2,
                   idle_share=prof["idle_share"],
                   top_kernels=[dict(r, name=r["name"][:60])
                                for r in prof["kernels"][:8]])
        top = ", ".join(f"{r['name'][:40]} {r['device_ms'] / 2:.2f} ms"
                        for r in prof["kernels"][:6])
        print(f"training under the profiler: {prof['loop_ms'] / 2:.1f} ms "
              f"a step, device busy {prof['device_busy_ms'] / 2:.1f} ms, "
              f"idle share {prof['idle_share']:.4f}; top device time a "
              f"step: {top}")
    print(f"training ({TRAIN['arch']}, {'full width' if TRAIN_FULL else
                                        'reduced'}): {steps} steps of "
          f"{tokens} tokens in {wall:.1f} s; step {step_ms:.1f} ms "
          f"(median after the first, {res['first_step_ms']:.0f} ms), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB; loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{SMI}]")
    del out, init
    _reset_peak()
    return res


def _batches(vocab, n, B, S, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(1, vocab, (B, S)).astype(np.int32)
        lbl = np.concatenate([t[:, 1:], np.full((B, 1), -1, np.int32)], 1)
        pos = np.ascontiguousarray(
            np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))
        out.append({k: torch.as_tensor(v, device=DEV)
                    for k, v in (("tokens", t), ("labels", lbl),
                                 ("positions", pos))})
    return out


def train_crash_resume():
    """Phase 15 (b): under deterministic algorithms, ``run_resilient``
    with one injected ``WorkerFailure`` restores its checkpoint and ends
    on the parameters of an uninterrupted run, bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    from repro_torch.kernels.flash_attention import ops as fops

    R = TRAIN_RESUME
    cfg = _train_cfg(TRAIN["arch"], TRAIN_FULL)
    forms0 = dict(fops.bwd_form_launches)
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        params0 = init_params(transformer.model_specs(cfg), 0, DEV)
        opt0 = opt_mod.init(params0, device=DEV)
        step = ts_mod.make_train_step(
            cfg, opt_mod.OptConfig(warmup_steps=2, total_steps=50))
        batches = _batches(cfg.vocab_size, R["steps"], R["batch"],
                           R["seq_len"])
        p, o = params0, opt0
        for b in batches:
            p, o, _ = step(p, o, b)
        truth = [t.clone() for t in tree_leaves(p)]
        del p, o
        run = dict(p=params0, o=opt0)
        left = [1]

        def step_fn(s):
            if s == R["fail_at"] and left[0]:
                left[0] -= 1
                raise ft.WorkerFailure("injected")
            run["p"], run["o"], _ = step(run["p"], run["o"], batches[s])

        def save_fn(s):
            ckpt.save(tmp, s, run["p"], run["o"])

        def restore_fn():
            run["p"], run["o"], s, _ = ckpt.restore(tmp, run["p"], run["o"],
                                                    device=DEV)
            return s

        save_fn(0)
        out = ft.run_resilient(step_fn, start_step=0, num_steps=R["steps"],
                               save_every=R["save_every"], save_fn=save_fn,
                               restore_fn=restore_fn)
        got = tree_leaves(run["p"])
        differ = sum(not torch.equal(a, b) for a, b in zip(truth, got))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    check(out == dict(final_step=R["steps"], restarts=1),
          f"crash and resume: supervisor gave {out}")
    check(differ == 0, f"crash and resume: {differ} of {len(truth)} "
          "parameter tensors differ from the uninterrupted run")
    bwd_forms = {f: n - forms0[f] for f, n in fops.bwd_form_launches.items()}
    if DEV == "cuda" and TRAIN_FULL:
        check(bwd_forms["mma"] > 0 and bwd_forms["simt"] == 0,
              f"crash and resume: K6 backward's forms {bwd_forms}, not the "
              "mma form alone")
    res = dict(arch=TRAIN["arch"], full=TRAIN_FULL, steps=R["steps"],
               batch=R["batch"], seq_len=R["seq_len"],
               failed_at=R["fail_at"], restarts=out["restarts"],
               tensors_equal=len(truth), backward_forms=bwd_forms)
    print(f"crash and resume ({TRAIN['arch']} "
          f"{'at full width' if TRAIN_FULL else 'reduced'}, "
          f"{R['batch']} x {R['seq_len']} tokens, {R['steps']} steps, "
          f"deterministic algorithms): failed at step {R['fail_at']}, "
          f"restored, all {len(truth)} parameter tensors equal to the "
          f"uninterrupted run bit for bit; K6 backward's forms {bwd_forms}")
    _reset_peak()
    return res


def train_cuda_vs_cpu():
    """Phase 15 (c): one train step of every reduced config (f32 compute)
    on the card against the same step on the CPU.  Tolerances: loss 1e-5
    relative; grad norm 1e-4 relative; every gradient within 1e-3 of its
    leaf's largest magnitude (f32 sums in other orders, the attention
    backward a kernel against autograd of the plain version); updated
    parameters within 2.5 lr absolute (the first AdamW step moves an
    element by about lr sign(g), so an element whose gradient is near 0
    may move the other way) and within 1e-6 in all but 1% of elements;
    router counts and co-activations exact."""
    import torch
    from repro_torch.configs import list_archs
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_leaves, tree_to
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    out = {}
    for arch in list_archs():
        cfg = _train_cfg(arch, False, compute_dtype="float32")
        collect = cfg.moe is not None
        ocfg = opt_mod.OptConfig(warmup_steps=1, total_steps=10)
        p_cpu = init_params(transformer.model_specs(cfg), 0, "cpu")
        batch = _frontend_or_tokens(cfg)
        res = {}
        for dev in ("cpu", DEV):
            seen = {}

            def capture(g, seen=seen):
                seen["g"] = g
                return g

            step = ts_mod.make_train_step(cfg, ocfg, grad_transform=capture,
                                          collect_router_stats=collect)
            p = tree_to(p_cpu, dev)
            b = {k: None if v is None else v.to(dev)
                 for k, v in batch.items()}
            p2, _, m = step(p, opt_mod.init(p, device=dev), b)
            res[dev] = (tree_to(p2, "cpu"), tree_to(seen["g"], "cpu"),
                        {k: v.cpu() for k, v in m.items()})
        (pc, gc, mc), (pd, gd, md) = res["cpu"], res[DEV]
        lr = float(mc["lr"])
        check(abs(float(md["loss"]) - float(mc["loss"]))
              <= 1e-5 * abs(float(mc["loss"])),
              f"{arch}: loss {float(md['loss'])} vs {float(mc['loss'])}")
        check(abs(float(md["grad_norm"]) - float(mc["grad_norm"]))
              <= 1e-4 * float(mc["grad_norm"]), f"{arch}: grad norm")
        g_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-12)
                    for a, b in zip(tree_leaves(gd), tree_leaves(gc)))
        check(g_err <= 1e-3, f"{arch}: gradients {g_err} off the CPU's")
        p_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(pd), tree_leaves(pc)))
        n_far = sum(int(((a.float() - b.float()).abs() > 1e-6).sum())
                    for a, b in zip(tree_leaves(pd), tree_leaves(pc)))
        n_all = sum(a.numel() for a in tree_leaves(pc))
        check(p_err <= 2.5 * lr and n_far <= 0.01 * n_all,
              f"{arch}: parameters {p_err} off, {n_far} of {n_all} "
              "elements beyond 1e-6")
        if collect:
            check(torch.equal(md["router_counts"], mc["router_counts"])
                  and torch.equal(md["router_coact"], mc["router_coact"]),
                  f"{arch}: router statistics differ from the CPU's")
        out[arch] = dict(loss_rel_err=abs(float(md["loss"]) - float(
            mc["loss"])) / abs(float(mc["loss"])), grad_rel_err=g_err,
            param_max_abs_err=p_err, param_elements_beyond_1e6=n_far)
    print(f"one train step of every reduced config (f32) on the card vs "
          f"the CPU: {out}")
    return out


def _frontend_or_tokens(cfg):
    """A (2, 16) training batch on the CPU from the shape registry (frontend
    embeddings where the config has a frontend)."""
    import dataclasses

    from repro_torch.configs import SHAPES, materialize_batch

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    return materialize_batch(cfg, shape, seed=0, device="cpu")["batch"]


def _expert_slots(layers):
    """Every expert slot's tensors of every MoE layer, flattened to one row
    a slot: a list of (E, n) tensors (one a layer)."""
    import torch

    out = []
    for moe in layers:
        E = moe["router"].shape[1]
        rows = [moe["router"].T.reshape(E, -1)]
        rows += [moe[k].reshape(E, -1) for k in ("wi", "wg", "wo")]
        out.append(torch.cat(rows, 1).clone())
    return out


def _ep_training(dev):
    """The reduced deepseek-v3 (f32) with the a2a over ``ep_shards`` EP
    shards and expert rebalancing on ``TRAIN_EP_RANKS`` EP ranks: the train
    step under ``moe.use_mesh`` and the launcher's ``_rebalance_experts``
    each step, as ``launch.train.train`` drives them, on Zipf-distributed
    token ids.  Returns the fires, moved experts, losses, the router
    counts' sums and what each fire kept (the multiset of expert slots, in
    place)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.distributed.mesh import ShardMesh
    from repro_torch.launch import train as lt
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_to
    from repro_torch.train import ep_runtime
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    base = _train_cfg(TRAIN_EP["arch"], False, compute_dtype="float32")
    mcfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="a2a"))
    run = lt.RunConfig(arch=TRAIN_EP["arch"], steps=TRAIN_EP["steps"])
    ocfg = opt_mod.OptConfig(lr=run.lr, warmup_steps=run.warmup,
                             total_steps=run.steps)
    step_fn = ts_mod.make_train_step(mcfg, ocfg, collect_router_stats=True)
    mesh = ShardMesh(TRAIN_EP["ep_shards"], dev)
    # the CPU's draw on both devices (a CUDA generator draws other numbers)
    params = tree_to(init_params(transformer.model_specs(mcfg), run.seed,
                                 "cpu"), dev)
    opt_state = opt_mod.init(params, device=dev)
    reb = ep_runtime.EPRebalancer(
        mcfg.moe.num_experts, TRAIN_EP_RANKS, strategy=run.ep_strategy,
        lb_every=TRAIN_EP["ep_balance_every"], device=dev)
    fires, moved, losses, sums, conserved, in_place = [], [], [], [], [], []
    stats = []
    rng = np.random.default_rng(0)
    B, S = TRAIN_EP["global_batch"], TRAIN_EP["seq_len"]
    for s in range(TRAIN_EP["steps"]):
        # Zipf(1.1) token ids, as word frequencies in text: the routing is
        # skewed as text skews it (the pipeline's uniform ids route about
        # evenly, within the planner's tolerance: nothing would move)
        tok = np.minimum(rng.zipf(TRAIN_EP_ZIPF, (B, S)),
                         mcfg.vocab_size - 1).astype(np.int32)
        lbl = np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                 for k, v in (("tokens", tok), ("labels", lbl),
                              ("positions", pos))}
        with moe_mod.use_mesh(mesh):
            params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        sums.append(float(m["router_counts"].sum()))
        stats.append((m["router_counts"].cpu(), m["router_coact"].cpu()))
        where = lt._moe_blocks(params)
        before = _expert_slots([params["layers"][i]["moe"] for i in where])
        ptrs = [params["layers"][i]["moe"]["wi"].data_ptr() for i in where]
        params, info = lt._rebalance_experts(params, reb, m, s)
        if info["fired"]:
            fires.append(s)
            moved.append(int(info["moved_experts"]))
            after = _expert_slots([params["layers"][i]["moe"]
                                   for i in where])
            # the same rows, permuted: sort both by their bytes
            same = all(torch.equal(_sorted_rows(a), _sorted_rows(b))
                       for a, b in zip(before, after))
            conserved.append(same)
            in_place.append(ptrs == [params["layers"][i]["moe"]["wi"]
                                     .data_ptr() for i in where])
    # the statistics sum over the MoE layers
    tokens = TRAIN_EP["global_batch"] * TRAIN_EP["seq_len"] * len(
        lt._moe_blocks(params))
    return dict(fires=fires, moved=moved, losses=losses,
                counts_sums=sums, conserved=conserved, in_place=in_place,
                tokens=tokens, top_k=mcfg.moe.top_k, stats=stats,
                slot_expert=reb.slot_expert.tolist())


def _ep_shadow(stats):
    """A CPU ``EPRebalancer`` fed a run's router statistics, relocating
    the initial weights' expert tensors: its fires, moved experts and
    final slot → expert map."""
    from repro_torch.launch import train as lt
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.train import ep_runtime

    cfg = _train_cfg(TRAIN_EP["arch"], False)
    params = init_params(transformer.model_specs(cfg), 0, "cpu")
    reb = ep_runtime.EPRebalancer(
        cfg.moe.num_experts, TRAIN_EP_RANKS, strategy="diff-comm",
        lb_every=TRAIN_EP["ep_balance_every"], device="cpu")
    fires, moved = [], []
    for s, (counts, coact) in enumerate(stats):
        params, info = lt._rebalance_experts(
            params, reb, dict(router_counts=counts, router_coact=coact), s)
        if info["fired"]:
            fires.append(s)
            moved.append(int(info["moved_experts"]))
    return dict(fires=fires, moved=moved,
                slot_expert=reb.slot_expert.tolist())


def _sorted_rows(t):
    """The rows of a 2-D tensor in lexicographic order of their values."""
    import numpy as np
    import torch

    a = t.detach().cpu().numpy()
    order = np.lexsort(a.T[::-1])
    return torch.as_tensor(a[order])


def train_ep_phase():
    """Phase 15 (d): the reduced deepseek-v3 (MLA, MoE, MTP) with the a2a
    over ShardMesh(4): its loss against the dense loss (capacity factor 8,
    nothing dropped: within 1e-5 relative, f32), then 8 training steps with
    expert rebalancing every 2 on the card (launch counts set to 0 just
    before and read just after) and on the CPU."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.distributed.mesh import ShardMesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    base = _train_cfg(TRAIN_EP["arch"], False, compute_dtype="float32")
    wide = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=8.0, impl="a2a"))
    params = init_params(transformer.model_specs(base), 0, DEV)
    batch = _batches(base.vocab_size, 1, 4, 64, seed=1)[0]
    with torch.no_grad():
        with moe_mod.use_mesh(ShardMesh(TRAIN_EP["ep_shards"], DEV)):
            la, ma = transformer.loss_fn(params, wide, batch,
                                         collect_router_stats=True)
        ld, md = transformer.loss_fn(params, base, batch,
                                     collect_router_stats=True)
    a2a_err = abs(float(la) - float(ld)) / abs(float(ld))
    check(a2a_err <= 1e-5, f"a2a loss {float(la)} vs dense {float(ld)}")
    check(torch.equal(ma["router_counts"], md["router_counts"]),
          "a2a: router counts differ from the dense path's")
    kernels.reset_launch_counts()
    _sync()
    card = _ep_training(DEV)
    _sync()
    counts = _launches_since(kernels.registry())
    TRAIN_LAUNCHES["EP (deepseek-v3 reduced, a2a over 4 shards)"] = counts
    cpu = _ep_training("cpu")
    every = TRAIN_EP["ep_balance_every"]
    want_fires = [s for s in range(TRAIN_EP["steps"]) if s and s % every == 0]
    check(card["fires"] == want_fires,
          f"EP training: fired at {card['fires']}, not {want_fires}")
    check(all(s == card["tokens"] * card["top_k"]
              for s in card["counts_sums"]),
          f"EP training: router counts sum to {card['counts_sums']}")
    check(all(card["conserved"]) and all(card["in_place"]),
          f"EP training: relocation conserved {card['conserved']}, in "
          f"place {card['in_place']}")
    # the CPU's rebalancer on the card's statistics: the same decisions
    shadow = _ep_shadow(card["stats"])
    check((card["fires"], card["moved"], card["slot_expert"])
          == (shadow["fires"], shadow["moved"], shadow["slot_expert"]),
          f"EP training: card fires/moved {card['fires']}/{card['moved']} "
          f"vs the CPU's rebalancer on the same statistics "
          f"{shadow['fires']}/{shadow['moved']}")
    # and the CPU's own run (its parameters drift from the card's by f32
    # rounding, so a router near-tie could route one token differently)
    check((card["fires"], card["moved"], card["slot_expert"])
          == (cpu["fires"], cpu["moved"], cpu["slot_expert"]),
          f"EP training: card fires/moved {card['fires']}/{card['moved']} "
          f"vs the CPU's run {cpu['fires']}/{cpu['moved']}")
    check(sum(card["moved"]) > 0, "EP training: no expert moved")
    if DEV == "cuda":
        calls = _attention_calls(base)
        for k in TRAIN_EP_KERNELS:
            check(counts[k] > 0, f"EP training: {k} not launched")
        check(counts["flash_attention"] == counts["flash_attention_bwd"]
              == TRAIN_EP["steps"] * calls,
              f"EP training: K6 {counts['flash_attention']} forward, "
              f"{counts['flash_attention_bwd']} backward launches, not "
              f"{TRAIN_EP['steps']} x {calls}")
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    stat_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                     for a, b in zip(card["stats"], cpu["stats"]))
    res = dict(a2a_vs_dense_loss_rel_err=a2a_err, fires=card["fires"],
               moved_experts=card["moved"], losses=card["losses"],
               router_stats_equal_cpu_every_step=stat_equal,
               cpu_loss_max_rel_err=loss_err,
               launches={k: v for k, v in counts.items() if v})
    print(f"EP training (deepseek-v3 reduced, a2a over "
          f"{TRAIN_EP['ep_shards']} shards, {TRAIN_EP['steps']} steps, LB "
          f"every {every}): a2a loss {a2a_err:.3g} off the dense loss; "
          f"fired at {card['fires']}, moved {card['moved']} experts, equal "
          f"to the CPU's (router statistics equal every step: "
          f"{stat_equal}); relocations in place and conserved; losses "
          f"within {loss_err:.3g} of the CPU's; launches "
          f"{res['launches']}")
    return res


def train_data_phase():
    """Phase 15 (e): the data pipeline's rebalance over 8 ranks on the card
    (launch counts set to 0 just before and read just after) against the
    CPU: the same assignment and moved shards."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.train import data as data_mod

    D = TRAIN_DATA
    infos, assigns = {}, {}
    for dev in (DEV, "cpu"):
        cfg = data_mod.DataConfig(vocab_size=49152, seq_len=D["seq_len"],
                                  global_batch=D["num_ranks"],
                                  num_shards=D["num_shards"], seed=D["seed"])
        pipe = data_mod.DataPipeline(cfg, D["num_ranks"], device=dev)
        before = pipe.rank_loads()
        if dev == DEV:
            kernels.reset_launch_counts()
            _sync()
        infos[dev] = pipe.maybe_rebalance(threshold=D["threshold"])
        if dev == DEV:
            _sync()
            counts = _launches_since(kernels.registry())
        assigns[dev] = pipe.state.assignment.copy()
        after = pipe.rank_loads()
    TRAIN_LAUNCHES["data pipeline (8 ranks)"] = counts
    check(infos[DEV] is not None and infos[DEV]["moved_shards"] > 0,
          "data pipeline: no rebalance fired, or it moved no shard")
    check(np.array_equal(assigns[DEV], assigns["cpu"])
          and infos[DEV]["moved_shards"] == infos["cpu"]["moved_shards"],
          "data pipeline: the card's assignment differs from the CPU's")
    res = dict(moved_shards=infos[DEV]["moved_shards"],
               max_avg_before=float(before.max() / before.mean()),
               max_avg_after=float(after.max() / after.mean()),
               launches={k: v for k, v in counts.items() if v})
    print(f"data pipeline over {D['num_ranks']} ranks: rebalanced, moved "
          f"{res['moved_shards']} shards (card == CPU), max/avg "
          f"{res['max_avg_before']:.4f} -> {res['max_avg_after']:.4f}; "
          f"launches {res['launches']}")
    return res


def training_phase():
    """Phase 15: training (a)-(e); the backward kernel's checks are in
    phase 11 (``flash_bwd_row``)."""
    TRAINING["full_width"] = train_full_width()
    TRAINING["crash_resume"] = train_crash_resume()
    TRAINING["cuda_vs_cpu"] = train_cuda_vs_cpu()
    TRAINING["ep"] = train_ep_phase()
    TRAINING["data"] = train_data_phase()
    _reset_peak()


# ------------------------------------------------------ sharded paths --


def _sha(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _equal_fields(got, want, fields, what):
    import numpy as np

    for f in fields:
        check(np.array_equal(np.asarray(getattr(got, f)),
                             np.asarray(getattr(want, f))),
              f"{what}: {f} differs")


def sharded_pic(single):
    """The PIC configuration with ``sharded_replay=True`` over
    ``SHARDED_PIC["replay_shards"]`` shards: at the default capacity (the
    worst case, n a shard) with the launch counts set to 0 just before and
    read just after, then at the tight capacity of its own run (the most
    slots a shard held), then that again under the profiler for the idle
    share; each equal to the single-device PIC run ``single`` in the eight
    fields.  Returns the launch counts of the first run."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.pic import driver

    cfg = dict(PIC, **SHARDED_PIC)
    D, T = cfg["replay_shards"], cfg["steps"]
    _sync()
    kernels.reset_launch_counts()
    res = driver.run(driver.PICConfig(**cfg, device=DEV))
    counts = kernels.launch_counts()
    for name in SHARDED_PIC_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "sharded PIC path")
    _equal_fields(res, single, PIC_FIELDS, "sharded PIC (default capacity)")
    fired = int(res.lb_steps.sum())
    cap = int(res.shard_counts.max())
    tight = driver.run(driver.PICConfig(**cfg, replay_capacity=cap,
                                        device=DEV))
    _equal_fields(tight, single, PIC_FIELDS, "sharded PIC (tight capacity)")
    rate = {"default": T / res.wall_seconds, "tight": T / tight.wall_seconds}
    SHARDED["PIC"] = dict(
        shards=D, capacity_default=cfg["n_particles"], capacity_tight=cap,
        steps_per_s=rate, exchanges=fired, launches=counts,
        k3_launches_per_exchange=counts["scatter_dest"] / max(fired, 1),
        k4_launches_per_step=counts["histogram"] / T,
        k5_launches_per_step=counts["pic_push"] / T)
    print(f"sharded PIC path: {cfg['n_particles']} particles over {D} "
          f"shards, {T} steps, equal to the single-device run in "
          f"{PIC_FIELDS}; default capacity {cfg['n_particles']} a shard "
          f"{rate['default']:.3f} steps/s, tight capacity {cap} "
          f"{rate['tight']:.3f} steps/s (single-device "
          f"{T / single.wall_seconds:.3f}); {fired} exchanges, K3 "
          f"{counts['scatter_dest']} launches "
          f"({SHARDED['PIC']['k3_launches_per_exchange']:.2f} an exchange),"
          f" K4 {counts['histogram']}, K5 {counts['pic_push']}; launches "
          f"{counts}")
    if DEV == "cuda":
        from benchmarks_torch.serve_replay_profile import profile_replay

        _, prof = profile_replay(lambda: driver.run(driver.PICConfig(
            **cfg, replay_capacity=cap, device=DEV)), start="pic_push")
        top = ", ".join(f"{r['name'][:40]} {r['device_ms']:.3f} ms "
                        f"x{r['count']}" for r in prof["kernels"][:8])
        SHARDED["PIC"].update(idle_share=prof["idle_share"],
                              device_busy_ms=prof["device_busy_ms"],
                              loop_ms=prof["loop_ms"])
        print(f"sharded PIC (tight capacity) under the profiler: step loop "
              f"{prof['loop_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle share "
              f"{prof['idle_share']:.4f}; top device time: {top}")
    return counts


def sharded_series(single):
    """The simulator path's replay over ``SHARDED_SIM_SHARDS`` shards
    (launch counts set to 0 just before and read just after): the fire
    steps, max/avg at the fired steps and the final assignment's SHA-256
    equal the single-device replay ``single``'s."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.sim import scenarios, simulator

    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device=DEV, **SIM_SCENARIO)
    _sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = simulator.run_series_sharded(problem, evolve, **SIM,
                                       num_shards=SHARDED_SIM_SHARDS)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    fired = np.flatnonzero(res.lb_fired).tolist()
    want = np.flatnonzero(single.lb_fired).tolist()
    check(fired == want, f"sharded series fired at {fired}, not {want}")
    check(np.array_equal(res.max_avg[fired], single.max_avg[fired]),
          "sharded series: max/avg at the fired steps differs")
    check(_sha(res.final_assignment) == _sha(single.final_assignment),
          "sharded series: final assignment differs")
    for name in SHARDED_SIM_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "sharded series path")
    SHARDED["series"] = dict(shards=SHARDED_SIM_SHARDS, wall_seconds=wall,
                             loop_seconds=res.wall_seconds,
                             plan_seconds=res.plan_seconds,
                             single_plan_seconds=float(
                                 single.plan_step_seconds.sum()),
                             launches=counts)
    print(f"sharded series: {SIM_SCENARIO['num_nodes']} nodes over "
          f"{SHARDED_SIM_SHARDS} shards, {SIM['steps']} steps in "
          f"{wall:.3f} s end to end ({res.wall_seconds:.3f} s loop, plans "
          f"{res.plan_seconds:.3f} s; single-device plans "
          f"{float(single.plan_step_seconds.sum()):.3f} s); fired {fired}, "
          f"max/avg there {[float(res.max_avg[t]) for t in fired]}, final "
          f"assignment sha256 {_sha(res.final_assignment)[:16]} (equal); "
          f"launches {counts}")


def resilience_phase():
    """A fault schedule (die, slow, recover) on a reduced sharded series
    and a reduced sharded PIC run, on the card and on the CPU: equal fire
    steps, plan_rejected, migrations and final assignments; no object on
    the dead node after the evacuation fire; objects and particles
    conserved; the checkpointed replay with injected failures equal to the
    uninterrupted one."""
    import numpy as np
    from repro_torch.pic import driver
    from repro_torch.runtime import resilience as rz
    from repro_torch.sim import scenarios, simulator

    c = RESIL_SIM
    fs = rz.FaultSchedule(events=c["events"])
    kw = dict(steps=c["steps"], lb_every=c["lb_every"],
              strategy="diff-comm", strategy_kwargs=c["strategy_kwargs"],
              num_shards=c["shards"], faults=fs)
    runs = {}
    for dev in (DEV, "cpu"):
        p, ev = scenarios.get("stencil-wave").instantiate(device=dev,
                                                          **c["scenario"])
        runs[dev] = simulator.run_series_sharded(p, ev, **kw)
    g, cpu = runs[DEV], runs["cpu"]
    _equal_fields(g, cpu, ("lb_fired", "plan_rejected", "migrations",
                           "final_assignment"), "resilient series, card "
                  "against CPU")
    N = c["scenario"]["grid"] ** 2
    P = c["scenario"]["num_nodes"]
    fa = g.final_assignment
    check(fa.shape == (N,) and fa.min() >= 0 and fa.max() < P,
          "resilient series: objects not conserved")
    die_t, dead = [(t, d) for t, d, k in c["events"] if k == "die"][0]
    rec_t = [t for t, d, k in c["events"] if k == "recover" and d == dead]
    rpd = P // c["shards"]
    check(g.lb_fired[die_t] == 1.0, "no evacuation fire at the death")
    p, ev = scenarios.get("stencil-wave").instantiate(device=DEV,
                                                      **c["scenario"])
    short = simulator.run_series_sharded(p, ev, **dict(kw, steps=rec_t[0]))
    on_dead = np.isin(short.final_assignment,
                      np.arange(dead * rpd, (dead + 1) * rpd))
    check(not on_dead.any(), f"{int(on_dead.sum())} objects left on the "
          "dead shard's nodes after the evacuation fire")
    ck = rz.run_series_checkpointed(p, ev, checkpoint_every=c["every"],
                                    fail_at=c["fail_at"], **kw)
    _equal_fields(ck, g, SERIES_FIELDS + ("plan_rejected",),
                  "checkpointed replay against the uninterrupted one")
    print(f"resilient series (faults {c['events']}, {c['shards']} shards): "
          f"card == cpu, fired {np.flatnonzero(g.lb_fired).tolist()}, "
          f"rejected {int(g.plan_rejected.sum())}; no object on shard "
          f"{dead} after the evacuation; checkpointed (every {c['every']}, "
          f"failures before chunks {c['fail_at']}) == uninterrupted")

    pc = RESIL_PIC
    pfs = rz.FaultSchedule(events=pc["events"])
    base = {k: v for k, v in pc.items() if k not in ("events", "shards")}
    runs = {dev: driver.run(driver.PICConfig(
        **base, sharded_replay=True, replay_shards=pc["shards"],
        faults=pfs, device=dev)) for dev in (DEV, "cpu")}
    g, cpu = runs[DEV], runs["cpu"]
    _equal_fields(g, cpu, ("lb_steps", "plan_rejected", "migrations",
                           "migrated_bytes"), "resilient PIC, card against "
                  "CPU")
    err = max(np.abs(g.final_x - cpu.final_x).max(),
              np.abs(g.final_y - cpu.final_y).max())
    check(err <= 1e-3, f"resilient PIC: positions differ by {err}")
    none = driver.run(driver.PICConfig(**dict(
        base, strategy="none", strategy_kwargs=None), device=DEV))
    check(np.array_equal(g.final_x, none.final_x)
          and np.array_equal(g.final_y, none.final_y),
          "resilient PIC: particles not conserved through the evacuation")
    die_p = [t for t, d, k in pc["events"] if k == "die"][0]
    check(g.lb_steps[die_p] == 1.0, "resilient PIC: no evacuation fire")
    SHARDED["resilience"] = dict(
        pic_fired=np.flatnonzero(g.lb_steps).tolist(),
        pic_rejected=int(g.plan_rejected.sum()))
    print(f"resilient PIC (faults {pc['events']}, {pc['shards']} shards): "
          f"card == cpu in fire steps, rejections and migrations "
          f"(positions within {err:.3g}); every particle kept")


def exchange_phase():
    """``migrate_sharded`` alone over ``EXCHANGE["n"]`` items, D shards,
    C nodes (launch counts set to 0 just before and read just after):
    strict mode equal to ``apply_manifest``'s layout; spill mode keeps
    every item, and its layout and deferred count equal the CPU's; K3's
    time at one hop's input."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.distributed.mesh import ShardMesh
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.runtime import migrate as rt_migrate

    n, D, C = EXCHANGE["n"], EXCHANGE["shards"], EXCHANGE["nodes"]
    rng = np.random.default_rng(0)
    owner_np = rng.integers(0, C, n).astype(np.int32)
    owner = torch.as_tensor(owner_np, device=DEV)
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    x = torch.as_tensor(rng.random(n).astype(np.float32), device=DEV)
    mesh = ShardMesh(D, DEV)
    _sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, (ido, xo), cnt = rt_migrate.migrate_sharded(
        owner, (ids, x), num_nodes=C, mesh=mesh)
    _sync()
    strict_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for name in SHARDED_EXCHANGE_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched by the "
              "sharded exchange")
    cap = out.shape[0] // D
    keep = torch.cat([torch.arange(d * cap, d * cap + int(c), device=DEV)
                      for d, c in enumerate(cnt.tolist())])
    (ref_ids, ref_x), _ = rt_migrate.migrate(owner, owner, (ids, x),
                                             num_nodes=C)
    check(torch.equal(ido[keep], ref_ids) and torch.equal(xo[keep], ref_x)
          and torch.equal(out[keep], owner[ref_ids.long()]),
          "strict sharded exchange differs from apply_manifest's layout")
    spill_cap = n // D
    got = rt_migrate.migrate_sharded(owner, (ids,), num_nodes=C, mesh=mesh,
                                     capacity=spill_cap, on_overflow="spill")
    cpu = rt_migrate.migrate_sharded(
        owner.cpu(), (ids.cpu(),), num_nodes=C,
        mesh=ShardMesh(D, "cpu"), capacity=spill_cap, on_overflow="spill")
    gk = torch.cat([got[1][0][d * spill_cap:d * spill_cap + int(c)]
                    for d, c in enumerate(got[2].tolist())])
    check(torch.equal(torch.sort(gk).values, ids),
          "spill exchange did not keep every item exactly once")
    check(got[3] == cpu[3] and got[3] > 0, f"spill deferred {got[3]} on the "
          f"card, {cpu[3]} on the CPU")
    check(torch.equal(got[1][0].cpu(), cpu[1][0])
          and torch.equal(got[2].cpu(), cpu[2]),
          "spill layout differs between card and CPU")
    # one hop's K3 input: each shard's accepted owners, the rest padding
    hop = torch.where(torch.div(owner, C // D, rounding_mode="floor")
                      == torch.arange(n, device=DEV) // (n // D), owner, C)
    k3_ms = k3_dev = None
    if DEV == "cuda":
        k3_ms = time_ms(lambda: mops.bucket_ranks(hop, C=C), reps=10)
        k3_dev = device_ms(lambda: mops.bucket_ranks(hop, C=C), reps=5)
    SHARDED["exchange"] = dict(
        n=n, shards=D, nodes=C, capacity=cap, strict_s=strict_s,
        launches=counts, k3_hop_ms=k3_ms, k3_hop_device_ms=k3_dev,
        k3_form=mops.scatter_form(n, C), deferred=int(got[3]))
    print(f"sharded exchange: {n} items, {D} shards, {C} nodes, planned "
          f"capacity {cap}: strict == apply_manifest in {strict_s:.3f} s "
          f"({counts['scatter_dest']} K3 launches, "
          f"{mops.scatter_form(n, C)} form); spill at {spill_cap} a shard "
          f"kept every item, deferred {got[3]} (== cpu); K3 a hop "
          f"{k3_ms} ms ({k3_dev} ms device)")


def sharded_fleet(single):
    """The fleet replay with ``num_shards`` (launch counts set to 0 just
    before and read just after): fires, moved sessions, moved KV and the
    final placement equal the single-device fleet ``single``'s."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve import replay as sr

    w = sr.ServeWorkload(**FLEET)
    _sync()
    kernels.reset_launch_counts()
    res = sr.run_serve_replay(w, **FLEET_RUN, num_shards=FLEET_SHARDS,
                              device=DEV)
    counts = kernels.launch_counts()
    check(res.sharded, "the fleet did not take the sharded branch")
    for name in SHARDED_FLEET_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "sharded fleet")
    for f in ("lb_fired", "moved_sessions", "moved_kv_bytes", "max_avg"):
        check(np.array_equal(getattr(res, f), getattr(single, f)),
              f"sharded fleet: {f} differs from the single-device fleet")
    check(np.array_equal(res.final_replica_by_uid,
                         single.final_replica_by_uid),
          "sharded fleet: final placement differs")
    SHARDED["fleet"] = dict(shards=FLEET_SHARDS, wall_seconds=
                            res.wall_seconds, launches=counts)
    print(f"sharded fleet: {FLEET['num_sessions']} sessions, "
          f"{FLEET_SHARDS} shards, {res.wall_seconds:.3f} s: fired "
          f"{np.flatnonzero(res.lb_fired).tolist()}, moved "
          f"{int(res.moved_sessions.sum())} sessions and "
          f"{res.total_moved_kv:.1f} KV bytes, equal to the single-device "
          f"fleet; launches {counts}")


def fig5_sharded():
    """Fig 5 with the sharded planner as well: its assertions hold and
    the sharded planner's runs equal the single-device planner's."""
    from benchmarks_torch import fig5_scaling
    from repro_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fig5_scaling.run(device=DEV, **PAPER_HOST["fig5_scaling"],
                           **FIG5_SHARDED)
    check(out["sharded_planner"], "fig5 did not plan with the sharded "
          "engine")
    SHARDED["fig5"] = {p: dict(
        sharded_lb_s=out[p]["diff-comm-sharded"]["lb_seconds"],
        single_lb_s=out[p]["diff-comm"]["lb_seconds"])
        for p in out if isinstance(p, int)}
    print(f"fig5 with the sharded planner: {time.perf_counter() - t0:.3f} "
          f"s, plans equal at every scale; launches "
          f"{kernels.launch_counts()}")


def sharded_kernel_checks():
    """K3, K4 and K5 at the shapes the sharded PIC path gives them (D
    slabs of the default capacity, padding included: K5 over every slot,
    K4 over D·C chare buckets, K3 over one hop's accepted owners with C =
    P) against their plain versions, timed; returns one dict a kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.kernels.migrate.ref import bucket_ranks_ref
    from repro_torch.kernels.pic_push import ops as pops
    from repro_torch.kernels.pic_push.ref import pic_push_ref
    from repro_torch.pic import chares
    from repro_torch.pic.grid import alternating_grid
    from repro_torch.pic.particles import initialize

    cfg = dict(PIC, **SHARDED_PIC)
    L, N, C = cfg["L"], cfg["n_particles"], cfg["cx"] * cfg["cy"]
    D, P = cfg["replay_shards"], cfg["num_pes"]
    cap, per = N, N // D
    p = initialize(cfg["mode"], L, N, k=2, vy0=1.0, rho=cfg["rho"], seed=0)
    slabs = []
    for a in (p.x, p.y, p.vx, p.vy, p.q):
        s = torch.zeros((D, cap), dtype=torch.float32, device=DEV)
        s[:, :per] = torch.as_tensor(a, device=DEV).reshape(D, per)
        slabs.append(s.reshape(-1))
    grid = torch.as_tensor(alternating_grid(L), device=DEV)
    out = {}
    got = pops.pic_push(grid, *slabs, L=L)
    want, plain = timed_once(lambda: pic_push_ref(grid, *slabs, L=L))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for a, b in zip(got, want):
        sp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) \
            - b.abs()
        check(((a - b).abs() <= sp).all(),
              "pic_push (sharded slabs): more than 1 ulp off")
    n = D * cap
    out["pic_push"] = dict(
        shape=f"{D} slabs x {cap} slots", max_abs_err=err,
        ms=time_ms(lambda: pops.pic_push(grid, *slabs, L=L), reps=5),
        plain_ms=plain,
        bound_ms=bound_ms(9 * 4 * n + 4 * L * L, 95 * n)[0])
    del want
    x, y = got[0].reshape(D, cap), got[1].reshape(D, cap)
    live = (torch.arange(cap, device=DEV)[None, :] < per).expand(D, cap)
    ch_ = chares.chare_of_device(x, y, L, cfg["cx"], cfg["cy"])
    me = torch.arange(D, device=DEV)[:, None]
    ids = (me * C + ch_).reshape(-1)
    w = live.to(torch.float32).reshape(-1)
    g4 = hops.histogram(ids, w, C=D * C)
    w4, plain4 = timed_once(lambda: histogram_ref(ids, w, C=D * C))
    err4 = float((g4 - w4).abs().max())
    check(err4 == 0.0, f"histogram (sharded slabs): off by {err4}")
    out["histogram"] = dict(
        shape=f"{n} ids, C={D * C}", max_abs_err=err4,
        form=hops.histogram_plan(n, D * C, torch.cuda.get_device_properties(
            0).multi_processor_count)[0] if DEV == "cuda" else "plain",
        ms=time_ms(lambda: hops.histogram(ids, w, C=D * C), reps=5),
        plain_ms=plain4,
        bound_ms=bound_ms(8 * n + 4 * D * C, n)[0],
        library_ms=time_ms(lambda: torch.bincount(ids, weights=w,
                                                  minlength=D * C), reps=5))
    amap = torch.as_tensor(np.random.default_rng(0).integers(0, P, C),
                           dtype=torch.int32, device=DEV)
    owner = torch.where(live, amap[ch_.long()], P)
    rpd = P // D
    hop = torch.where(torch.div(owner, rpd, rounding_mode="floor") == me,
                      owner, P).reshape(-1)
    g3 = mops.bucket_ranks(hop, C=P)
    w3, plain3 = timed_once(lambda: bucket_ranks_ref(hop, C=P))
    check(torch.equal(g3[0], w3[0]) and torch.equal(g3[1], w3[1]),
          "bucket_ranks (one hop of the sharded exchange) differs from the "
          "plain version")
    out["scatter_dest"] = dict(
        shape=f"{n} ids, C={P} (one ring hop)", max_abs_err=0.0,
        form=mops.scatter_form(n, P),
        ms=time_ms(lambda: mops.bucket_ranks(hop, C=P), reps=5),
        plain_ms=plain3,
        bound_ms=bound_ms(8 * n + 4 * (2 * P + 1), 6 * n)[0],
        library_ms=time_ms(lambda: torch.argsort(hop, stable=True), reps=5))
    for name, r in out.items():
        print(f"{name} at the sharded PIC path's shape ({r['shape']}): "
              f"max_abs_err {r['max_abs_err']}, kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms"
              + (f", library {r['library_ms']:.4f} ms"
                 if "library_ms" in r else ""))
    return out


# -------------------------------------------------------------- kernels --


def kernel_rows(counts, sim_graph, spill):
    import numpy as np
    import torch
    from repro_torch.core import comm_graph, engine
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.diffusion.ref import (diffusion_nsweeps_ref,
                                                   diffusion_sweep_ref)
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.kernels.migrate.ref import scatter_dest_ref
    from repro_torch.kernels.pic_push import ops as pops
    from repro_torch.kernels.pic_push.ref import pic_push_ref
    from repro_torch.pic import chares
    from repro_torch.pic.grid import alternating_grid
    from repro_torch.pic.particles import initialize

    dev = "cuda"
    L, N, C = PIC["L"], PIC["n_particles"], PIC["cx"] * PIC["cy"]
    rows = []

    def row(name, replaces, source, err, tol, ms, plain, bound, lib):
        print(f"{name}: max_abs_err {err:.6g} (tolerance {tol}), kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}), library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces,
                         launches=counts[name],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib))

    # K5 — particle push at the main path's shapes
    p = initialize(PIC["mode"], L, N, k=2, vy0=1.0, rho=PIC["rho"], seed=0)
    x, y, vx, vy, q = (torch.as_tensor(a, device=dev)
                       for a in (p.x, p.y, p.vx, p.vy, p.q))
    grid = torch.as_tensor(alternating_grid(L), device=dev)
    # advance a few steps so positions are off the cell centres
    for _ in range(3):
        x, y, vx, vy = pic_push_ref(grid, x, y, vx, vy, q, L=L)
    got = pops.pic_push(grid, x, y, vx, vy, q, L=L)
    want = pic_push_ref(grid, x, y, vx, vy, q, L=L)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for a, b in zip(got, want):
        sp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) \
            - b.abs()
        check(((a - b).abs() <= sp).all(), "pic_push: more than 1 ulp off")
    row("pic_push", "src/repro/kernels/pic_push/kernel.py:64",
        "src/repro_torch/csrc/pic_push.cu", err, "1 ulp elementwise",
        time_ms(lambda: pops.pic_push(grid, x, y, vx, vy, q, L=L)),
        time_ms(lambda: pic_push_ref(grid, x, y, vx, vy, q, L=L), reps=5),
        bound_ms(9 * 4 * N + 4 * L * L, 95 * N), None)

    # the first plan of the main path on these particles' chare loads
    P = PIC["num_pes"]
    ids = chares.chare_of_device(x, y, L, PIC["cx"], PIC["cy"])
    w = torch.ones(N, device=dev)
    problem = chares.build_problem(
        hops.histogram(ids, w, C=C), torch.as_tensor(
            chares.initial_mapping(PIC["cx"], PIC["cy"], P), device=dev),
        L=L, cx=PIC["cx"], cy=PIC["cy"], num_pes=P, k=2, vy0=1.0,
        lb_period=PIC["lb_every"])
    planned, _ = engine.get_strategy(PIC["strategy"]).bind(
        **PIC["strategy_kwargs"])(problem)

    # K4 — chare loads (weights are ones on the path), in the initial
    # particle order and bucketed by PE as after an exchange (the order
    # every step after the first rebalance gives the kernel)
    ids_x = ids[torch.argsort(planned[ids.long()], stable=True)]
    k4 = {}
    form = hops.histogram_plan(N, C, torch.cuda.get_device_properties(
        0).multi_processor_count)
    for order, i in (("initial", ids), ("after an exchange", ids_x)):
        got, want = hops.histogram(i, w, C=C), histogram_ref(i, w, C=C)
        err = float((got - want).abs().max())
        check(err == 0.0, f"histogram ({order} order): off by {err} on "
              "integer weights")
        k4[order] = (time_ms(lambda: hops.histogram(i, w, C=C)),
                     device_ms(lambda: hops.histogram(i, w, C=C)),
                     time_ms(lambda: torch.bincount(i, weights=w,
                                                    minlength=C)))
        print(f"histogram ({order} order, {form[0]} form, {form[1]} blocks, "
              f"{form[2]} B shared): kernel {k4[order][0]:.4f} ms, device "
              f"{k4[order][1]:.4f} ms, bincount {k4[order][2]:.4f} ms")
    # f32 weights: two calls equal bit for bit (the private form), within
    # 5e-5 of the largest bin of a float64 sum (each thread adds at most a
    # few hundred terms a bin in f32, then fixed trees), and within 1e-3 of
    # the plain version (index_add_'s atomics add ~10^6 terms a bin in any
    # order)
    wf = torch.rand(N, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    for i in (ids, ids_x):
        want64 = torch.zeros(C, dtype=torch.float64, device=dev).index_add_(
            0, i.long(), wf.double())
        scale = float(want64.abs().max())
        got = hops.histogram(i, wf, C=C)
        check(torch.equal(got, hops.histogram(i, wf, C=C)),
              "histogram: two calls with f32 weights differ")
        err64 = float((got.double() - want64).abs().max())
        check(err64 <= 5e-5 * scale, f"histogram: f32 weights {err64} off "
              "a float64 sum")
        errf = float((got - histogram_ref(i, wf, C=C)).abs().max())
        check(errf <= 1e-3 * scale, f"histogram: f32 weights off by {errf}")
    print(f"histogram with f32 weights: two calls equal bit for bit; "
          f"{err64:.6g} off a float64 sum, {errf:.6g} off the plain version "
          f"(largest bin {scale:.6g})")
    x_ms, x_dev, x_lib = k4["after an exchange"]
    check(x_ms < x_lib, f"histogram after an exchange: {x_ms:.4f} ms, not "
          f"below bincount's {x_lib:.4f} ms")
    row("histogram", "src/repro/kernels/histogram/kernel.py:41",
        "src/repro_torch/csrc/histogram.cu", err, "exact (ones)", x_ms,
        time_ms(lambda: histogram_ref(ids_x, w, C=C), reps=5),
        bound_ms(8 * N + 4 * C, N), x_lib)
    rows[-1].update(device_ms=x_dev, initial_ms=k4["initial"][0],
                    initial_device_ms=k4["initial"][1],
                    ordered_ms=K4_ORDERED_MS,
                    forms_by_path=K4_PATH_FORMS)

    # K3 — owners of those particles under a random chare → PE map, in the
    # initial order and bucketed (a stable sort: what an exchange leaves,
    # the order of 8 of the PIC path's 9 calls); every form that takes
    # C = P against the plain version in both orders, padding ids mixed
    # in, two calls bit for bit, dest the inverse of a stable argsort
    from repro_torch.kernels.migrate.ref import bucket_counts_ref

    amap = torch.as_tensor(np.random.default_rng(0).integers(0, P, C),
                           dtype=torch.int32, device=dev)
    owner = amap[ids.long()].contiguous()
    owner_x = owner[torch.argsort(owner, stable=True)].contiguous()
    form = mops.scatter_form(N, P)
    k3 = {}
    for order, o in (("initial", owner), ("bucketed", owner_x)):
        dr, cr = scatter_dest_ref(o, C=P)
        offr = torch.cat([cr.new_zeros(1), torch.cumsum(cr, 0,
                                                        dtype=torch.int32)])
        for f in ("small", "shared"):
            if f == "small" and P > mops.SMALL_MAX_C:
                continue
            got = mops._one_pass(o, P, f)
            check(all(torch.equal(a, b) for a, b in zip(got, (dr, cr, offr))),
                  f"scatter_dest ({order} order, {f} form): differs from the "
                  "plain version")
        got = mops.scatter_dest(o, C=P)
        check(all(torch.equal(a, b) for a, b in zip(got, mops.scatter_dest(
            o, C=P))), f"scatter_dest ({order} order): two calls differ")
        inv = torch.empty_like(got[0])
        inv[got[0].long()] = torch.arange(N, dtype=torch.int32, device=dev)
        check(torch.equal(inv.long(), torch.argsort(o, stable=True)),
              f"scatter_dest ({order} order): not the inverse of a stable "
              "argsort")
        pad = o.clone()
        pad[::7] = -1
        pad[3::11] = P
        gp, wp = mops.scatter_dest(pad, C=P), scatter_dest_ref(pad, C=P)
        check(torch.equal(gp[0], wp[0]) and torch.equal(gp[1], wp[1])
              and torch.equal(gp[1], bucket_counts_ref(pad, C=P)),
              f"scatter_dest ({order} order): padding ids differ")
        k3[order] = dict(
            ms=time_ms(lambda: mops.scatter_dest(o, C=P)),
            device_ms=device_ms(lambda: mops.scatter_dest(o, C=P)),
            host_ms=host_ms(lambda: mops.scatter_dest(o, C=P)),
            argsort_ms=time_ms(lambda: torch.argsort(o, stable=True)))
        print(f"scatter_dest ({order} order, N={N}, C={P}, {form} form): "
              f"exact in every form that takes it, with padding; kernel "
              f"{k3[order]['ms']:.4f} ms, device {k3[order]['device_ms']:.4f}"
              f" ms, host {k3[order]['host_ms']:.4f} ms; argsort "
              f"{k3[order]['argsort_ms']:.4f} ms")
    bx = k3["bucketed"]
    row("scatter_dest", "src/repro/kernels/migrate/kernel.py:99",
        "src/repro_torch/csrc/migrate.cu", 0.0, "exact", bx["ms"],
        time_ms(lambda: scatter_dest_ref(owner_x, C=P), reps=3),
        bound_ms(8 * N + 4 * (2 * P + 1), 6 * N), bx["argsort_ms"])
    rows[-1].update(
        form=form, device_ms=bx["device_ms"], host_ms=bx["host_ms"],
        initial_ms=k3["initial"]["ms"],
        initial_device_ms=k3["initial"]["device_ms"],
        initial_host_ms=k3["initial"]["host_ms"],
        initial_library_ms=k3["initial"]["argsort_ms"],
        floor_12B_ms=1e3 * 12 * N / PEAK_BYTES_PER_S,
        forms_by_path=K3_PATH_FORMS, launches_by_path=K3_LAUNCHES,
        spill=spill)

    # K1 — one S = 8 chunk from the initial carry at the PIC path's shape
    # (the first plan's graph, P = 8, K = 4), the simulator path's (its
    # snapshot's graph, P = 8192, K = 8) and P = 32768, K = 8 on a periodic
    # 2D stencil: every form that takes the shape against the plain chunk
    # (it and stall exact; x, own, flow within 16 ulp of the largest load,
    # the sums over K and P being taken in another order; res within that
    # over the mean load), each form twice bit for bit, and the selected
    # form timed (events and device) beside its bound
    def k1_case(label, nl, nbr, mask, S=8):
        rev = vlb.reverse_slots(nbr, mask)
        Pn, K = nbr.shape
        alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
        res0 = vlb.neighborhood_residual(nl, nbr, mask)
        carry = (nl, nl, torch.zeros((Pn, K), device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev), res0,
                 torch.zeros((), dtype=torch.int32, device=dev))
        args = (*carry, nbr, mask, rev, alpha)
        kw = dict(n_sweeps=S, single_hop=True, tol=0.02, max_iters=512)
        want = diffusion_nsweeps_ref(*args, **kw)
        ulp = spacing(nl)
        errs = {}
        for form in dops.K1_FORMS:
            if not dops.k1_takes(form, Pn, K):
                continue
            got = dops._fused_form(form, *args, **kw)
            check(all(torch.equal(a, b) for a, b in zip(
                got, dops._fused_form(form, *args, **kw))),
                f"diffusion {label}, {form} form: two calls differ")
            check((int(got[3]), int(got[5])) == (int(want[3]), int(want[5])),
                  f"diffusion {label}, {form} form: it/stall "
                  f"{int(got[3])}/{int(got[5])} vs {int(want[3])}/"
                  f"{int(want[5])}")
            err = max(float((got[i] - want[i]).abs().max())
                      for i in (0, 1, 2))
            err_res = abs(float(got[4]) - float(want[4])) * float(nl.mean())
            errs[form] = (err, max(err, err_res) / ulp)
            check(errs[form][1] <= 16, f"diffusion {label}, {form} form: "
                  f"{errs[form][1]:.1f} ulp off")
        form = dops.k1_form(Pn, K)
        sweeps = int(want[3])
        nbytes = 4 * (2 * Pn + Pn * K) * 2 + 9 * Pn * K
        ops = sweeps * (15 * Pn * K + 10 * Pn)
        out = dict(form=form, err=max(e[0] for e in errs.values()),
                   err_u=max(e[1] for e in errs.values()), sweeps=sweeps,
                   ms=time_ms(lambda: dops.fused_nsweeps(*args, **kw)),
                   device_ms=device_ms(lambda: dops.fused_nsweeps(*args,
                                                                  **kw)),
                   plain=time_ms(lambda: diffusion_nsweeps_ref(*args, **kw),
                                 reps=5),
                   bound=bound_ms(nbytes, ops))
        print(f"diffusion_nsweeps ({label}, {sweeps} sweeps, {form} form): "
              f"ulp off the plain chunk by form "
              f"{ {f: round(e[1], 2) for f, e in errs.items()} }, kernel "
              f"{out['ms']:.4f} ms, device {out['device_ms']:.4f} ms, plain "
              f"{out['plain']:.4f} ms, bound {out['bound'][0]:.6f} ms "
              f"({out['bound'][1]})")
        return out

    nres = ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(problem)), k=4)
    pic = k1_case("P=8, K=4, the PIC path", comm_graph.node_loads(problem),
                  nres.nbr_idx, nres.nbr_mask)
    sim = k1_case("P=8192, K=8, the simulator path", *sim_graph)
    side = (128, 256)
    ii, jj = np.meshgrid(np.arange(side[0]), np.arange(side[1]),
                         indexing="ij")
    nb = [((ii + di) % side[0]) * side[1] + (jj + dj) % side[1]
          for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]
    nbr = torch.as_tensor(np.stack([a.ravel() for a in nb], 1),
                          dtype=torch.int32, device=dev)
    nl = torch.as_tensor(np.random.default_rng(1).random(nbr.shape[0]) * 100,
                         dtype=torch.float32, device=dev)
    big = k1_case("P=32768, K=8", nl, nbr, torch.ones_like(nbr,
                                                           dtype=torch.bool))
    row("diffusion_nsweeps", "src/repro/kernels/diffusion/kernel.py:198",
        "src/repro_torch/csrc/diffusion.cu", max(pic["err"], sim["err"]),
        "16 ulp of the largest load", pic["ms"], pic["plain"], pic["bound"],
        None)
    rows[-1].update(
        form=pic["form"], device_ms=pic["device_ms"], sim_form=sim["form"],
        sim_ms=sim["ms"], sim_device_ms=sim["device_ms"],
        sim_bound_ms=sim["bound"][0], p32768_form=big["form"],
        p32768_ms=big["ms"], p32768_device_ms=big["device_ms"],
        p32768_bound_ms=big["bound"][0], forms_by_path=K1_PATH_FORMS)

    # K2 — one sweep of the simulator path's stage 2 (its first sweep, on
    # the full-size snapshot's neighbour table), then the whole stage 2
    # with the kernel and with the plain sweep as step_fn
    nl, nbr, mask = sim_graph
    Pn, K = nbr.shape
    rev = vlb.reverse_slots(nbr, mask)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    sw = (nl, nl, nbr, mask, rev, alpha, True)
    got = dops.diffusion_sweep(*sw)
    want = diffusion_sweep_ref(*sw)
    ulp = spacing(nl)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(err <= 8 * ulp, f"diffusion_sweep: {err / ulp:.1f} ulp off")
    vk = vlb.virtual_balance(nl, nbr, mask, step_fn=dops.diffusion_sweep)
    vp = vlb.virtual_balance(nl, nbr, mask, step_fn=diffusion_sweep_ref)
    check(int(vk.iters) == int(vp.iters),
          f"stage 2 with diffusion_sweep: {int(vk.iters)} sweeps, with the "
          f"plain sweep {int(vp.iters)}")
    err_v = max(float((vk.target_loads - vp.target_loads).abs().max()),
                float((vk.flows - vp.flows).abs().max()))
    check(err_v <= 64 * ulp, f"stage 2 with diffusion_sweep: "
          f"{err_v / ulp:.1f} ulp off the plain sweep")
    dms = device_ms(lambda: dops.diffusion_sweep(*sw))
    print(f"diffusion_sweep at P={Pn}, K={K}: one sweep {err / ulp:.1f} ulp "
          f"off the plain version; stage 2 {int(vk.iters)} sweeps, "
          f"{err_v / ulp:.1f} ulp; device time of its two kernels "
          f"{dms:.4f} ms a sweep (CUDA events behind a sleep)")
    row("diffusion_sweep", "src/repro/kernels/diffusion/kernel.py:100",
        "src/repro_torch/csrc/diffusion_sweep.cu", err,
        "8 ulp of the largest load",
        time_ms(lambda: dops.diffusion_sweep(*sw)),
        time_ms(lambda: diffusion_sweep_ref(*sw)),
        bound_ms(16 * Pn + 13 * Pn * K, 8 * Pn * K + 5 * Pn), None)
    return rows


def main() -> int:
    global SMI
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    SMI = smi
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # f32 products in full f32 on the card (the defaults, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {sorted(kernels.registry())} in "
          f"{time.perf_counter() - t0:.1f} s")

    counts, pic_diff, pic_none = main_path()
    cpu_parity()
    host_pic_path(dict(steps=PIC["steps"], wall_seconds=pic_diff.wall_seconds,
                       lb_seconds=pic_diff.lb_seconds), pic_none)
    sim_counts, snap = sim_path()
    sim_graph, step_counts = sim_engines(snap)
    k4_ordered_check(snap)
    paper_scripts_and_small_replay()
    host_and_batched_replays()
    paper_scripts_host()
    serve_counts = serve_path()
    serve_cpu_parity()
    spill_counts = serve_spill()
    spill = spill_sizes()
    fleet_counts = fleet_path()
    serve_bench_gates()
    fleet_cpu_parity()
    two_level(snap)
    sharded_counts = sharded_pic(pic_diff)
    sharded_series(RESULTS["sim"])
    resilience_phase()
    exchange_phase()
    sharded_fleet(RESULTS["fleet"])
    fig5_sharded()
    sharded_k = sharded_kernel_checks()
    fam_counts = families_path()
    ep_counts = ep_replay_phase()
    ep_sharded_phase()
    ep_bench_gates()
    K3_LAUNCHES.update(PIC=counts["scatter_dest"],
                       serving=serve_counts["scatter_dest"],
                       serving_spill=spill_counts["scatter_dest"],
                       fleet=fleet_counts["scatter_dest"])
    print(f"fleet path launches: {fleet_counts}")
    # each kernel's launches on its own paths' runs (K3 on the PIC path's
    # and the fleet's; K1 on the PIC, simulator and fleet paths together;
    # K4 on the PIC path's and the fleet's; K2 in the step_fn plan)
    for name in FLEET_KERNELS:
        counts[name] += fleet_counts[name]
    # and on the EP replay's run (phase 14)
    for name in EP_KERNELS:
        counts[name] += ep_counts[name]
    counts["diffusion_nsweeps"] += sim_counts["diffusion_nsweeps"]
    counts["diffusion_sweep"] = step_counts["diffusion_sweep"]
    # K6 on the serving path and on each model family's path of phase 13
    counts["flash_attention"] = (serve_counts["flash_attention"]
                                 + sum(fam_counts.values()))
    print(f"K1 calls by form on each path: {K1_PATH_FORMS}; K2 launches "
          f"in the step_fn plan: {counts['diffusion_sweep']}; K3 calls by "
          f"form on each path: {K3_PATH_FORMS}, launches {K3_LAUNCHES}; "
          f"K4 calls by form on each path: {K4_PATH_FORMS}")
    rows = kernel_rows(counts, sim_graph, spill)
    rows.append(flash_row(counts))
    # phase 15 after the kernel checks; its launches join the rows below
    training_phase()
    # K6 on phase 15's training paths too; its backward only there
    train_k6 = {p: n["flash_attention"] for p, n in TRAIN_LAUNCHES.items()}
    rows[-1]["launches"] += sum(train_k6.values())
    rows[-1]["launches_by_path"] = {
        f"serving ({SERVE_ARCH})": serve_counts["flash_attention"],
        **fam_counts, **{f"training {p}": n for p, n in train_k6.items()}}
    counts["flash_attention_bwd"] = sum(
        n["flash_attention_bwd"] for n in TRAIN_LAUNCHES.values())
    # K6's backward, listed under K6's row: its own row beside it, and its
    # numbers inside K6's row
    rows.append(flash_bwd_row(counts))
    # the forward at the training path's shape, measured there
    rows[-2]["training"] = rows[-1].pop("training_forward")
    rows[-2]["backward"] = {k: v for k, v in rows[-1].items()
                            if k not in ("name", "route", "replaces")}
    check(len(rows) == 7, f"{len(rows)} kernel rows, not 7")
    # K1, K3 and K4 on phase 14's paths (the EP replay, the relocation) and
    # on phase 15's (the EP-balanced training, the data pipeline)
    for r in rows:
        if r["name"] in EP_KERNELS:
            r.setdefault("launches_by_path", {}).update({
                f"EP {p}": n[r["name"]] for p, n in EP_LAUNCHES.items()})
            r["launches_by_path"].update({
                f"training {p}": n[r["name"]]
                for p, n in TRAIN_LAUNCHES.items() if n[r["name"]]})
            r["launches"] += sum(n[r["name"]]
                                 for n in TRAIN_LAUNCHES.values())
    # K3, K4 and K5 at the sharded PIC path's shapes, with their launches
    # on that path's run
    for r in rows:
        if r["name"] in sharded_k:
            r["sharded_pic"] = dict(sharded_k[r["name"]],
                                    launches=sharded_counts[r["name"]])
    print(json.dumps({"sharded": SHARDED}))
    print(json.dumps({"families": FAMILIES}))
    print(json.dumps({"expert_balancing": EPB}))
    print(json.dumps({"training": TRAINING}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
