#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the six CUDA kernels from ``src/repro_torch/csrc``, then:

  1. drives the PIC path — the PIC PRK driver with the diff-comm balancer
     (``repro_torch.pic.driver.run``) at the paper's setup (L = 1000, 12×12
     chares, GEOMETRIC ρ = 0.9, 8 PEs), 2^24 particles, 100 steps, LB every
     10 — with every launch count set to 0 just before and read just after,
     and checks its invariants against a ``strategy="none"`` run of the
     same configuration;
  2. checks a small PIC run on the card against the same run on the CPU
     (plain PyTorch versions);
  3. drives the simulator path — ``repro_torch.sim.simulator.run_series``
     on the ``stencil-wave`` scenario at grid 1024 × 1024 (2^20 objects,
     5-point edges) over 8192 nodes tiled 64 × 128, diff-comm k = 8, 30
     steps, LB every 10 — with the launch counts set to 0 just before and
     read just after, and checks it against a ``strategy="none"`` replay;
  4. plans the first fired step's snapshot through
     ``LBEngine(step_fn=ops.diffusion_sweep)`` and the default engine, and
     stage 2 through the streaming kernel against the fused one;
  5. runs the port's Table I and Fig 2 scripts on the card, and a small
     replay on the card against the same replay on the CPU;
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
  8. holds each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (and the fused diffusion kernel also at
     P = 32768, K = 8), timing kernel, plain version and the one-call
     PyTorch yardstick where there is one; K6 in the form its selection
     rule names for each case (split decode, tensor-core bf16 prefill,
     SIMT f32 prefill), and its decode also cold: 26 caches, one a layer,
     rotated from call to call as on the serving path.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once where ``torch.cuda.is_available()`` is False.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

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
SIM_KERNELS = ("diffusion_sweep",)

# the serving path: gemma3-1b at full width on two replicas; prompts stay
# within the 1024-token window (a longer prefill would write several
# positions into one ring slot at once), and the two longest decode past it
SERVE_ARCH = "gemma3-1b"
SERVE_FULL = True            # the published config; a rehearsal: reduced
SERVE = dict(replicas=2, slots=4, max_len=1056, dtype="bfloat16",
             max_new=32,
             prompt_lens=(1000, 996, 512, 576, 640, 704, 768, 832))
SERVE_KERNELS = ("flash_attention", "scatter_dest")
DEV = "cuda"   # the card; a rehearsal on the CPU sets "cpu"


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


def bound_ms(nbytes: float, ops: float, peak_ops=PEAK_F32_PER_S):
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def spacing(v) -> float:
    """f32 spacing at max |v| (one ulp there)."""
    import torch

    s = v.abs().max()
    return float(torch.nextafter(s, s + 1) - s)


# ------------------------------------------------------------ main path --


def main_path():
    import numpy as np
    from repro_torch import kernels
    from repro_torch.pic import chares, driver

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.run(driver.PICConfig(**PIC, device="cuda"))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"PIC path: {PIC['n_particles']} particles, {PIC['steps']} steps "
          f"in {wall:.3f} s end to end ({res.wall_seconds:.3f} s step loop, "
          f"{PIC['steps'] / res.wall_seconds:.2f} steps/s); launches "
          f"{counts}")
    for name in PIC_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the PIC "
              "path")

    N = PIC["n_particles"]
    fx, fy = res.final_x, res.final_y
    check(fx.shape == (N,) and fy.shape == (N,), "particles not conserved")
    check(np.isfinite(fx).all() and np.isfinite(fy).all(),
          "non-finite positions")
    check(((fx >= 0) & (fx <= PIC["L"]) & (fy >= 0)
           & (fy <= PIC["L"])).all(), "positions left the grid")
    import torch

    xt = torch.as_tensor(fx, device="cuda")
    yt = torch.as_tensor(fy, device="cuda")
    from repro_torch.kernels.histogram.ops import histogram

    loads = histogram(chares.chare_of_device(xt, yt, PIC["L"], PIC["cx"],
                                             PIC["cy"]),
                      torch.ones_like(xt), C=PIC["cx"] * PIC["cy"])
    check(float(loads.sum()) == N, f"chare loads sum to {float(loads.sum())}"
          f", not {N}")
    fired = int(res.lb_steps.sum())
    check(fired == (PIC["steps"] - 1) // PIC["lb_every"],
          f"LB fired {fired} times")
    check(res.migrated_bytes.sum() > 0, "no particle was migrated")

    none = driver.run(driver.PICConfig(**{**PIC, "strategy": "none"},
                                       device="cuda"))
    bal, ref = res.summary()["mean_max_avg"], none.summary()["mean_max_avg"]
    print(f"mean max/avg: diff-comm {bal:.6f} vs none {ref:.6f}; migrated "
          f"{res.migrated_bytes.sum():.0f} B over {fired} rebalances")
    check(bal < ref, "diff-comm did not lower mean max/avg below none")
    return counts, res


def cpu_parity():
    """A small PIC run on the card equals the same run on the CPU."""
    import numpy as np
    from repro_torch.pic import driver

    small = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
                 lb_every=10, strategy="diff-comm")
    g = driver.run(driver.PICConfig(**small, device="cuda"))
    c = driver.run(driver.PICConfig(**small, device="cpu"))
    for f in ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
              "int_bytes", "max_avg"):
        check(np.array_equal(getattr(g, f), getattr(c, f)),
              f"small PIC run: {f} differs between cuda and cpu")
    err = max(np.abs(g.final_x - c.final_x).max(),
              np.abs(g.final_y - c.final_y).max())
    check(err <= 1e-3, f"small PIC run: positions differ by {err}")
    print(f"small PIC run on cuda == cpu (positions within {err:.3g})")


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
          f"fused kernel up to P*K = {dops.FUSED_MAX_PK})")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = simulator.run_series(problem, evolve, **SIM)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
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
    return counts, evolve(problem, fired[0])


def sim_engines(snap):
    """Plan the snapshot through ``LBEngine(step_fn=ops.diffusion_sweep)``
    and the default engine, then stage 2 through the fused kernel against
    the streaming one; returns the stage-2 inputs ``(loads, nbr, mask)``."""
    import numpy as np
    import torch
    from repro_torch.core import comm_graph, engine, metrics
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import object_selection as osel
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops

    K = SIM["strategy_kwargs"]["k"]
    step = engine.LBEngine(k=K, step_fn=dops.diffusion_sweep,
                           device=DEV).plan(snap)
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
    # stage 2 three ways: K1 forced, the selected streaming chunk (K2 in a
    # replayed CUDA graph), and K2 issued sweep by sweep (step_fn)
    fused, s2f = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.fused_nsweeps))
    stream, s2s = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.diffusion_nsweeps))
    eager, s2e = timed(lambda: vlb.virtual_balance(
        *args, step_fn=dops.diffusion_sweep))
    a_f, s3 = timed(lambda: osel.select_objects(
        snap, nres.nbr_idx, nres.nbr_mask, fused.flows).assignment)
    a_s = osel.select_objects(snap, nres.nbr_idx, nres.nbr_mask,
                              stream.flows).assignment
    print(f"stages at full size: 1 (neighbor selection) {s1:.3f} s, "
          f"{int(nres.rounds)} rounds; 2 fused {s2f:.3f} s / streaming "
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
    return args


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


# --------------------------------------------------------- serving path --


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

    def instrument(e):
        # synchronized timing around the engine's own prefill and tick,
        # and the finiteness of every logits row they produce
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

    for e in engines:
        instrument(e)
    rng = np.random.default_rng(0)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels.flash_attention import ops as fops

    kernels.reset_launch_counts()
    forms0 = dict(fops.form_launches)
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


def serve_cpu_parity():
    """The reduced gemma3-1b in f32 served on the card and on the CPU:
    equal tokens, and prefill/decode logits within 1e-3."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_to
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch(SERVE_ARCH).reduced,
                              compute_dtype="float32")
    p_cpu = init_params(transformer.model_specs(cfg), 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (9, 14, 11)]
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
        logits[dev] = torch.cat(seq).cpu()
    check(outs["cpu"] == outs[DEV], "reduced gemma3-1b: tokens differ "
          f"between {DEV} and cpu")
    err = float((logits["cpu"] - logits[DEV]).abs().max())
    check(err <= 1e-3, f"reduced gemma3-1b: logits differ by {err}")
    print(f"reduced gemma3-1b served on {DEV} == cpu: 3 requests, equal "
          f"tokens; prefill and 10 decode steps' logits within {err:.3g}")


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
        B, Sq = qp.shape
        qs = q.to(k.dtype).reshape(B, Sq, KV * G, hd).transpose(1, 2)
        qs = qs.contiguous()
        ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        am = mask(qp, kp, win, 0)[:, None].contiguous()
        return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=am)

    def bound(q, k, qp, kp, win):
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
    cases = [  # label, B, Sq, T, window, q_last, q dtype, cache dtype
        ("prefill, global cache", 1, 1000, 1056, 0, [999], bf16, bf16),
        ("prefill, window ring", 1, 1000, W, W, [999], bf16, bf16),
        ("decode, global cache", 4, 1, 1056, 0, tick, bf16, bf16),
        ("decode, wrapped window ring", 4, 1, W, W, tick, bf16, bf16),
        ("prefill, global cache, f32", 1, 1000, 1056, 0, [999], f32, f32),
        ("decode, global cache, f32 cache", 4, 1, 1056, 0, tick, bf16, f32),
    ]
    errs, res = [], {}
    for label, B, Sq, T, win, q_last, dt, kdt in cases:
        q = torch.randn((B, Sq, KV, G, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(kdt)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(kdt)
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

    # the decode tick's global layers as the path reads them: one cache a
    # layer (26 x 4.9 MB, past the 50 MB L2), rotated from call to call
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
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:96",
                launches=counts["flash_attention"], max_abs_err=max(errs),
                ms=p_ms, plain_ms=p_plain, bound_ms=p_bound[0],
                bound_by=p_bound[1], library_ms=p_lib, decode_ms=d_ms,
                decode_cold_ms=cold, decode_bound_ms=d_bound[0],
                decode_library_ms=d_lib,
                decode_f32_cache_ms=res["decode, global cache, f32 cache"][0])


def device_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn()`` per call: the sum of its kernels' intervals
    under ``torch.profiler``, over ``reps`` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and "_kernel" in e.name)
    return us / 1e3 / reps


# -------------------------------------------------------------- kernels --


def kernel_rows(counts, sim_graph):
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

    # K4 — chare loads (weights are ones on the path).  After an exchange
    # the particles lie bucketed by PE, so a warp sees few distinct chares
    # and its shared-memory atomics contend: time that order, which every
    # step after the first rebalance gives the kernel, and the initial one
    ids_x = ids[torch.argsort(planned[ids.long()], stable=True)]
    for order, i in (("initial", ids), ("after an exchange", ids_x)):
        got, want = hops.histogram(i, w, C=C), histogram_ref(i, w, C=C)
        err = float((got - want).abs().max())
        check(err == 0.0, f"histogram ({order} order): off by {err} on "
              "integer weights")
    print(f"histogram in the initial particle order: kernel "
          f"{time_ms(lambda: hops.histogram(ids, w, C=C)):.4f} ms")
    wf = torch.rand(N, device=dev, generator=torch.Generator(dev).manual_seed(0))
    errf = float((hops.histogram(ids_x, wf, C=C)
                  - histogram_ref(ids_x, wf, C=C)).abs().max())
    # the plain version's float atomics add ~10^6 terms a bin in any order
    check(errf <= 1e-3 * float(histogram_ref(ids_x, wf, C=C).abs().max()),
          f"histogram: float weights off by {errf}")
    row("histogram", "src/repro/kernels/histogram/kernel.py:41",
        "src/repro_torch/csrc/histogram.cu", err, "exact (ones)",
        time_ms(lambda: hops.histogram(ids_x, w, C=C)),
        time_ms(lambda: histogram_ref(ids_x, w, C=C), reps=5),
        bound_ms(8 * N + 4 * C, N),
        time_ms(lambda: torch.bincount(ids_x, weights=w, minlength=C)))

    # K3 — owner ids of those particles under a rebalanced mapping
    amap = torch.as_tensor(np.random.default_rng(0).integers(0, P, C),
                           dtype=torch.int32, device=dev)
    owner = amap[ids.long()]
    dg, cg = mops._scatter_dest_cuda(owner, P)
    dr, cr = scatter_dest_ref(owner, C=P)
    check(torch.equal(dg, dr) and torch.equal(cg, cr),
          "scatter_dest: kernel differs from plain version")
    inv = torch.empty_like(dg)
    inv[dg.long()] = torch.arange(N, dtype=torch.int32, device=dev)
    check(torch.equal(inv.long(), torch.argsort(owner, stable=True)),
          "scatter_dest: not the inverse of a stable argsort")
    pad = owner.clone()
    pad[::7] = -1
    check(all(torch.equal(a, b) for a, b in zip(
        mops._scatter_dest_cuda(pad, P), scatter_dest_ref(pad, C=P))),
        "scatter_dest: padding ids differ")
    row("scatter_dest", "src/repro/kernels/migrate/kernel.py:99",
        "src/repro_torch/csrc/migrate.cu", 0.0, "exact",
        time_ms(lambda: mops._scatter_dest_cuda(owner, P)),
        time_ms(lambda: scatter_dest_ref(owner, C=P), reps=5),
        bound_ms(8 * N + 4 * P, 6 * N),
        time_ms(lambda: torch.argsort(owner, stable=True)))

    # K1 — the first plan's stage-2 chunk (P = 8, K = 4, S = 8), and
    # P = 32768, K = 8 on a periodic 2D stencil for the simulator slice
    def k1_case(nl, nbr, mask, S):
        rev = vlb.reverse_slots(nbr, mask)
        Pn, K = nbr.shape
        alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
        res0 = vlb.neighborhood_residual(nl, nbr, mask)
        carry = (nl, nl, torch.zeros((Pn, K), device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev), res0,
                 torch.zeros((), dtype=torch.int32, device=dev))
        kw = dict(n_sweeps=S, single_hop=True, tol=0.02, max_iters=512)
        got = dops.fused_nsweeps(*carry, nbr, mask, rev, alpha, **kw)
        want = diffusion_nsweeps_ref(*carry, nbr, mask, rev, alpha, **kw)
        check(int(got[3]) == int(want[3]) and int(got[5]) == int(want[5]),
              f"diffusion P={Pn}: it/stall {int(got[3])}/{int(got[5])} vs "
              f"{int(want[3])}/{int(want[5])}")
        # x, own, flow within 16 ulp of the largest load (sums over K and
        # P are taken in another order); res, a deviation over the mean
        # load, within that over the mean load
        ulp = spacing(nl)
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1, 2))
        err_res = abs(float(got[4]) - float(want[4])) * float(nl.mean())
        err_u = max(err, err_res) / ulp
        check(err_u <= 16, f"diffusion P={Pn}: {err_u:.1f} ulp off")
        sweeps = int(got[3])
        nbytes = 4 * (2 * Pn + Pn * K) * 2 + 9 * Pn * K
        ops = sweeps * (15 * Pn * K + 10 * Pn)
        return (err, err_u, sweeps,
                time_ms(lambda: dops.fused_nsweeps(
                    *carry, nbr, mask, rev, alpha, **kw)),
                time_ms(lambda: diffusion_nsweeps_ref(
                    *carry, nbr, mask, rev, alpha, **kw), reps=5),
                bound_ms(nbytes, ops))

    nres = ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(problem)), k=4)
    err, err_u, sweeps, ms, plain, bound = k1_case(
        comm_graph.node_loads(problem), nres.nbr_idx, nres.nbr_mask, 8)
    print(f"diffusion P=8: {sweeps} sweeps, {err_u:.1f} ulp")
    row("diffusion_nsweeps", "src/repro/kernels/diffusion/kernel.py:198",
        "src/repro_torch/csrc/diffusion.cu", err, "16 ulp of the largest load",
        ms, plain, bound, None)

    side = (128, 256)
    ii, jj = np.meshgrid(np.arange(side[0]), np.arange(side[1]),
                         indexing="ij")
    nb = [((ii + di) % side[0]) * side[1] + (jj + dj) % side[1]
          for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]
    nbr = torch.as_tensor(np.stack([a.ravel() for a in nb], 1),
                          dtype=torch.int32, device=dev)
    mask = torch.ones_like(nbr, dtype=torch.bool)
    nl = torch.as_tensor(np.random.default_rng(1).random(nbr.shape[0]) * 100,
                         dtype=torch.float32, device=dev)
    err, err_u, sweeps, ms, plain, bound = k1_case(nl, nbr, mask, 8)
    print(f"diffusion_nsweeps at P=32768, K=8 (global-memory state): "
          f"{sweeps} sweeps, max_abs_err {err:.6g} ({err_u:.1f} ulp), kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]})")

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
          f"{dms:.4f} ms a sweep (profiler)")
    row("diffusion_sweep", "src/repro/kernels/diffusion/kernel.py:100",
        "src/repro_torch/csrc/diffusion_sweep.cu", err,
        "8 ulp of the largest load",
        time_ms(lambda: dops.diffusion_sweep(*sw)),
        time_ms(lambda: diffusion_sweep_ref(*sw)),
        bound_ms(16 * Pn + 13 * Pn * K, 8 * Pn * K + 5 * Pn), None)
    return rows


def main() -> int:
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # f32 products in full f32 on the card (the defaults, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {sorted(kernels.registry())} in "
          f"{time.perf_counter() - t0:.1f} s")

    counts, _ = main_path()
    cpu_parity()
    sim_counts, snap = sim_path()
    sim_graph = sim_engines(snap)
    paper_scripts_and_small_replay()
    serve_counts = serve_path()
    serve_cpu_parity()
    # each kernel's launches on its own path's run (K3 on the PIC path's)
    counts.update({name: sim_counts[name] for name in SIM_KERNELS})
    counts["flash_attention"] = serve_counts["flash_attention"]
    rows = kernel_rows(counts, sim_graph)
    rows.append(flash_row(counts))
    check(len(rows) == 6, f"{len(rows)} kernel rows, not 6")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
