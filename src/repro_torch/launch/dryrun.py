"""Dry run on one card: every (arch × shape) cell's FLOPs, bytes and
memory without allocating the model (counterpart of
``repro.launch.dryrun``).

The JAX driver lowers and compiles each cell's jitted entry point against
``ShapeDtypeStruct`` inputs and reads XLA's memory and cost analyses and
the compiled HLO.  Eager PyTorch has no compile step; here each cell's
entry point — ``train_step.make_train_step`` for a train shape, the
model's ``prefill`` or ``decode_step`` for the others — runs once under
``torch._subclasses.fake_tensor.FakeTensorMode`` on the CPU device:
every tensor is a fake one (shape, type, no storage), so nothing is
allocated and no kernel is launched.  Attention is traced as the card
runs it, not as its plain version: for the trace the model's
``flash_attention`` is :func:`card_flash_attention`, two operations
(K6's forward and backward) whose FLOPs are the (query, key) pairs the
masks allow (:func:`attended_pairs`, which K6's tile skipping follows)
and whose bytes are their operands once, where the plain version would
count every (S, T) score of its chunk loops.  Every other operation is
the one the card runs too.  Each operation it dispatches is seen by

  * ``torch.utils.flop_counter.FlopCounterMode``: ``cost.flops`` (the
    products: matmuls, batched matmuls, convolutions, K6);
  * :class:`Traffic`, a ``TorchDispatchMode`` that adds every operation's
    input and output bytes into ``cost.bytes_accessed`` (views move
    nothing and are skipped), counts operations by aten name
    (``op_census``) and follows the live fake storages from their first
    appearance to their release (``memory.peak_device_bytes``).  The
    bytes are unfused traffic, each operation's operands read from and
    its results written to memory: an upper bound that a fused program
    (XLA's count, or the card's kernels) undercuts;
  * ``memory.argument_bytes``: exact, from the parameter, optimizer-state
    and input trees.

Three mesh kinds.  ``single``: one card, ``chips = 1``,
``collective_bytes = 0``.  ``pod`` and ``multi``: the JAX dry run's two
production meshes, (data 16, model 16) on 256 cards (the JAX package's
"single") and (pod 2, data 16, model 16) on 512 ("multi").  A mesh cell
is traced as rank 0 of that mesh runs it (``distributed.mesh.TraceMesh``,
the process mesh's code with no process group): its blocks of the
parameters and optimizer state (``sharding.train_placements``), of the
batch (``data_placements``) and of the cache (``init_cache(mesh=...)``,
``cache_placements``) under the JAX rules, the "2d" profile on the cache
paths where the config says "dp" (``transformer.serving_layout``, as the
JAX dry run switches it).  The record adds the mesh's collectives by
kind, with the bytes ``launch/hlo.py`` puts on the wire (all-gather: the
result's; all-reduce: twice the operand's, and no process-mesh
collective is one; the others: the operand's), their sum, and a
``t_collective`` term: each group's bytes over one link rate, stated
with its source — NVLink 4 at 450 GB/s a direction within an 8-card HGX
H100 node, 400 Gb/s NDR InfiniBand (50 GB/s) a card across nodes (data
sheet figures, not measurements; rank 0's group over an axis is within
one node where its members are ranks 0-7).  ``fits`` is the peak against
one 80 GB card's memory.  ``remat`` "auto" (the default) is the JAX dry
run's on the pod meshes — "full" for a train shape, "none" otherwise —
and on the one-card mesh the training launcher's "none" (the first
ledger cell's setting); an explicit ``--remat`` wins on every mesh.
The JAX package's ``launch/hlo.py`` (an HLO text parser: loop-aware
FLOPs and traffic, collectives, while-loop trip counts) has no
counterpart: the dispatch counts above replace its FLOPs, traffic and
census, the mesh's own census its collectives, and eager PyTorch has no
while-loop trip counts (``PERF.md`` §3).  A cell whose trace fails (a
data-dependent shape under fake tensors, say) is recorded with
``status: "fail"`` and its error, as the JAX driver records it.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``;
``benchmarks_torch/roofline.py`` reads them.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--mesh pod]                  # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--workers 4] \\
      [--mesh single|pod|multi|both] [--shape train_4k]  # both: pod, multi
  ... --remat full --set moe_impl=dense --tag myexp   # overrides
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.configs import (SHAPES, get_arch, input_specs, list_archs,
                                 shape_applicable)
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import COLLECTIVES, TraceMesh
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                     combine_partials,
                                                     split_partials)
from repro_torch.models import attention, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import count_params, shape_dtype_tree, tree_map

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# NVIDIA H100 SXM (data sheet, at the 700 W limit; PERF.md §3 layer 6)
PEAK_FLOPS = 989e12          # bf16 dense tensor cores, FLOP/s
HBM_BW = 3.35e12             # bytes/s
#: the H100 80GB HBM3's memory as torch reports it (total_memory)
DEVICE_BYTES = 85_017_493_504
#: the mesh kinds: None one card; the JAX dry run's production meshes
MESHES = {"single": None, "pod": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}
#: link rates a card (bytes/s, one direction; data sheets): NVLink 4
#: within an 8-card HGX H100 node, 400 Gb/s NDR InfiniBand across nodes
NVLINK_BW = 450e9
NDR_BW = 50e9
NODE_CARDS = 8


def active_params(cfg: ModelConfig) -> Dict[str, int]:
    """Total and per-token-active parameter counts (MoE-aware)."""
    specs = transformer.model_specs(cfg)
    total = count_params(specs)
    if cfg.moe is None:
        return dict(total=total, active=total)
    m = cfg.moe
    expert_p = 3 * cfg.d_model * m.d_expert
    n_moe = sum(1 for k in cfg.all_layers() if k.startswith("moe"))
    inactive = n_moe * (m.num_experts - m.top_k) * expert_p
    return dict(total=total, active=total - inactive)


def model_flops(cfg: ModelConfig, shape) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    p = active_params(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * p * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * p * shape.global_batch * shape.seq_len
    return 2.0 * p * shape.global_batch            # decode: 1 token/seq


def apply_overrides(cfg: ModelConfig, overrides: Dict[str, str]) -> ModelConfig:
    """--set key=value model-config overrides for perf experiments: the
    JAX driver's keys that the port reads (its ``sharding`` and ``ep``
    name GSPMD layouts, which one card does not have)."""
    kw: Dict[str, Any] = {}
    for k, v in overrides.items():
        if k == "moe_impl":
            assert cfg.moe is not None
            kw["moe"] = dataclasses.replace(cfg.moe, impl=v)
        elif k in ("sliding_window", "vision_prefix"):
            kw[k] = int(v)
        elif k in ("compute_dtype", "param_dtype"):
            kw[k] = v
        else:
            raise ValueError(f"unknown override {k!r}: one of moe_impl, "
                             "sliding_window, vision_prefix, compute_dtype, "
                             "param_dtype")
    return dataclasses.replace(cfg, **kw) if kw else cfg


# ---------------------------------------------- K6 as the card runs it --


def attended_pairs(Sq: int, T: int, window: int = 0,
                   prefix_len: int = 0) -> int:
    """(query, key) pairs the causal, window and prefix masks allow for one
    batch row and head, with the queries at the last ``Sq`` and the keys
    at the last ``T`` positions of a sequence of ``max(Sq, T)``: a train
    step or a prefill from position 0, a decode step over a full cache or
    ring.  A trace has no positions (fake tensors), so these stand in."""
    n = max(Sq, T)
    p = np.arange(n - Sq, n, dtype=np.int64)          # query positions
    first = n - T                                     # first key position
    lo = np.maximum(first, p - window + 1) if window else np.full_like(
        p, first)
    causal = np.maximum(p - lo + 1, 0)
    if not prefix_len:
        return int(causal.sum())
    last = min(prefix_len, n) - 1                     # last prefix key
    prefix = max(last - first + 1, 0)
    both = np.maximum(np.minimum(p, last) - lo + 1, 0)
    return int((causal + prefix - both).sum())


def _pairs(q, k, window, prefix_len) -> int:
    B, Sq, KV, G, _ = q
    return B * KV * G * attended_pairs(Sq, k[1], window, prefix_len)


@torch.library.custom_op(
    "repro_torch_dryrun::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_pos, Tensor kv_pos, "
           "int window, int prefix_len) -> Tensor")
def _k6(q, k, v, q_pos, kv_pos, window, prefix_len):
    return chunked_attention(q, k, v, q_pos, kv_pos, window=window,
                             prefix_len=prefix_len).clone()


@torch.library.custom_op(
    "repro_torch_dryrun::flash_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_pos, Tensor kv_pos, "
           "Tensor o, Tensor do, int window, int prefix_len) -> "
           "(Tensor, Tensor, Tensor)")
def _k6_bwd(q, k, v, q_pos, kv_pos, o, do, window, prefix_len):
    # below autograd here: torch.func's vjp, not attention_bwd_ref's grad
    _, vjp = torch.func.vjp(
        lambda q, k, v: chunked_attention(q, k, v, q_pos, kv_pos,
                                          window=window,
                                          prefix_len=prefix_len), q, k, v)
    return tuple(g.clone() for g in vjp(do))


@_k6.register_fake
def _(q, k, v, q_pos, kv_pos, window, prefix_len):
    return torch.empty_like(q)


@_k6_bwd.register_fake
def _(q, k, v, q_pos, kv_pos, o, do, window, prefix_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _k6_setup(ctx, inputs, output):
    q, k, v, q_pos, kv_pos, window, prefix_len = inputs
    ctx.save_for_backward(q, k, v, q_pos, kv_pos, output)
    ctx.masks = (window, prefix_len)


def _k6_backward(ctx, do):
    q, k, v, q_pos, kv_pos, o = ctx.saved_tensors
    dq, dk, dv = _k6_bwd(q, k, v, q_pos, kv_pos, o, do.contiguous(),
                         *ctx.masks)
    return dq, dk, dv, None, None, None, None


_k6.register_autograd(_k6_backward, setup_context=_k6_setup)


@register_flop_formula(torch.ops.repro_torch_dryrun.flash_attention)
def _k6_flops(q, k, v, q_pos, kv_pos, window, prefix_len, **_):
    """S = QK^T and PV over the allowed pairs."""
    return 2 * _pairs(q, k, window, prefix_len) * (q[-1] + v[-1])


@register_flop_formula(torch.ops.repro_torch_dryrun.flash_attention_bwd)
def _k6_bwd_flops(q, k, v, q_pos, kv_pos, o, do, window, prefix_len, **_):
    """FlashAttention-2's five products over the allowed pairs: S again,
    dP = dO V^T, dV += P^T dO, dQ += dS K, dK += dS^T Q."""
    return 2 * _pairs(q, k, window, prefix_len) * (3 * q[-1] + 2 * v[-1])


def card_flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                         prefix_len: int = 0) -> torch.Tensor:
    """``flash_attention`` as two operations (K6's forward and, under
    autograd, its backward) that a trace counts as the card's kernels;
    on real tensors they compute the plain version."""
    return _k6(q, k, v, q_pos, kv_pos, int(window), int(prefix_len))


def _n_splits(q, k, total) -> int:
    B, Sq, KV, G, hd = q
    if flash_ops.partials_form(Sq, G, hd) == "simt":
        return 1
    return -(-k[1] // flash_ops.split_keys(B, KV, total))


@torch.library.custom_op(
    "repro_torch_dryrun::flash_partials", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_pos, Tensor kv_pos, "
           "int window, int prefix_len, int offset, int total) -> "
           "(Tensor, Tensor, Tensor)")
def _k6_partials(q, k, v, q_pos, kv_pos, window, prefix_len, offset, total):
    kps = -(-k.shape[1] // _n_splits(q.shape, k.shape, total))
    return tuple(t.clone() for t in split_partials(
        q, k, v, q_pos, kv_pos, window=window, prefix_len=prefix_len,
        keys_per_split=kps, offset=offset, total=total))


@_k6_partials.register_fake
def _(q, k, v, q_pos, kv_pos, window, prefix_len, offset, total):
    n = _n_splits(q.shape, k.shape, total)
    f32 = torch.float32
    return (q.new_empty((n,) + q.shape[:-1], dtype=f32),
            q.new_empty((n,) + q.shape[:-1], dtype=f32),
            q.new_empty((n,) + q.shape, dtype=f32))


@torch.library.custom_op(
    "repro_torch_dryrun::flash_combine", mutates_args=(),
    schema="(Tensor m, Tensor l, Tensor o, ScalarType dtype) -> Tensor")
def _k6_combine(m, l, o, dtype):
    return combine_partials(m, l, o, dtype).clone()


@_k6_combine.register_fake
def _(m, l, o, dtype):
    return o.new_empty(o.shape[1:], dtype=dtype)


@register_flop_formula(torch.ops.repro_torch_dryrun.flash_partials)
def _k6_partials_flops(q, k, v, q_pos, kv_pos, window, prefix_len, offset,
                       total, **_):
    """S = QK^T and PV over this block's share of the allowed pairs (the
    pairs of the whole cache, :func:`attended_pairs`, times the block's
    share of its slots)."""
    B, Sq, KV, G, hd = q
    pairs = B * KV * G * attended_pairs(Sq, total, window, prefix_len)
    return 2 * pairs * k[1] // total * (hd + v[-1])


@register_flop_formula(torch.ops.repro_torch_dryrun.flash_combine)
def _k6_combine_flops(m, l, o, dtype, **_):
    return 2 * o[0] * o[1] * o[2] * o[3] * o[4] * o[5]


def card_flash_partials(q, k, v, q_pos, kv_pos, *, window: int = 0,
                        prefix_len: int = 0, offset: int = 0, total=None):
    """``flash_partials`` as one operation a trace counts as K6's
    partials kernel (the plain version on real tensors)."""
    total = k.shape[1] if total is None else int(total)
    return _k6_partials(q, k, v, q_pos, kv_pos, int(window),
                        int(prefix_len), int(offset), total)


@contextlib.contextmanager
def card_attention():
    """Within: the models call :func:`card_flash_attention` (and K6's
    partials and merge as one operation each)."""
    saved = (attention.flash_attention, attention.flash_partials,
             attention.flash_combine)
    attention.flash_attention = card_flash_attention
    attention.flash_partials = card_flash_partials
    attention.flash_combine = _k6_combine
    try:
        yield
    finally:
        (attention.flash_attention, attention.flash_partials,
         attention.flash_combine) = saved


def _tensors(tree):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples, named
    tuples), each storage once."""
    seen, n = set(), 0
    for t in _tensors(tree):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def _storage_key(t):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


class Traffic(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts each operation's input and output bytes (views skipped),
    the operations by name, and the peak of the live storages' bytes.  A
    storage is live from the first operation that touches it (or
    :meth:`hold`) until it is released; releases are noticed lazily,
    whenever an allocation could set a new peak or a new storage meets a
    released one's key, which keeps the peak exact."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.census: collections.Counter = collections.Counter()
        self.live: Dict = {}
        self.current = 0
        self.peak = 0

    def hold(self, tree) -> None:
        for t in _tensors(tree):
            self._track(t)

    def _sweep(self) -> None:
        dead = [r for r in self.live if r.expired()]
        for r in dead:
            self.current -= self.live.pop(r)[1]

    def _track(self, t) -> None:
        key = _storage_key(t)
        if key in self.live:
            if not self.live[key][0].expired():
                return
            # a released storage's key: the new one is counted afresh
            self.current -= self.live.pop(key)[1]
        n = t.untyped_storage().nbytes()
        if self.current + n > self.peak:
            self._sweep()
        self.live[key] = (key, n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":             # .device and the like
            return out
        self.census[func.overloadpacket.__name__] += 1
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


def build_cell(cfg: ModelConfig, shape, *, remat: str = "none"):
    """``(fn, args)`` of one cell on fake CPU tensors; call it under a
    ``FakeTensorMode``."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    params = shape_dtype_tree(transformer.model_specs(cfg), device="cpu")
    cdt = transformer.as_dtype(cfg.compute_dtype)

    def fake(tree):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cpu"), tree)

    ins = input_specs(cfg, shape, cdt)
    if shape.kind == "train":
        master = cfg.param_dtype != "float32"
        opt = opt_mod.init(params, master_fp32=master, device="cpu")
        step = ts_mod.make_train_step(
            cfg, opt_mod.OptConfig(master_fp32=master), remat=remat)
        return step, (params, opt, fake(ins["batch"]))
    if shape.kind == "prefill":
        cache = transformer.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, cdt, "cpu")

        def prefill(params, batch, cache):
            return transformer.prefill(params, cfg, batch, cache)

        return prefill, (params, fake(ins["batch"]), cache)

    def decode(params, tokens, index, cache):
        return transformer.decode_step(params, cfg, tokens, index, cache)

    # the index is a host int: decode_step reads it (a data-dependent
    # value under fake tensors)
    return decode, (params, fake(ins["tokens"]), shape.seq_len - 1,
                    fake(ins["cache"]))


def _block_like(t, placement, mesh):
    """An uninitialized tensor of ``t``'s type and of the shape of rank
    ``mesh.rank``'s block of it under ``placement``."""
    shape = tuple(s.stop - s.start for s in sharding.block_slices(
        tuple(t.shape), placement, mesh))
    return torch.empty(shape, dtype=t.dtype, device="cpu")


def build_mesh_cell(cfg: ModelConfig, shape, mesh: TraceMesh, *,
                    remat: str = "none"):
    """``(fn, args)`` of one cell as rank ``mesh.rank`` of ``mesh`` runs
    it, on its blocks (fake CPU tensors: call it under a
    ``FakeTensorMode``); ``fn`` runs under ``sharding.use_mesh(mesh)``."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    if shape.kind == "train":
        specs = transformer.model_specs(cfg)
        place = sharding.train_placements(specs, mesh, cfg)
    else:
        cfg, specs, place = transformer.serving_layout(cfg, mesh)
    whole = shape_dtype_tree(specs, device="cpu")
    params = sharding.tree_map(
        lambda t, p: _block_like(t, p, mesh), whole, place)
    cdt = transformer.as_dtype(cfg.compute_dtype)
    ins = input_specs(cfg, shape, cdt)

    def blocks(batch):
        place = sharding.data_placements(batch, mesh, cfg.sharding_profile)
        return {k: None if v is None else _block_like(v, place[k], mesh)
                for k, v in batch.items()}

    if shape.kind == "train":
        master = cfg.param_dtype != "float32"
        opt = opt_mod.init(params, master_fp32=master, device="cpu")
        step = ts_mod.make_train_step(
            cfg, opt_mod.OptConfig(master_fp32=master), remat=remat,
            mesh=mesh)
        return step, (params, opt, blocks(ins["batch"]))
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   cdt, "cpu", mesh=mesh)
    if shape.kind == "prefill":
        def prefill(params, batch, cache):
            with sharding.use_mesh(mesh):
                return transformer.prefill(params, cfg, batch, cache)

        return prefill, (params, blocks(ins["batch"]), cache)

    def decode(params, tokens, index, cache):
        with sharding.use_mesh(mesh):
            return transformer.decode_step(params, cfg, tokens, index, cache)

    tokens = blocks(dict(tokens=ins["tokens"]))["tokens"]
    return decode, (params, tokens, shape.seq_len - 1, cache)


def collective_seconds(census: Dict, mesh: TraceMesh) -> float:
    """The collectives' time at the stated link rates: each (kind, axes)
    entry's bytes over NVLink's rate where rank 0's group over those axes
    lies within one node, else over NDR's."""
    t = 0.0
    for (_, axes), n in census.items():
        local = max(mesh.group_ranks(axes)) < NODE_CARDS
        t += n["bytes"] / (NVLINK_BW if local else NDR_BW)
    return t


def measure(fn, *args) -> Dict:
    """FLOPs, bytes, census and memory of ``fn(*args)``, whose tensor
    arguments are fake (or meta) tensors; call it under the
    ``FakeTensorMode`` that made them."""
    from torch.utils.flop_counter import FlopCounterMode

    traffic = Traffic()
    traffic.hold(args)
    arg_bytes = tree_bytes(args)
    with FlopCounterMode(display=False) as fc, traffic:
        out = fn(*args)
    out_bytes = tree_bytes(out)
    del out
    census = dict(sorted(traffic.census.items()))
    census.setdefault("transpose", 0)
    return dict(
        cost=dict(flops=float(fc.get_total_flops()),
                  bytes_accessed=float(traffic.bytes)),
        memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                    peak_device_bytes=traffic.peak),
        op_census=census)


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", *,
             remat: str = "auto", overrides: Optional[Dict] = None,
             tag: str = "", save: bool = True,
             config: Optional[ModelConfig] = None,
             shape=None) -> Dict:
    """One cell's record on the mesh ``mesh_kind`` (:data:`MESHES`).
    ``remat`` "auto": "full" for a train shape on the pod meshes (the
    JAX dry run's), else "none" (on one card, the training launcher's).
    ``config`` / ``shape`` replace the arch's published config and the
    registry's shape (reduced cells in tests)."""
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}; one of "
                         f"{list(MESHES)}")
    spec = get_arch(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape_name)
    if not ok:
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                   status="skip", reason=why)
        if save:
            _save(rec, arch, shape_name, mesh_kind, tag)
        return rec
    cfg = apply_overrides(config or spec.config, overrides or {})
    axes = MESHES[mesh_kind]
    mesh = None if axes is None else TraceMesh(axes)
    if remat == "auto":
        remat = ("full" if mesh is not None and shape.kind == "train"
                 else "none")
    rec: Dict[str, Any] = dict(
        arch=arch, shape=shape_name, mesh=mesh_kind, status="ok",
        chips=1 if mesh is None else mesh.num_shards,
        mesh_axes=axes, remat=remat, overrides=overrides or {},
        params=active_params(cfg), model_flops=model_flops(cfg, shape),
        device_bytes=DEVICE_BYTES, seq_len=shape.seq_len,
        global_batch=shape.global_batch)
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        t0 = time.time()
        with FakeTensorMode(), card_attention():
            if mesh is None:
                fn, args = build_cell(cfg, shape, remat=remat)
            else:
                fn, args = build_mesh_cell(cfg, shape, mesh, remat=remat)
            rec.update(measure(fn, *args))
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["memory"]["fits"] = (rec["memory"]["peak_device_bytes"]
                                 <= DEVICE_BYTES)
        if mesh is None:
            rec["collectives"] = {k: dict(count=0.0, bytes=0.0)
                                  for k in COLLECTIVES}
            rec["t_collective_s"] = 0.0
        else:
            rec["collectives"] = {k: {f: float(n) for f, n in v.items()}
                                  for k, v in mesh.census().items()}
            groups = mesh.census(by_axes=True)
            rec["collectives_by_group"] = {
                f"{k}|{','.join(a)}": v for (k, a), v in groups.items()}
            rec["t_collective_s"] = collective_seconds(groups, mesh)
            rec["link_rates"] = dict(
                nvlink_bytes_per_s=NVLINK_BW, ndr_bytes_per_s=NDR_BW,
                node_cards=NODE_CARDS,
                source="NVIDIA data sheets: NVLink 4 450 GB/s a direction "
                       "(HGX H100, 8 cards a node); ConnectX-7 400 Gb/s NDR "
                       "a card across nodes")
        rec["collective_bytes"] = float(sum(
            v["bytes"] for v in rec["collectives"].values()))
        rec["roofline"] = roofline_terms(rec)
    except Exception as e:  # record the failure — these are bugs to fix
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
    if save:
        _save(rec, arch, shape_name, mesh_kind, tag)
    return rec


def roofline_terms(rec: Dict) -> Dict:
    """Three roofline terms in seconds a card: compute at the bf16 dense
    peak, the counted traffic at the HBM rate, and the collectives at the
    stated link rates (none on one card)."""
    t_compute = rec["cost"]["flops"] / PEAK_FLOPS
    t_memory = rec["cost"]["bytes_accessed"] / HBM_BW
    t_coll = rec.get("t_collective_s", 0.0)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_coll), key=lambda kv: kv[1])[0]
    useful = rec["model_flops"] / rec["chips"]
    return dict(
        t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
        dominant=dominant,
        model_flops_per_chip=useful,
        useful_flop_frac=(useful / rec["cost"]["flops"]
                          if rec["cost"]["flops"] else 0.0),
        # step-time lower bound if terms overlapped perfectly / not at all
        t_min=max(t_compute, t_memory, t_coll),
        t_sum=t_compute + t_memory + t_coll,
        # fraction of ideal (pure-compute of useful flops) achieved at t_min
        roofline_frac=(useful / PEAK_FLOPS) / max(
            max(t_compute, t_memory, t_coll), 1e-30),
    )


def _save(rec: Dict, arch: str, shape: str, mesh_kind: str, tag: str):
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = ARTIFACTS / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=float))
    return path


def summarize(rec: Dict) -> str:
    if rec["status"] == "skip":
        return (f"{rec['arch']:>24} {rec['shape']:>12} {rec['mesh']:>7}  "
                f"SKIP ({rec['reason'][:40]}...)")
    if rec["status"] == "fail":
        return (f"{rec['arch']:>24} {rec['shape']:>12} {rec['mesh']:>7}  "
                f"FAIL {rec['error'][:80]}")
    r = rec["roofline"]
    m = rec["memory"]["peak_device_bytes"] / 2**30
    return (f"{rec['arch']:>24} {rec['shape']:>12} {rec['mesh']:>7}  "
            f"mem/dev={m:8.2f}GiB flops={rec['cost']['flops']:.3e} "
            f"tc={r['t_compute']*1e3:8.2f}ms tm={r['t_memory']*1e3:8.2f}ms "
            f"tx={r['t_collective']*1e3:8.2f}ms "
            f"dom={r['dominant']:>8} roofline={r['roofline_frac']*100:5.1f}% "
            f"(trace {rec['trace_s']}s)")


def _cell(job):
    arch, shape, kw = job
    return run_cell(arch, shape, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=list(MESHES) + ["both"],
                    help="one card, the (data 16, model 16) pod, the "
                         "(pod 2, data 16, model 16) pair of pods, or both "
                         "of those")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="auto",
                    choices=("auto",) + transformer.REMATS,
                    help='"auto": "full" for a train shape on pod and '
                         'multi, else "none"')
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--tag", default="")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells traced in parallel processes")
    args = ap.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.all:                # --arch / --shape narrow it
        cells = [(a, s) for a in list_archs() for s in SHAPES
                 if args.arch in (None, a) and args.shape in (None, s)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    meshes = ["pod", "multi"] if args.mesh == "both" else [args.mesh]
    jobs = [(a, s, dict(mesh_kind=m, remat=args.remat, overrides=overrides,
                        tag=args.tag))
            for m in meshes for a, s in cells]
    t0 = time.time()
    n_fail = 0
    status = collections.Counter()
    if args.workers > 1:
        import multiprocessing as mp

        # the longest traces first: prefill, then train, then decode
        order = dict(prefill=0, train=1, decode=2)
        jobs.sort(key=lambda j: order[SHAPES[j[1]].kind])
        with mp.get_context("spawn").Pool(args.workers) as pool:
            for rec in pool.imap_unordered(_cell, jobs):
                print(summarize(rec), flush=True)
                n_fail += rec["status"] == "fail"
                status[rec["status"]] += 1
    else:
        for job in jobs:
            rec = _cell(job)
            print(summarize(rec), flush=True)
            n_fail += rec["status"] == "fail"
            status[rec["status"]] += 1
    print(f"done in {time.time() - t0:.0f}s, {len(jobs)} cells: "
          f"{status['ok']} ok, {status['skip']} skip, {status['fail']} fail",
          flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
