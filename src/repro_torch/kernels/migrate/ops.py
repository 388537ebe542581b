"""Wrapper for the counting-scatter kernel (``csrc/migrate.cu``).

:func:`scatter_dest` / :func:`bucket_ranks` are the sort-free primitives
behind ``runtime.migrate``'s manifest build and ``spill_owner``.  CPU
tensors take the plain version (:mod:`.ref`) at every C, CUDA tensors the
kernel; both reproduce the stable-argsort bucketed layout exactly (ties
keep previous position).

On a card a call takes one of three forms, :func:`scatter_form` says
which:

* ``"small"`` — ``C <= SMALL_MAX_C``: one count-and-scan launch and one
  rank launch, each thread ranking 16 consecutive items in its own
  shared-memory column;
* ``"shared"`` — ``C <= SHARED_MAX_C``: the same two launches, each warp
  ranking 32 items at a time with ``__match_any_sync`` into its own
  bucket table;
* ``"radix"`` — ``C <= MAX_C``: stable scatters of the ids' radix digits
  (:func:`scatter_by_digits`, each digit a small or shared pass), composed
  into the full-C scatter, with the counts from a count launch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import INT, PTR, CudaKernel
from repro_torch.kernels.migrate.ref import bucket_ranks_ref, scatter_dest_ref

KERNEL = CudaKernel("scatter_dest", "migrate.cu", {
    "scatter_dest_launch": [PTR] * 5 + [INT] * 7,
    "scatter_count_launch": [PTR] * 2 + [INT] * 3,
})

THREADS = 256         # threads a block (csrc/migrate.cu NT)
WARPS = THREADS // 32
TILE = 4096           # items a tile (csrc TILE)
STAGE_BYTES = WARPS * 144 * 16   # the small rank pass's staging (csrc STAGE)
SMEM_MAX = 232448     # shared memory a block may use on an H100 (227 KB)
SMEM_SM = 233472      # shared memory of an SM (228 KB)
H100_SMS = 132
BLOCKS_PER_SM = 4     # blocks a pass keeps on an SM where shared memory allows
#: the largest (bucket, block) table the last block of the count pass
#: scans: the blocks of a pass are cut to fit it
TABLE_MAX = 1 << 16
#: the largest C of the small form (per-thread columns, C KB a block):
#: past it the shared form is faster on bucketed ids (PERF.md)
SMALL_MAX_C = 32
#: the largest C of the shared form (per-warp tables, 36·C bytes a block):
#: to here it beats the radix form's host work at n <= 2^20 (PERF.md)
SHARED_MAX_C = 4096
#: the largest C a card takes (radix digits above SHARED_MAX_C)
MAX_C = 1 << 24
FORMS = ("small", "shared", "radix")
#: wrapper calls on a card by form (a radix call's digit passes are not
#: counted here; the registry counts every launch)
form_launches = {f: 0 for f in FORMS}

# The counting scatter beats a stable sort up to about this many buckets
# on the CPU (measured for the JAX package); ``method="auto"`` resolves as
# there for CPU tensors.
SORT_CROSSOVER_C = 64
#: on a card the scatter-built manifest beats the sort-built one up to this
#: many buckets at n = 2^24 (the sort wins at 4096); at n <= 2^20 both are
#: host-bound and the scatter wins nearly every cell to C = 4096
#: (``benchmarks_torch/migrate_kernels.py --crossover``, PERF.md)
CUDA_SORT_CROSSOVER_C = 1024


def preferred_method(n: int, C: int, device=None) -> str:
    """``"scatter"`` or ``"sort"`` — what ``method="auto"`` resolves to
    for ``n`` items over ``C`` buckets on ``device`` (the CPU rule, the
    JAX package's, where it is None)."""
    del n
    on_card = device is not None and torch.device(device).type == "cuda"
    limit = CUDA_SORT_CROSSOVER_C if on_card else SORT_CROSSOVER_C
    return "scatter" if C <= limit else "sort"


def scatter_form(n: int, C: int) -> str:
    """The form a call on a card takes for ``C`` buckets."""
    del n
    if not 1 <= C <= MAX_C:
        raise ValueError(f"the scatter kernel takes 1 <= C <= MAX_C = "
                         f"{MAX_C}, got {C}")
    if C <= SMALL_MAX_C:
        return "small"
    return "shared" if C <= SHARED_MAX_C else "radix"


def scatter_plan(n: int, C: int, sms: int = H100_SMS, form=None):
    """``(form, blocks, tiles_per_block, smem_count, smem_rank)`` of one
    small or shared pass: up to ``BLOCKS_PER_SM`` blocks an SM (fewer
    where the rank pass's shared memory does not fit), no more blocks
    than tiles and no larger (C, blocks) table than ``TABLE_MAX``; each
    block whole tiles in input order, the block count rounded up to a
    multiple of 4 (the table is scanned in 16-byte loads; a block past the
    last tile counts zeros).  ``form`` forces a form that takes ``C``
    (the benchmarks')."""
    form = form or scatter_form(n, C)
    if form == "small":
        smem_count = 4 * C * THREADS
        smem_rank = STAGE_BYTES + 4 * C * (THREADS + 1)
    elif form == "shared":
        smem_count, smem_rank = 4 * C, 4 * C * (WARPS + 1)
    else:
        raise ValueError(f"C = {C} takes radix digits, not one pass")
    per_sm = max(1, min(BLOCKS_PER_SM, SMEM_SM // (smem_rank + 1024)))
    tiles = max(1, -(-n // TILE))
    blocks = max(1, min(tiles, sms * per_sm, TABLE_MAX // C))
    tpb = -(-tiles // blocks)
    blocks = -(-tiles // tpb)
    return form, -(-blocks // 4) * 4, tpb, smem_count, smem_rank


def digit_bases(C: int, limit: int = SHARED_MAX_C):
    """Bucket counts of the radix digits of an id in [0, C), lowest first,
    such that each digit's stable scatter takes at most ``limit``
    buckets: every digit but the top one has one base B, and its scatter
    one bucket more (the padding's), so B + 1 <= limit; the top digit
    takes ceil(C / B^(k-1)) <= B buckets.  The fewest digits, then the
    smallest B."""
    if C <= limit:
        return (C,)
    if limit < 3:
        raise ValueError(f"digits of at most {limit} buckets cannot "
                         "carry the padding")
    k = 2
    while True:
        B = max(2, round(C ** (1.0 / k)))
        while B ** k < C:
            B += 1
        while B > 2 and (B - 1) ** k >= C:
            B -= 1
        if B + 1 <= limit:
            return (B,) * (k - 1) + (-(-C // B ** (k - 1)),)
        k += 1


def scatter_by_digits(ids: torch.Tensor, C: int, bases, scatter, count):
    """``(dest, counts)`` of the stable scatter of ``ids`` over ``C``
    buckets, composed of one stable scatter a radix digit (``bases``, as
    :func:`digit_bases` gives them, lowest first).

    ``scatter(keys, C=b)`` returns ``(dest, counts)`` of one digit's
    scatter (a kernel pass on a card, the plain version in the tests);
    ``count(ids, C=C)`` the per-bucket counts.  Every pass but the last
    carries the padding ids in one extra bucket, so its ``dest`` is a
    permutation; the last makes them invalid (sentinel ``n``).  A stable
    scatter of a stable scatter is stable on (high, low) digits, so the
    result equals the full-C scatter bit for bit."""
    ids = ids.to(torch.int32)
    cur, pos, place = ids, None, 1
    for b in bases[:-1]:
        valid = (cur >= 0) & (cur < C)
        digit = torch.div(cur, place, rounding_mode="floor") % b
        d, _ = scatter(torch.where(valid, digit, b).to(torch.int32), C=b + 1)
        d = d.long()
        nxt = torch.empty_like(cur)
        nxt[d] = cur
        pos = d if pos is None else d[pos]
        cur, place = nxt, place * b
    valid = (cur >= 0) & (cur < C)
    top = torch.div(cur, place, rounding_mode="floor")
    d, _ = scatter(torch.where(valid, top, -1).to(torch.int32), C=bases[-1])
    return (d if pos is None else d[pos]), count(ids, C=C)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(ids: torch.Tensor) -> torch.Tensor:
    # the kernel reads 16-byte vectors
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    return ids if ids.data_ptr() % 16 == 0 else ids.clone()


def _one_pass(ids: torch.Tensor, C: int, form=None):
    """``(dest, counts, offsets)`` of one small or shared pass (``form``
    forces one, for the benchmarks)."""
    n = ids.shape[0]
    form, blocks, tpb, smem_count, smem_rank = scatter_plan(
        n, C, _sms(ids.device.index), form)
    dest = torch.empty(n, dtype=torch.int32, device=ids.device)
    # one allocation: the (C, blocks) table first (16-byte loads), then
    # counts and offsets
    m = blocks * C
    out = torch.empty(m + 2 * C + 1, dtype=torch.int32, device=ids.device)
    table, counts, offsets = out[:m], out[m:m + C], out[m + C:]
    KERNEL.launch("scatter_dest_launch", ids.data_ptr(), dest.data_ptr(),
                  counts.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                  n, C, FORMS.index(form), blocks, tpb, smem_count,
                  smem_rank)
    return dest, counts, offsets


def _count(ids: torch.Tensor, *, C: int) -> torch.Tensor:
    counts = torch.empty(C, dtype=torch.int32, device=ids.device)
    blocks = max(1, min(2 * _sms(ids.device.index),
                        -(-ids.shape[0] // (4 * THREADS))))
    KERNEL.launch("scatter_count_launch", ids.data_ptr(), counts.data_ptr(),
                  ids.shape[0], C, blocks)
    return counts


def _digit_pass(keys: torch.Tensor, *, C: int):
    dest, counts, _ = _one_pass(keys, C)
    return dest, counts


def _check_ids(ids: torch.Tensor) -> None:
    if not ids.is_cuda or ids.dim() != 1:
        raise ValueError(f"expected 1-D CUDA ids, got {ids.dim()}-D on "
                         f"{ids.device}")


def _scatter_dest_cuda(ids: torch.Tensor, C: int):
    _check_ids(ids)
    form = scatter_form(ids.shape[0], C)
    n = ids.shape[0]
    if n >= 2 ** 31 - TILE:
        raise ValueError(f"the scatter kernel takes n < 2^31 - {TILE}, "
                         f"got {n}")
    ids = _aligned(ids)
    if n == 0:
        counts = torch.zeros(C, dtype=torch.int32, device=ids.device)
        return (torch.empty(0, dtype=torch.int32, device=ids.device),
                counts, torch.zeros(C + 1, dtype=torch.int32,
                                    device=ids.device))
    if form == "radix":
        dest, counts = scatter_by_digits(ids, C, digit_bases(C),
                                         _digit_pass, _count)
        offsets = torch.cat([counts.new_zeros(1),
                             torch.cumsum(counts, 0, dtype=torch.int32)])
    else:
        dest, counts, offsets = _one_pass(ids, C)
    form_launches[form] += 1
    return dest, counts, offsets


def scatter_dest(ids: torch.Tensor, *, C: int):
    """Sort-free bucketed destinations: ``(dest, counts, offsets)``.

    ``dest[i] = offsets[ids[i]] + stable-rank-within-bucket`` (the inverse
    of a stable argsort's permutation); padding ids (outside [0, C)) get
    the sentinel ``n``; ``offsets`` is the (C+1,) exclusive scan of
    ``counts``.  On a card C is at most ``MAX_C``."""
    if ids.device.type != "cpu":
        return _scatter_dest_cuda(ids, C)
    dest, counts = scatter_dest_ref(ids, C=C)
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    return dest, counts, offsets


def bucket_ranks(ids: torch.Tensor, *, C: int):
    """Stable within-bucket ranks ``(rank, counts)``; padding rank -1."""
    if ids.device.type == "cpu":
        return bucket_ranks_ref(ids, C=C)
    ids = ids.to(torch.int32)
    dest, counts, offsets = scatter_dest(ids, C=C)
    base = offsets[ids.clamp(0, C - 1).long()]
    valid = (ids >= 0) & (ids < C)
    return torch.where(valid, dest - base, -1).to(torch.int32), counts
