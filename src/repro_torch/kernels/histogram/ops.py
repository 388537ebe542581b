"""Wrapper for the histogram kernel (``csrc/histogram.cu``): CPU tensors
take the plain version (:mod:`.ref`), CUDA tensors the kernel.

The kernel has two forms; :func:`histogram_plan` picks one from ``(n, C)``:

* ``"private"`` — ``C <= PRIVATE_MAX_C``: a persistent block an SM, one
  shared-memory histogram column a thread, and the last block to finish
  summing the blocks' rows in a fixed order.  One launch, no atomics on
  the bins; results repeat bit for bit for any f32 weights.
* ``"shared"`` — larger ``C`` up to ``MAX_C``: one shared-memory histogram
  a block, merged into ``out`` by atomics.  Float sums may differ from run
  to run in the last bits; integer-valued weights are exact while a bin's
  total stays below 2^24.

:func:`histogram_ordered` is the third form, ``"ordered"``, for any ``C``:
each bin's weights added one at a time in index order — the order of the
plain version and of XLA's CPU ``segment_sum`` — so its float sums are the
CPU's bits.  ``comm_graph.segment_sum`` takes it for f32 on a card, where
the sums feed planning decisions; :func:`run_sums` runs it on runs the
caller already has (``comm_graph.ordered_sum``'s windows).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import INT, PTR, CudaKernel
from repro_torch.kernels.histogram.ref import histogram_ref

KERNEL = CudaKernel("histogram", "histogram.cu", {
    "histogram_launch": [PTR] * 4 + [INT] * 5,
    "histogram_ordered_launch": [PTR] * 3 + [ctypes.c_longlong],
    "histogram_ordered_scan_launch": [PTR] * 3 + [INT] * 2,
})

THREADS = 256         # threads a block (csrc/histogram.cu NT)
VECTORS = 4           # 16-byte vectors a thread has in flight (csrc U)
SMEM_MAX = 232448     # shared memory a block may use on an H100 (227 KB)
#: the largest C whose per-thread columns (C · THREADS f32) fit beside the
#: kernel's static shared memory
PRIVATE_MAX_C = (SMEM_MAX - 1024) // (4 * THREADS)
MAX_C = 12288         # one f32 histogram a block in 48 KB (the shared form)
H100_SMS = 132
FORMS = ("private", "shared")
#: the ordered form walks the items unsorted, one thread a bin reading
#: them all, up to this many items and bins (the PIC path's PE loads:
#: 144 chares into 8 PEs); above, it sorts them into runs first
ORDERED_SCAN_MAX_N = 4096
ORDERED_SCAN_MAX_C = 65536
#: calls by form (the registry counts one launch a call of any form)
form_launches = dict.fromkeys(FORMS + ("ordered",), 0)


def histogram_plan(n: int, C: int, sms: int = H100_SMS):
    """``(form, blocks, smem_bytes)`` of a call on ``n`` items and ``C``
    bins on a card with ``sms`` SMs: at most one private block an SM (two
    shared blocks), and no more blocks than stretches of
    ``THREADS · VECTORS`` 16-byte vectors.  The private form's columns
    (``C · THREADS`` f32) also hold the last block's copy of the blocks'
    partials (``C · blocks``, blocks <= THREADS)."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"histogram kernel takes 1 <= C <= {MAX_C}, got {C}")
    stretches = max(1, -(-(n // 4) // (THREADS * VECTORS)))
    if C <= PRIVATE_MAX_C:
        return "private", min(sms, stretches, THREADS), 4 * C * THREADS
    return "shared", min(2 * sms, stretches), 4 * C


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor, dtype) -> torch.Tensor:
    # the kernel reads 16-byte vectors
    if t.dtype != dtype:
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def histogram(ids: torch.Tensor, weights: torch.Tensor, *, C: int):
    """(C,) f32 per-bin weight sums; ids outside [0, C) are ignored."""
    if ids.device.type == "cpu":
        return histogram_ref(ids, weights, C=C)
    if not ids.is_cuda or not weights.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {ids.device} and "
                         f"{weights.device}")
    if weights.shape != ids.shape or ids.dim() != 1:
        raise ValueError("ids and weights must be 1-D of the same shape")
    n = ids.shape[0]
    form, blocks, smem = histogram_plan(n, C, _sms(ids.device.index))
    if n == 0:
        return torch.zeros(C, dtype=torch.float32, device=ids.device)
    ids = _aligned(ids, torch.int32)
    w = _aligned(weights, torch.float32)
    out = torch.empty(C, dtype=torch.float32, device=ids.device)
    partial = (torch.empty(blocks * C, dtype=torch.float32,
                           device=ids.device) if form == "private" else out)
    KERNEL.launch("histogram_launch", ids.data_ptr(), w.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), n, C,
                  FORMS.index(form), blocks, smem)
    form_launches[form] += 1
    return out


def ordered_runs(ids: torch.Tensor, weights: torch.Tensor, C: int):
    """``(w_sorted f32, bounds i64 (C + 1))``: the weights stably sorted by
    bin (ids outside [0, C) last, past ``bounds[C]``) and the offsets of
    each bin's run — the ordered form's input, on the ids' device."""
    idx = ids.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < C), idx, C)
    sorted_ids, order = torch.sort(idx, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(C + 1, device=ids.device))
    return weights.to(torch.float32)[order].contiguous(), bounds


def histogram_ordered(ids: torch.Tensor, weights: torch.Tensor, *, C: int):
    """(C,) f32 per-bin weight sums, each bin's weights added one at a time
    in index order (the plain version's bits on every device); ids outside
    [0, C) are ignored.  Any ``C``: one thread a bin over its run of
    :func:`ordered_runs`, or, for few items and bins
    (:data:`ORDERED_SCAN_MAX_N`, :data:`ORDERED_SCAN_MAX_C`), over all the
    items unsorted."""
    if ids.device.type == "cpu":
        return histogram_ref(ids, weights, C=C)
    if not ids.is_cuda or not weights.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {ids.device} and "
                         f"{weights.device}")
    if weights.shape != ids.shape or ids.dim() != 1:
        raise ValueError("ids and weights must be 1-D of the same shape")
    C, n = int(C), ids.shape[0]
    out = torch.empty(C, dtype=torch.float32, device=ids.device)
    if n <= ORDERED_SCAN_MAX_N and C <= ORDERED_SCAN_MAX_C:
        i = ids.to(torch.int32).contiguous()
        w = weights.to(torch.float32).contiguous()
        KERNEL.launch("histogram_ordered_scan_launch", i.data_ptr(),
                      w.data_ptr(), out.data_ptr(), n, C)
    else:
        w, bounds = ordered_runs(ids, weights, C)
        KERNEL.launch("histogram_ordered_launch", w.data_ptr(),
                      bounds.data_ptr(), out.data_ptr(), C)
    form_launches["ordered"] += 1
    return out


def run_sums(weights: torch.Tensor, bounds: torch.Tensor):
    """(C,) f32 sums of the runs ``weights[bounds[c]:bounds[c + 1]]``, each
    run added one at a time in index order (the ordered form on runs the
    caller already has: no sort); ``bounds`` is (C + 1,) int64,
    non-decreasing, within ``[0, n]``."""
    C = int(bounds.shape[0]) - 1
    if weights.device.type == "cpu":
        ids = torch.repeat_interleave(
            torch.arange(C, device=weights.device), bounds.diff())
        lo = int(bounds[0])
        return histogram_ref(ids, weights[lo:lo + ids.shape[0]], C=C)
    if not weights.is_cuda or not bounds.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {weights.device} and "
                         f"{bounds.device}")
    w = weights.to(torch.float32).contiguous()
    b = bounds.to(torch.int64).contiguous()
    out = torch.empty(C, dtype=torch.float32, device=w.device)
    KERNEL.launch("histogram_ordered_launch", w.data_ptr(), b.data_ptr(),
                  out.data_ptr(), C)
    form_launches["ordered"] += 1
    return out
