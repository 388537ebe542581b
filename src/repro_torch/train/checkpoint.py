"""Checkpoints: one ``.npz`` of every tensor and a JSON manifest
(counterpart of ``repro.train.checkpoint``), the same layout on disk:

  * ``<dir>/ckpt_<step:08d>/arrays.npz`` holds every leaf under its tree
    path (``params/...``, ``opt/...``), ``manifest.json`` the step, the
    keys, each leaf's type and the data pipeline's state;
  * a checkpoint is written into a temporary directory and renamed into
    place, then the ``LATEST`` pointer is replaced atomically, so a crash
    mid-save never corrupts the restore point;
  * ``keep`` bounds the checkpoints kept (the oldest are removed).

NumPy has no bf16: a bf16 leaf is stored as its raw 16-bit view and its
type is recorded in the manifest, so it round-trips bit for bit.
:func:`restore` places the leaves on the caller's device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device


def _items(tree, prefix=""):
    """``(path, leaf)`` of every tensor in tree order: dict keys, list
    indices and NamedTuple field names joined by "/"; ``None`` skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves: Dict[str, Any], prefix=""):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def save(directory: str, step: int, params, opt_state=None,
         data_state: Optional[Dict] = None, *, keep: int = 3) -> str:
    """Write ``ckpt_<step>``, then flip ``LATEST``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_{step:08d}"
    final = os.path.join(directory, name)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_" + name)
    try:
        arrays, dtypes = {}, {}
        for sect, tree in (("params", params), ("opt", opt_state)):
            for k, v in _items(tree):
                arrays[f"{sect}/{k}"], dtypes[f"{sect}/{k}"] = _to_numpy(v)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = dict(
            step=int(step), keys=sorted(arrays), dtypes=dtypes,
            data_state=None if data_state is None else {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in data_state.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(directory: str, params_template, opt_template=None, *,
            step: Optional[int] = None, device="cuda"
            ) -> Tuple[Any, Any, int, Optional[Dict]]:
    """Load ``(params, opt_state, step, data_state)`` onto ``device``.

    The templates give the tree structure (their tensors' values are not
    read); each stored leaf must have its template's shape."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["dtypes"]

    def load(template, sect):
        leaves = {}
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k, t in _items(template):
                key = f"{sect}/{k}"
                a = z[key]
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint leaf {k}: shape "
                                     f"{a.shape} != {tuple(t.shape)}")
                leaves[k] = _from_numpy(a, dtypes[key], dev)
        return _rebuild(template, leaves)

    params = load(params_template, "params")
    opt = None if opt_template is None else load(opt_template, "opt")
    return params, opt, int(manifest["step"]), manifest.get("data_state")
