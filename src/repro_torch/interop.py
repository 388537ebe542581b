"""Carrying data across packages as NumPy arrays: an ``LBProblem`` as a
dict, the JAX package's model parameters, optimizer state and caches as
nested trees.

Imports only torch and NumPy: a caller (in practice the parity tests)
builds the dict from the JAX package's problem with ``np.asarray`` on
each field and hands the same arrays to both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.comm_graph import LBProblem
from repro_torch.kernels import resolve_device
from repro_torch.models.params import tree_map

_FIELDS = {"loads": torch.float32, "assignment": torch.int32,
           "edges_src": torch.int32, "edges_dst": torch.int32,
           "edges_bytes": torch.float32}


def problem_from_numpy(d: Dict, device="cuda") -> LBProblem:
    """``LBProblem`` from ``{loads, assignment, edges_src, edges_dst,
    edges_bytes, num_nodes[, coords]}``."""
    dev = resolve_device(device)
    # copies: the arrays may be read-only views of another package's buffers
    t = {k: torch.tensor(np.asarray(d[k]), dtype=dt, device=dev)
         for k, dt in _FIELDS.items()}
    coords = d.get("coords")
    return LBProblem(
        **t, num_nodes=int(d["num_nodes"]),
        coords=None if coords is None else torch.tensor(
            np.asarray(coords), dtype=torch.float32, device=dev))


def problem_to_numpy(problem: LBProblem) -> Dict:
    """Inverse of :func:`problem_from_numpy`."""
    d = {k: getattr(problem, k).cpu().numpy() for k in _FIELDS}
    d["num_nodes"] = problem.num_nodes
    d["coords"] = (None if problem.coords is None
                   else problem.coords.cpu().numpy())
    return d


# ------------------------------------------------------- model weights --


def _layers_from_tree(tree: Dict, cfg) -> list:
    """The per-layer list, in ``cfg.all_layers()`` order, of a JAX-layout
    tree's ``prefix``, stacked ``unit`` groups and ``suffix``."""
    layers = list(tree["prefix"])
    for g in range(cfg.num_groups):
        layers += [tree_map(lambda a: np.asarray(a)[g], unit)
                   for unit in tree["unit"]]
    return layers + list(tree["suffix"])


def _port_tree(tree: Dict, cfg) -> Dict:
    out = dict(embed=tree["embed"], final_norm=tree["final_norm"],
               layers=_layers_from_tree(tree, cfg))
    for k in ("lm_head", "mtp"):
        if k in tree:
            out[k] = tree[k]
    return out


def params_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """The port's model parameters from the JAX package's parameter tree
    given as nested dicts and lists of NumPy arrays.

    The JAX ``unit`` leaves carry a leading group dimension (its scanned
    stack): layer ``len(prefix) + g * len(layer_unit) + i`` takes
    ``unit[i][...][g]`` (stacked experts: (G, E, ...) → (E, ...)).
    Returns ``{embed, final_norm, layers[, lm_head][, mtp]}`` with
    ``layers`` in ``cfg.all_layers()`` order, on ``device``."""
    dev = resolve_device(device)
    # copies: the arrays may be read-only views of another package's buffers
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                    _port_tree(tree, cfg))


def opt_state_from_numpy(state, cfg, device="cuda"):
    """The port's ``train.optimizer.OptState`` from the JAX package's
    ``OptState`` (step, mu, nu, master) given as NumPy arrays (a
    NamedTuple or a dict of those fields): the moments and the master
    copy mapped onto the port's per-layer tree as
    :func:`params_from_numpy` maps the parameters."""
    from repro_torch.train.optimizer import OptState

    dev = resolve_device(device)
    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k))
    master = get("master")
    return OptState(
        torch.tensor(np.asarray(get("step")), dtype=torch.int32, device=dev),
        params_from_numpy(get("mu"), cfg, dev),
        params_from_numpy(get("nu"), cfg, dev),
        None if master is None else params_from_numpy(master, cfg, dev))


def cache_to_numpy(cache, cfg) -> Dict:
    """The port's per-layer cache as the JAX package's stacked cache tree
    ``{unit, prefix, suffix}`` of NumPy arrays (``unit[i]`` leaves gain the
    leading group dimension); every field: ``kv``, ``ssm``, ``state``."""
    host = tree_map(lambda t: t.cpu().numpy(), list(cache))
    n_pre, n_unit = len(cfg.prefix_layers), len(cfg.layer_unit)
    groups = [host[n_pre + g * n_unit: n_pre + (g + 1) * n_unit]
              for g in range(cfg.num_groups)]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return np.stack(parts)

    return dict(unit=[stack([grp[i] for grp in groups])
                      for i in range(n_unit)] if groups else [],
                prefix=host[:n_pre],
                suffix=host[len(host) - len(cfg.suffix_layers):])
