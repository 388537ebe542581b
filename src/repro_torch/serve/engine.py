"""Batched serving engine: continuous-batching prefill/decode over one model
replica (counterpart of ``repro.serve.engine``).

``ServeEngine`` owns a slot-based KV cache: requests claim free batch
slots, prefill writes their prompt into the cache at their slot, and every
engine tick advances all active slots by one token with greedy argmax.
Slots free on EOS / max tokens / a full cache, and new requests join
between ticks (continuous batching); a request whose first token, from its
prefill, is already terminal finishes at admission and leaves the slot to
the next queued request.  Shapes are static in (num_slots, max_len).

This is the per-replica data plane; cross-replica placement is
``serve/scheduler.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (L,) token ids
    max_new_tokens: int = 16
    eos_id: int = -1                # -1 ⇒ never
    out: Optional[List[int]] = None


@dataclasses.dataclass
class ServeConfig:
    num_slots: int = 4
    max_len: int = 256
    dtype: str = "float32"          # the KV cache's type


class ServeEngine:
    """One replica: ``params`` must lie on ``device`` (default the card).
    ``last_logits`` holds the logits of the latest prefill or tick.  Every
    block kind serves: attention caches, hymba's mamba state and the
    xLSTM states are all per slot."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = resolve_device(device)
        self.cache = transformer.init_cache(
            cfg, serve_cfg.num_slots, serve_cfg.max_len, serve_cfg.dtype,
            self.device)
        self.slot_req: List[Optional[Request]] = [None] * serve_cfg.num_slots
        self.slot_pos = np.zeros(serve_cfg.num_slots, np.int64)
        self.slot_tok = np.zeros(serve_cfg.num_slots, np.int32)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.ticks = 0
        self.last_logits: Optional[torch.Tensor] = None

    def _prefill_slot(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """Run one prompt as a batch-1 prefill into a fresh cache, copy its
        rows into the engine cache at ``slot``; returns (1, V) logits."""
        plen = int(len(prompt))
        one = transformer.init_cache(self.cfg, 1, self.scfg.max_len,
                                     self.scfg.dtype, self.device)
        tokens = torch.as_tensor(np.asarray(prompt, np.int32),
                                 device=self.device)[None]
        pos = torch.arange(plen, dtype=torch.int32, device=self.device)[None]
        logits, one = transformer.prefill(
            self.params, self.cfg, dict(tokens=tokens, positions=pos), one)
        # every field of every layer: kv, and hymba's / xLSTM's states
        for t, new in zip(tree_leaves(self.cache), tree_leaves(one)):
            t[slot] = new[0]
        return logits[:, -1]

    # ------------------------------------------------------------- admin --

    def submit(self, req: Request) -> None:
        req.out = []
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.scfg.num_slots):
            while self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                logits = self._prefill_slot(req.prompt, s)
                self.last_logits = logits
                tok = int(torch.argmax(logits[0]))
                req.out.append(tok)
                # the prefill-produced first token can itself be terminal
                # (EOS, or max_new_tokens == 1): finish at admission and
                # keep the slot free for the next queued request
                if tok == req.eos_id or len(req.out) >= req.max_new_tokens:
                    self.done.append(req)
                    continue
                self.slot_req[s] = req
                self.slot_pos[s] = len(req.prompt)
                self.slot_tok[s] = tok

    # -------------------------------------------------------------- tick --

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def tick(self) -> None:
        """Admit waiting requests, advance all active slots one token."""
        self._admit()
        if self.active() == 0:
            return
        tokens = torch.as_tensor(self.slot_tok[:, None], device=self.device)
        positions = torch.as_tensor(self.slot_pos, dtype=torch.int32,
                                    device=self.device)[:, None]
        h, self.cache = transformer.forward(
            self.params, self.cfg, dict(tokens=tokens, positions=positions),
            cache=self.cache, decode=True)
        logits = transformer.logits_head(self.params, self.cfg, h)[:, 0]
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.ticks += 1
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[s])
            req.out.append(tok)
            self.slot_pos[s] += 1
            self.slot_tok[s] = tok
            exhausted = len(req.out) >= req.max_new_tokens
            hit_eos = tok == req.eos_id
            full = self.slot_pos[s] >= self.scfg.max_len - 1
            if exhausted or hit_eos or full:
                self.done.append(req)
                self.slot_req[s] = None

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        while (self.queue or self.active()) and self.ticks < max_ticks:
            self.tick()
        return self.done
