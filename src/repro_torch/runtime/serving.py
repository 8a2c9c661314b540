"""Colocated continuous batching (port of ``ContinuousBatcher`` from
``repro.runtime.serving``).

Slot-based serving loop: one ``decode_step`` advances every active slot
one token per tick; slots in *prefill* phase consume their next prompt
token (logits ignored), slots in *decode* phase their previously
generated token.  Finished slots are reset (per-slot cache re-init) and
refilled from the queue.  Because ``decode_step`` advances each batch row
independently, a request's tokens depend only on its own feed and cache
rows.

The KV-row codec and the disaggregated prefill/decode server, which move
KV rows through the paper's Alltoallv, wait for the collective slice
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import telemetry
from ..models.common import resolve_device


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    eos_id: int | None = None
    generated: list[int] = field(default_factory=list)


def _finished(req: Request) -> bool:
    return len(req.generated) >= req.max_new or (
        req.eos_id is not None and bool(req.generated)
        and req.generated[-1] == req.eos_id)


def _reset_slot(caches, fresh, b: int):
    """Copy slot b's state from a freshly initialised cache tree, **in
    place** (the reference builds a new tree).  Layer-state leaves carry
    batch on axis 1 (stacked layers first); ``pos`` carries it on axis 0.
    ``fresh`` must not share storage with ``caches``."""
    def reset(cur, new):
        for k, v in cur.items():
            if isinstance(v, dict):
                reset(v, new[k])
            else:
                v[:, b] = new[k][:, b]
    reset(caches["states"], fresh["states"])
    caches["pos"][b] = 0
    return caches


class ContinuousBatcher:
    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 device="cuda", serve_step=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.caches = model.init_caches(max_batch, max_seq, self.device)
        # a second tree: decode_step writes the live caches in place
        self._fresh = model.init_caches(max_batch, max_seq, self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.prefill_cursor = [0] * max_batch
        self.queue: list[Request] = []
        self.done: dict[int, list[int]] = {}
        if serve_step is None:
            @torch.no_grad()
            def serve_step(params, toks, caches):
                return model.decode_step(params, toks, caches)
        self._step = serve_step
        self.ticks = 0

    # ---- scheduling ----
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for b in range(self.max_batch):
            if self.slots[b] is None and self.queue:
                req = self.queue.pop(0)
                self.caches = _reset_slot(self.caches, self._fresh, b)
                self.slots[b] = req
                self.prefill_cursor[b] = 0

    def _next_tokens(self) -> np.ndarray:
        toks = np.zeros((self.max_batch, 1), np.int32)
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            c = self.prefill_cursor[b]
            if c < len(req.prompt):
                toks[b, 0] = req.prompt[c]
            else:
                toks[b, 0] = req.generated[-1]
        return toks

    # ---- main loop ----
    def step(self):
        self._admit()
        if all(s is None for s in self.slots):
            return False
        toks = torch.as_tensor(self._next_tokens(), device=self.device)
        logits, self.caches = self._step(self.params, toks, self.caches)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            c = self.prefill_cursor[b]
            if c < len(req.prompt) - 1:
                self.prefill_cursor[b] = c + 1         # still prefilling
                continue
            if c == len(req.prompt) - 1:
                self.prefill_cursor[b] = c + 1         # first generation
            req.generated.append(int(nxt[b]))
            if _finished(req):
                self.done[req.rid] = list(req.generated)
                self.slots[b] = None                   # free -> re-admit
                telemetry.metrics().counter(
                    "serving.requests_completed").inc()
        self.ticks += 1
        telemetry.metrics().counter("serving.decode_ticks").inc()
        return True

    def run(self, max_ticks: int = 100_000):
        while self.step() and self.ticks < max_ticks:
            pass
        return self.done
