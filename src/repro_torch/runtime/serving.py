"""Serving spine: continuous batching plus prefill/decode disaggregation
(port of ``repro.runtime.serving``).

Two serving modes share one model contract (``init_caches`` /
``decode_step`` with per-slot positions: every decoder arch of the port,
ring-buffer SWA caches included):

* **Colocated**: :class:`ContinuousBatcher`, the slot-based serving loop.
  One ``decode_step`` advances every active slot one token per tick;
  slots in *prefill* phase consume their next prompt token (logits
  ignored), slots in *decode* phase their previously generated token.
  Finished slots are reset (per-slot cache re-init, in place) and
  refilled from the queue.

* **Disaggregated**: :class:`DisaggregatedServer`.  One
  :class:`~repro_torch.core.comm.TorusComm` partitioned into a prefill
  and a decode domain (:class:`ServingTopology`, ``TorusComm.partition``),
  prompts ingested in chunks by :class:`PrefillWorker` instances, the same
  :class:`ContinuousBatcher` on the decode side, and the KV-cache handoff
  between the domains one :class:`~repro_torch.core.plan.KVMigrationPlan`
  call a tick: per-slot KV rows are the Alltoallv elements
  (:class:`KVRowCodec`), per-sequence lengths the send counts, the
  scheduler's placement the router.  A multi-tenant
  :class:`AdmissionController` applies per-tenant quotas and FIFO order
  within a tenant, and free decode slots hold prompt admission back.
  ``DisaggregatedServer.rebuild`` re-partitions both domains over the
  survivors of a device loss and replays every in-flight request
  (``requeue_inflight`` folds the generated tokens into the prompt).

The server runs on either kind of comm:

* **a dims-tuple comm** (one process): every prefill worker and the one
  decode batcher live in this process, and ``ServingTopology.migrate``
  runs the plan's exact host path on rows staged through host memory;
  ticks, migrations and ``done`` are the reference's.
* **a mesh-backed comm** (SPMD: every rank calls the same ``tick()``).
  The scheduler state is replicated and every rank takes the same
  decisions: admission queues and quotas, staged entries, the slot
  occupancy of every worker and decode shard, ``Request.generated`` and
  ``done``.  Model compute and KV rows stay on the rank that owns them:
  torus rank ``s < n_prefill`` runs prefill worker ``s``; decode rank
  ``n_prefill + d`` runs a :class:`ContinuousBatcher` over its share of
  ``decode_batch`` (contiguous slot ranges, split as evenly as the count
  allows).  The handoff is one ``KVMigrationPlan.forward`` on every rank
  (a source packs its staged rows into its ``(p, bucket, *row)`` send
  block on the device, a destination unpacks ``recv[s, :count]`` into
  the slot).  What the scheduler needs from the compute crosses ranks in
  at most two fixed-size int32 all-gathers a tick through the comm's
  ``all_gather`` plan: the completed prefills' first tokens before
  staging, and the decode tokens after the decode step together with
  each rank's drift flag (admission throttles when any rank drifted).
  **The destination rule:** the reference labels the destination
  ``n_prefill + rr % n_decode`` and admits into its one batcher's lowest
  free slot; here a staged sequence goes to the owner of the lowest free
  decode slot this tick has not taken, still at most one sequence per
  (src, dst) pair a tick.  With one decode rank the schedule is the
  reference's tick for tick; with more, each row still decodes alone, so
  ``done`` is the reference's.  ``rebuild(surviving)`` takes global
  ranks: the survivors rebuild the topology and replay, a rank not in
  the list leaves ``tick()`` and takes part in no further collective.

Because ``decode_step`` advances each batch row independently, a
request's tokens depend only on its own feed and cache rows: both paths
give the colocated batcher's tokens.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..core import telemetry
from ..models.common import resolve_device, tree_leaves


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    eos_id: int | None = None
    tenant: str = "default"
    generated: list[int] = field(default_factory=list)
    # how many generated tokens are already folded into ``prompt`` by a
    # requeue: keeps a second requeue from folding them again
    folded: int = 0


def _finished(req: Request) -> bool:
    return len(req.generated) >= req.max_new or (
        req.eos_id is not None and bool(req.generated)
        and req.generated[-1] == req.eos_id)


def _fold(req: Request) -> None:
    """Fold the tokens generated since the last fold into the prompt, so
    that a replay through prefill feeds them again and resumes where the
    request left off."""
    req.prompt = list(req.prompt) + list(req.generated[req.folded:])
    req.folded = len(req.generated)


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


def _drifted() -> bool:
    """This process's drift detector flags a plan: its measured times sit
    above the cost model's threshold (the signal the watchdog turns into
    a re-tune)."""
    return any(v["drifted"]
               for v in telemetry.drift_detector().summary().values())


def _decode_step_fn(model):
    @torch.no_grad()
    def serve_step(params, toks, caches):
        return model.decode_step(params, toks, caches)
    return serve_step


# ---------------------------------------------------------------------------
# The KV-row datatype: per-slot cache rows <-> flat Alltoallv elements
# ---------------------------------------------------------------------------


class KVRowCodec:
    """The derived-datatype layer of the KV handoff: one *row* per
    sequence slot of the cache, across every layer-state leaf.

    Built from ``models.transformer.cache_logical_axes``: each state leaf
    with a ``"seq_sp"`` logical axis contributes its per-slot features
    (``slot_pos`` included, as float32, so ring-buffer SWA caches migrate
    exactly).  The leaves are walked in the reference's order (sorted
    keys: ``k``, ``slot_pos``, ``v`` within a position, ``pos0``,
    ``pos1``, ... as strings), so a row's features are the reference's.
    ``pack`` flattens one batch slot's first ``n_rows`` sequence slots to
    an ``(n_rows, row_features)`` float32 tensor on the caches' device,
    the element type of the :class:`~repro_torch.core.plan
    .KVMigrationPlan`; ``unpack`` is its exact inverse, written in place
    into a freshly reset slot.

    Families whose recurrent state has no sequence axis (mamba, mLSTM,
    sLSTM, spectral) cannot split a sequence between domains:
    construction raises rather than migrate wrong state.
    """

    def __init__(self, model, max_seq: int):
        from ..models.transformer import cache_logical_axes
        logical = cache_logical_axes(model.cfg)["states"]
        shapes = model.init_caches(1, int(max_seq), "meta")["states"]
        axes_leaves = [ax for _, ax in tree_leaves(logical)]
        shape_leaves = [t for _, t in tree_leaves(shapes)]
        if len(axes_leaves) != len(shape_leaves):
            raise ValueError("cache_logical_axes does not match "
                             "init_caches structure")
        self._specs: list[tuple[int, int, int]] = []
        seq = None
        feats = 0
        for ax, sh in zip(axes_leaves, shape_leaves):
            if "seq_sp" not in ax or "batch" not in ax:
                raise ValueError(
                    "disaggregated serving needs per-slot sequence-sliced "
                    f"caches; a state leaf with logical axes {ax} has no "
                    "seq_sp axis (recurrent-state family, e.g. SSM/xLSTM "
                    "— its state cannot be split into KV rows)")
            bi, si = ax.index("batch"), ax.index("seq_sp")
            if seq is None:
                seq = int(sh.shape[si])
            elif int(sh.shape[si]) != seq:
                raise ValueError(f"unequal sequence extents across state "
                                 f"leaves: {sh.shape[si]} != {seq}")
            feat = 1
            for i, s in enumerate(sh.shape):
                if i not in (bi, si):
                    feat *= int(s)
            self._specs.append((bi, si, feat))
            feats += feat
        self.seq_slots = int(seq)
        self.row_features = int(feats)

    @property
    def row_shape(self) -> tuple[int, ...]:
        return (self.row_features,)

    def rows_for(self, prompt_len: int) -> int:
        """Sequence slots holding live state after prefilling
        ``prompt_len`` tokens: the per-sequence send count (a ring-buffer
        SWA cache caps it at the window)."""
        return min(int(prompt_len), self.seq_slots)

    def _leaves(self, states):
        return [a for _, a in tree_leaves(states)]

    def pack(self, states, b: int, n_rows: int) -> torch.Tensor:
        """Batch slot ``b``'s first ``n_rows`` sequence slots of every
        state leaf as one new ``(n_rows, row_features)`` float32 tensor on
        the caches' device."""
        segs = []
        for (bi, si, feat), a in zip(self._specs, self._leaves(states)):
            moved = a.movedim((bi, si), (0, 1))[b, :n_rows]
            segs.append(moved.reshape(n_rows, feat).to(torch.float32))
        if not segs:
            return torch.zeros((n_rows, 0), dtype=torch.float32)
        return torch.cat(segs, dim=1)

    def unpack(self, states, b: int, rows):
        """The exact inverse of :meth:`pack`: write ``rows`` (a tensor or
        an array) into batch slot ``b``'s leading sequence slots, in
        place.  The slot must have been freshly reset, so that the
        untouched trailing slots match the source's."""
        rows = torch.as_tensor(rows, dtype=torch.float32)
        n = rows.shape[0]
        off = 0
        for (bi, si, feat), a in zip(self._specs, self._leaves(states)):
            view = a.movedim((bi, si), (0, 1))
            seg = rows[:, off:off + feat].reshape(
                (n,) + tuple(view.shape[2:]))
            off += feat
            view[b, :n] = seg.to(device=a.device, dtype=a.dtype)
        return states


# ---------------------------------------------------------------------------
# Colocated serving (the decode side of the disaggregated topology)
# ---------------------------------------------------------------------------


class ContinuousBatcher:
    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 device="cuda", serve_step=None, comm=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        # The communicator this batcher serves over (optional): stats()
        # scopes its cache picture to it.
        self.comm = comm
        self.caches = model.init_caches(max_batch, max_seq, self.device)
        # a second tree: decode_step writes the live caches in place
        self._fresh = model.init_caches(max_batch, max_seq, self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.prefill_cursor = [0] * max_batch
        self.queue: list[Request] = []
        self.done: dict[int, list[int]] = {}
        self._step = serve_step or _decode_step_fn(model)
        self.ticks = 0

    # ---- scheduling ----
    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def pending(self) -> int:
        """Requests not yet finished: queued plus in flight."""
        return len(self.queue) + sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def admit_prefilled(self, req: Request, rows, pos: int, *,
                        codec: KVRowCodec) -> bool:
        """Admit a request whose prompt was prefilled elsewhere: reset the
        lowest free slot, unpack the migrated KV rows into it and resume
        in decode phase (cursor past the prompt, position ``pos``).
        Returns False when no slot is free."""
        for b in range(self.max_batch):
            if self.slots[b] is None:
                break
        else:
            return False
        _reset_slot(self.caches, self._fresh, b)
        codec.unpack(self.caches["states"], b, rows)
        self.caches["pos"][b] = int(pos)
        self.slots[b] = req
        self.prefill_cursor[b] = len(req.prompt)
        return True

    # ---- elasticity ----
    def requeue_inflight(self) -> int:
        """Pull every in-flight request back to the front of the queue
        for deterministic replay after a device loss: the tokens already
        generated are folded into the prompt (once: ``Request.folded``),
        so re-admission replays the exact token feed through prefill and
        resumes where the request left off.  Returns how many requests
        were requeued."""
        moved = []
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            _fold(req)
            moved.append(req)
            self.slots[b] = None
            self.prefill_cursor[b] = 0
        self.queue[:0] = moved
        return len(moved)

    def rebuild(self, *, model=None, params=None, serve_step=None) -> int:
        """After a device loss: requeue every in-flight request, then
        rebuild the slot caches (optionally with a new model, resharded
        params or step).  The queue, the requeued work included, drains
        on the next ``step()`` / ``run()``."""
        n = self.requeue_inflight()
        if model is not None:
            self.model = model
        if params is not None:
            self.params = params
        self.caches = self.model.init_caches(self.max_batch, self.max_seq,
                                             self.device)
        self._fresh = self.model.init_caches(self.max_batch, self.max_seq,
                                             self.device)
        self.prefill_cursor = [0] * self.max_batch
        if serve_step is not None:
            self._step = serve_step
        elif model is not None or params is not None:
            self._step = _decode_step_fn(self.model)
        return n

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

    # ---- introspection ----
    def stats(self) -> dict:
        """One call for the serving picture: scheduling counters plus the
        unified all-to-all cache state (``a2a_comm_stats``), scoped to
        this batcher's comm when it has one, registry-wide otherwise."""
        from ..core.comm import unified_stats
        return {
            "ticks": self.ticks,
            "max_batch": self.max_batch,
            "queued": len(self.queue),
            "active": sum(s is not None for s in self.slots),
            "done": len(self.done),
            "a2a_comm_stats": unified_stats() if self.comm is None
            else self.comm.stats(),
        }


# ---------------------------------------------------------------------------
# Disaggregated serving: prefill domain, admission, topology, server
# ---------------------------------------------------------------------------


class PrefillWorker:
    """One prefill rank: chunked prompt ingestion into its own slot
    caches.  ``step()`` advances up to ``chunk`` tokens per serving tick;
    a sequence whose prompt is fully consumed produces its first
    generated token, is packed to KV rows at once (before a later tick
    could wrap a ring buffer over them) and leaves the worker: the
    handoff payload.

    With ``compute=False`` (another rank's worker, on a mesh) it keeps
    the replicated slot bookkeeping only: no caches, no model call; its
    completions carry no rows and no first token, which the server learns
    from the worker's rank."""

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 codec: KVRowCodec, chunk: int = 4, device="cuda",
                 serve_step=None, compute: bool = True):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.codec = codec
        self.chunk = max(1, int(chunk))
        self.compute = compute
        self.device = resolve_device(device)
        if compute:
            self.caches = model.init_caches(max_batch, max_seq, self.device)
            self._fresh = model.init_caches(max_batch, max_seq, self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.cursor = [0] * max_batch
        self._step = serve_step or _decode_step_fn(model)
        self.ticks = 0

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def admit(self, req: Request) -> bool:
        for b in range(self.max_batch):
            if self.slots[b] is None:
                if self.compute:
                    _reset_slot(self.caches, self._fresh, b)
                self.slots[b] = req
                self.cursor[b] = 0
                return True
        return False

    def step(self) -> list[tuple[Request, torch.Tensor | None, int]]:
        """Run up to ``chunk`` prefill ticks; returns the completed
        handoffs as ``(request, kv_rows, position)`` triples (rows
        ``None`` without ``compute``)."""
        out = []
        for _ in range(self.chunk):
            if all(s is None for s in self.slots):
                break
            completing = any(req is not None
                             and self.cursor[b] == len(req.prompt) - 1
                             for b, req in enumerate(self.slots))
            nxt = None
            if self.compute:
                toks = np.zeros((self.max_batch, 1), np.int32)
                for b, req in enumerate(self.slots):
                    if req is not None:
                        toks[b, 0] = req.prompt[self.cursor[b]]
                logits, self.caches = self._step(
                    self.params, torch.as_tensor(toks, device=self.device),
                    self.caches)
                if completing:          # the only host read of a tick
                    nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for b, req in enumerate(self.slots):
                if req is None:
                    continue
                c = self.cursor[b]
                if c < len(req.prompt) - 1:
                    self.cursor[b] = c + 1             # still prefilling
                    continue
                # last prompt token consumed: first generation, then pack
                # the KV rows before a later tick can overwrite them
                self.cursor[b] = c + 1
                rows = None
                if self.compute:
                    req.generated.append(int(nxt[b]))
                    rows = self.codec.pack(self.caches["states"], b,
                                           self.codec.rows_for(
                                               len(req.prompt)))
                out.append((req, rows, len(req.prompt)))
                self.slots[b] = None
            self.ticks += 1
        return out

    def requeue_inflight(self) -> list[Request]:
        """Drain in-flight prompts for replay on a rebuilt topology (a
        prefilling request has no state to keep: its prompt replays from
        the start)."""
        moved = [req for req in self.slots if req is not None]
        self.slots = [None] * self.max_batch
        self.cursor = [0] * self.max_batch
        return moved


class AdmissionController:
    """Multi-tenant admission: FIFO within each tenant, round-robin
    across tenants, per-tenant in-flight quotas (``quotas`` per tenant,
    ``default_quota`` otherwise, ``None`` = unlimited).  The server's
    decode-slot backpressure sets how many requests each ``admit`` call
    may release."""

    def __init__(self, *, quotas=None, default_quota: int | None = None):
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        self.queues: dict[str, deque] = {}
        self.inflight: dict[str, int] = {}
        self._order: list[str] = []
        self._rr = 0

    def submit(self, req: Request):
        if req.tenant not in self.queues:
            self.queues[req.tenant] = deque()
            self._order.append(req.tenant)
        self.queues[req.tenant].append(req)

    def requeue_front(self, reqs) -> None:
        """Push replayed requests back to the *front* of their tenants'
        queues (requeued work precedes anything newly submitted)."""
        for req in reversed(list(reqs)):
            if req.tenant not in self.queues:
                self.queues[req.tenant] = deque()
                self._order.append(req.tenant)
            self.queues[req.tenant].appendleft(req)

    def quota(self, tenant: str) -> int | None:
        return self.quotas.get(tenant, self.default_quota)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def admit(self, n: int) -> list[Request]:
        """Release up to ``n`` requests, rotating across tenants."""
        out: list[Request] = []
        while len(out) < n and self._order:
            progressed = False
            for _ in range(len(self._order)):
                t = self._order[self._rr % len(self._order)]
                self._rr += 1
                q = self.queues.get(t)
                if not q:
                    continue
                quota = self.quota(t)
                if quota is not None and self.inflight.get(t, 0) >= quota:
                    continue
                out.append(q.popleft())
                self.inflight[t] = self.inflight.get(t, 0) + 1
                progressed = True
                if len(out) >= n:
                    break
            if not progressed:
                break
        return out

    def release(self, req: Request) -> None:
        self.inflight[req.tenant] = max(
            0, self.inflight.get(req.tenant, 0) - 1)


class ServingTopology:
    """One serving torus partitioned into prefill and decode domains.

    ``comm.partition(n_prefill)`` gives the two domain sub-comms (the
    ``MPI_Comm_split`` by rank range); the KV handoff between them is one
    :class:`~repro_torch.core.plan.KVMigrationPlan` over the *full*
    comm: ranks ``0..n_prefill-1`` are prefill sources, the rest decode
    destinations.  Without ``n_prefill`` the split is sized by the
    alpha-beta model (``core.tuning.choose_serving_split``), the
    predicted migration cost included.  On a mesh-backed comm
    construction is collective over the comm's ranks.
    """

    def __init__(self, comm, *, row_shape, max_count: int,
                 dtype="float32", n_prefill: int | None = None,
                 migrations_per_tick: float = 1.0, backend: str = "tuned",
                 links=None):
        from ..core.plan import itemsize
        from ..core.tuning import choose_serving_split
        self.split = None
        if n_prefill is None:
            row_bytes = math.prod(tuple(row_shape)) * itemsize(dtype)
            self.split = choose_serving_split(
                comm.dims, links, row_bytes=float(row_bytes),
                max_count=int(max_count),
                migrations_per_tick=migrations_per_tick)
            n_prefill = self.split.n_prefill
        self.comm = comm
        self.n_prefill = int(n_prefill)
        self.prefill_comm, self.decode_comm = comm.partition(self.n_prefill)
        self.plan = comm.kv_migration(
            tuple(row_shape), dtype, max_count=int(max_count),
            n_prefill=self.n_prefill,
            migrations_per_tick=migrations_per_tick, backend=backend,
            links=links)
        self.migrated_rows = 0
        self.migrations = 0

    @property
    def n_decode(self) -> int:
        return self.comm.p - self.n_prefill

    def migrate(self, rows_by_pair: dict) -> dict:
        """One KV handoff tick in one process: ``{(src, dst): rows}`` in,
        the delivered rows per pair out, through the plan's exact host
        path (one collective over every pair, never a per-sequence copy
        loop).  Rows are staged through host memory."""
        if not rows_by_pair:
            return {}
        counts = self.plan.pair_counts(
            {k: len(v) for k, v in rows_by_pair.items()})
        p = self.comm.p
        rows = [[[] for _ in range(p)] for _ in range(p)]
        for (s, d), rs in rows_by_pair.items():
            rows[s][d] = torch.as_tensor(rs).cpu().numpy()
        recv, _ = self.plan.exact(rows)
        self.migrations += 1
        self.migrated_rows += int(counts.sum())
        return {(s, d): recv[d][s] for (s, d) in rows_by_pair}

    def exchange(self, send, counts: np.ndarray):
        """One KV handoff tick on a mesh (collective: every rank of the
        comm): ``send`` is this rank's ``(p, bucket, *row)`` block, row
        ``d`` holding its rows for torus rank ``d`` at the front;
        ``counts`` the replicated ``(p, p)`` matrix of
        :meth:`KVMigrationPlan.pair_counts`.  Returns ``recv``, whose
        block ``s`` holds ``counts[s, rank]`` rows from rank ``s``."""
        rank = self.comm.rank
        recv, _ = self.plan.forward(
            send, torch.as_tensor(counts[rank], device=send.device))
        self.migrations += 1
        self.migrated_rows += int(counts.sum())
        return recv

    def rebuild(self, surviving_devices, *,
                n_prefill: int | None = None) -> "ServingTopology":
        """Elastic re-partition: rebuild the comm over the survivors (this
        topology's plan slice is freed), then split the fresh torus into
        new domains (sized by the cost model unless pinned)."""
        fresh = self.comm.rebuild(surviving_devices)
        return ServingTopology(
            fresh, row_shape=self.plan.row_shape,
            max_count=self.plan.max_count, dtype=self.plan.dtype,
            n_prefill=n_prefill,
            migrations_per_tick=self.plan.migrations_per_tick,
            backend=self.plan.requested_backend)

    def describe(self) -> dict:
        return {
            "kind": "serving_topology",
            "comm": self.comm.describe(),
            "n_prefill": self.n_prefill,
            "n_decode": self.n_decode,
            "prefill_axes": list(self.prefill_comm.axis_names),
            "prefill_dims": list(self.prefill_comm.dims),
            "decode_axes": list(self.decode_comm.axis_names),
            "decode_dims": list(self.decode_comm.dims),
            "plan": self.plan.describe(),
            "split": None if self.split is None else {
                "predicted_seconds": self.split.predicted_seconds,
                "migration_kind": self.split.migration_kind,
            },
            "migrations": self.migrations,
            "migrated_rows": self.migrated_rows,
        }


def _shares(n: int, parts: int) -> list[tuple[int, int]]:
    """``n`` slots in ``parts`` contiguous ranges, sizes as even as the
    count allows (the larger ones first)."""
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + n // parts + (i < n % parts))
    return list(zip(bounds[:-1], bounds[1:]))


class DisaggregatedServer:
    """The serving API over one torus: admission -> prefill domain -> KV
    migration -> decode domain, one tick at a time.

    Per tick: the admission controller releases as many prompts as the
    decode domain has headroom for, the prefill workers advance their
    chunks, completed prefills stage for migration, at most one staged
    sequence per (src, dst) pair moves in ONE plan call, and the decode
    domain ticks.  ``rebuild`` replays every in-flight request on a
    re-partitioned survivor topology.  The comm decides the path (module
    docstring): one process on a dims-tuple comm, SPMD on a mesh-backed
    one.  ``device`` defaults to ``cuda`` and raises without a card.
    """

    def __init__(self, model, params, comm, *, max_seq: int,
                 decode_batch: int, prefill_batch: int = 2,
                 n_prefill: int | None = None, chunk: int = 4,
                 quotas=None, default_quota: int | None = None,
                 backend: str = "tuned", migrations_per_tick=None,
                 serve_step=None, device="cuda"):
        self.model = model
        self.params = params
        self.max_seq = int(max_seq)
        self.decode_batch = int(decode_batch)
        self.prefill_batch = int(prefill_batch)
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self._serve_step = serve_step
        self.codec = KVRowCodec(model, max_seq)
        if migrations_per_tick is None:
            migrations_per_tick = 1.0
        self.spmd = comm.mesh is not None
        self.topology = ServingTopology(
            comm, row_shape=self.codec.row_shape,
            max_count=self.codec.seq_slots, n_prefill=n_prefill,
            migrations_per_tick=migrations_per_tick, backend=backend)
        self.admission = AdmissionController(quotas=quotas,
                                             default_quota=default_quota)
        self.lost = False
        self._build_domains()
        self.staged: list[tuple[int, Request, object, int]] = []
        self._decoding: dict[int, Request] = {}
        self.done: dict[int, list[int]] = {}
        self.ticks = 0
        self._rr_dst = 0
        # any rank's drift flag, replicated (the mesh path's admission)
        self._drift = self._any_drifted() if self.spmd else False

    def _build_domains(self):
        topo = self.topology
        self.rank = topo.comm.rank if self.spmd else None
        self.workers = [
            PrefillWorker(self.model, self.params,
                          max_batch=self.prefill_batch,
                          max_seq=self.max_seq, codec=self.codec,
                          chunk=self.chunk, device=self.device,
                          serve_step=self._serve_step,
                          compute=not self.spmd or s == self.rank)
            for s in range(topo.n_prefill)]
        if not self.spmd:
            self.batcher = ContinuousBatcher(
                self.model, self.params, max_batch=self.decode_batch,
                max_seq=self.max_seq, device=self.device,
                comm=topo.decode_comm, serve_step=self._serve_step)
            return
        # the decode shards: rank n_prefill + d owns global slots
        # [lo, hi) of the replicated slot list
        self.shares = _shares(self.decode_batch, topo.n_decode)
        self.decode_slots: list[Request | None] = [None] * self.decode_batch
        self.batcher = None
        d = self.rank - topo.n_prefill
        if d >= 0 and self.shares[d][1] > self.shares[d][0]:
            lo, hi = self.shares[d]
            self.batcher = ContinuousBatcher(
                self.model, self.params, max_batch=hi - lo,
                max_seq=self.max_seq, device=self.device,
                comm=topo.decode_comm, serve_step=self._serve_step)
        share = max(hi - lo for lo, hi in self.shares)
        self._gather_len = 2 * max(self.prefill_batch, share) + 1
        self._gather_plan = topo.comm.all_gather((self._gather_len,),
                                                 torch.int32)
        self._send = None

    # ---- scheduling ----
    def submit(self, req: Request):
        self.admission.submit(req)

    def _decode_pending(self) -> int:
        if self.spmd:
            return sum(s is not None for s in self.decode_slots)
        return self.batcher.pending

    def _decode_free(self) -> int:
        if self.spmd:
            return sum(s is None for s in self.decode_slots)
        return self.batcher.free_slots

    @property
    def pending(self) -> int:
        return (self.admission.pending + len(self.staged)
                + sum(w.active for w in self.workers)
                + self._decode_pending())

    # ---- the mesh path's replicated state ----
    def _gather(self, block: np.ndarray) -> np.ndarray:
        """One fixed-size int32 all-gather over the serving comm:
        ``(p, gather_len)``, row ``r`` rank ``r``'s block."""
        x = torch.from_numpy(block).to(self.device)
        return self._gather_plan.forward(x).cpu().numpy()

    def _any_drifted(self) -> bool:
        """Whether any rank's drift detector flags a plan: one gather of
        the flags alone (at construction; each tick's flags ride in the
        decode tokens' gather)."""
        block = np.full(self._gather_len, -1, np.int32)
        block[-1] = _drifted()
        return bool((self._gather(block)[:, -1] == 1).any())

    def _share_first_tokens(self, completed) -> None:
        """The completed prefills' first tokens, from each worker's rank
        (each worker completes at most ``prefill_batch`` a tick)."""
        block = np.full(self._gather_len, -1, np.int32)
        mine = [req for src, req, _, _ in completed if src == self.rank]
        for i, req in enumerate(mine):
            block[2 * i:2 * i + 2] = (req.rid, req.generated[-1])
        rows = self._gather(block)
        seen = [0] * len(self.workers)
        for src, req, _, _ in completed:
            i = seen[src]
            seen[src] += 1
            if src == self.rank:
                continue
            rid, tok = rows[src, 2 * i:2 * i + 2]
            assert rid == req.rid, (rid, req.rid)
            req.generated.append(int(tok))

    # ---- the KV handoff ----
    def _place_round_robin(self) -> dict:
        """The reference's placement: destination ``n_prefill + rr %
        n_decode``, gated on free decode slots and one sequence per
        (src, dst) pair."""
        free = self._decode_free()
        batch: dict[tuple[int, int], tuple] = {}
        remaining = []
        for entry in self.staged:
            src = entry[0]
            dst = self.topology.n_prefill \
                + self._rr_dst % self.topology.n_decode
            if len(batch) < free and (src, dst) not in batch:
                batch[(src, dst)] = entry
                self._rr_dst += 1
            else:
                remaining.append(entry)
        self.staged = remaining
        return batch

    def _place_lowest_slot(self) -> dict:
        """The mesh's placement: the owner of the lowest free decode slot
        this tick has not taken, one sequence per (src, dst) pair; maps
        each pair to ``(global slot, entry)``."""
        free = [g for g, s in enumerate(self.decode_slots) if s is None]
        owner = {g: self.topology.n_prefill + d
                 for d, (lo, hi) in enumerate(self.shares)
                 for g in range(lo, hi)}
        batch: dict[tuple[int, int], tuple] = {}
        remaining = []
        for entry in self.staged:
            if len(batch) < len(free):
                g = free[len(batch)]
                pair = (entry[0], owner[g])
                if pair not in batch:
                    batch[pair] = (g, entry)
                    continue
            remaining.append(entry)
        self.staged = remaining
        return batch

    def _handoff_one_process(self, batch: dict) -> None:
        delivered = self.topology.migrate(
            {pair: e[2] for pair, e in batch.items()})
        for pair, (_, req, _, pos) in batch.items():
            ok = self.batcher.admit_prefilled(
                req, delivered[pair], pos, codec=self.codec)
            assert ok, "migration was gated on free decode slots"
            self._decoding[req.rid] = req

    def _handoff_spmd(self, batch: dict) -> None:
        topo = self.topology
        plan = topo.plan
        counts = plan.pair_counts(
            {pair: self.codec.rows_for(e[3]) for pair, (_, e) in
             batch.items()})
        if self._send is None:
            self._send = torch.zeros((plan.p, plan.bucket)
                                     + tuple(plan.row_shape),
                                     dtype=torch.float32, device=self.device)
        for (s, d), (_, (_, _, rows, _)) in batch.items():
            if s == self.rank:
                self._send[d, :rows.shape[0]] = rows
        recv = topo.exchange(self._send, counts)
        for (s, d), (g, (_, req, _, pos)) in batch.items():
            if d == self.rank:
                lo = self.shares[d - topo.n_prefill][0]
                assert self.batcher.slots[g - lo] is None and all(
                    self.batcher.slots[:g - lo]), "not the lowest free slot"
                self.batcher.admit_prefilled(
                    req, recv[s, :counts[s, d]], pos, codec=self.codec)
            self.decode_slots[g] = req

    # ---- decode ----
    def _decode_one_process(self) -> int:
        self.batcher.step()
        finished = 0
        for rid, toks in list(self.batcher.done.items()):
            if rid not in self.done:
                self.done[rid] = toks
                finished += 1
            req = self._decoding.pop(rid, None)
            if req is not None:
                self.admission.release(req)
        return finished

    def _decode_spmd(self) -> int:
        """Every decode shard ticks; the tokens and drift flags cross
        ranks in one all-gather; every rank then finishes the same
        requests."""
        if all(s is None for s in self.decode_slots):
            return 0
        block = np.full(self._gather_len, -1, np.int32)
        if self.batcher is not None:
            before = list(self.batcher.slots)
            self.batcher.step()
            for b, req in enumerate(before):
                if req is not None:
                    block[2 * b:2 * b + 2] = (req.rid, req.generated[-1])
        block[-1] = _drifted()
        rows = self._gather(block)
        self._drift = bool((rows[:, -1] == 1).any())
        finished = 0
        for d, (lo, hi) in enumerate(self.shares):
            r = self.topology.n_prefill + d
            for j, g in enumerate(range(lo, hi)):
                req = self.decode_slots[g]
                if req is None:
                    continue
                rid, tok = rows[r, 2 * j:2 * j + 2]
                assert rid == req.rid, (rid, req.rid)
                if r != self.rank:
                    req.generated.append(int(tok))
                if _finished(req):
                    self.done[req.rid] = list(req.generated)
                    self.decode_slots[g] = None
                    self.admission.release(req)
                    finished += 1
        return finished

    # ---- main loop ----
    def tick(self) -> bool:
        """One serving tick; returns False once the system is drained (or,
        on a mesh, once this rank was left out of a rebuild)."""
        if self.lost or self.pending == 0:
            return False
        tr = telemetry.get_tracer()
        with tr.span("serve.tick", cat="serving", tick=self.ticks):
            # 1. admission, throttled by decode headroom: never release
            # more prompts than the decode domain can absorb beyond what
            # is already in flight through prefill and migration.
            with tr.span("serve.admission", cat="serving") as sp:
                headroom = self.decode_batch - self._decode_pending() \
                    - len(self.staged) - sum(w.active for w in self.workers)
                budget = min(max(0, headroom),
                             sum(w.free_slots for w in self.workers))
                # drift backpressure: while a plan's measured times sit
                # above the cost model's threshold, halve the budget
                drifted = self._drift if self.spmd else _drifted()
                if budget > 0 and drifted:
                    budget //= 2
                    telemetry.metrics().counter(
                        "serving.admission_throttled").inc()
                    sp.set(drift_throttled=True)
                admitted = 0
                for req in self.admission.admit(budget):
                    # least-loaded prefill worker = the placement router
                    worker = max(self.workers, key=lambda w: w.free_slots)
                    assert worker.admit(req)
                    admitted += 1
                sp.set(budget=budget, admitted=admitted)
            # 2. prefill chunks; completed prompts stage for migration (a
            # request finished by its first token skips the decode domain)
            with tr.span("serve.prefill", cat="serving") as sp:
                completed = [(src, req, rows, pos)
                             for src, worker in enumerate(self.workers)
                             for req, rows, pos in worker.step()]
                if self.spmd and completed:
                    self._share_first_tokens(completed)
                for src, req, rows, pos in completed:
                    if _finished(req):
                        self.done[req.rid] = list(req.generated)
                        self.admission.release(req)
                    else:
                        self.staged.append((src, req, rows, pos))
                sp.set(completed=len(completed))
            # 3. KV migration: at most one staged sequence per (src, dst)
            # pair a tick, gated on free decode slots, in one collective
            with tr.span("serve.kv_migrate", cat="serving") as sp:
                if self.spmd:
                    batch = self._place_lowest_slot()
                    if batch:
                        self._handoff_spmd(batch)
                else:
                    batch = self._place_round_robin()
                    if batch:
                        self._handoff_one_process(batch)
                sp.set(migrated=len(batch))
            # 4. decode tick + completion bookkeeping
            with tr.span("serve.decode", cat="serving") as sp:
                finished = self._decode_spmd() if self.spmd \
                    else self._decode_one_process()
                sp.set(finished=finished)
        self.ticks += 1
        return True

    def run(self, max_ticks: int = 100_000):
        while self.tick() and self.ticks < max_ticks:
            pass
        return self.done

    # ---- elasticity ----
    def rebuild(self, surviving_devices, *,
                params=None, n_prefill: int | None = None) -> int:
        """Detect -> degrade -> rebuild -> resume: requeue every in-flight
        request (decode and staged ones fold their generated tokens into
        the prompt; prefilling ones replay from the start), re-partition
        the survivor torus into fresh domains, and let the admission
        queue drain through the new topology.  Returns the requeue count.

        On a mesh every rank of the old comm calls it with the same
        global rank list; the survivors rebuild collectively, and a rank
        not in the list drops its state and leaves (returns 0, ``tick()``
        then returns False).  A staged request's first token is folded
        too (the reference replays it unfolded, so its replay generates
        that token a second time)."""
        if self.spmd:
            if isinstance(surviving_devices, int):
                surviving_devices = self.topology.comm.mesh.mesh.flatten() \
                    .tolist()[:surviving_devices]
            if dist.get_rank() not in surviving_devices:
                self.lost = True
                self.workers, self.batcher, self._send = [], None, None
                return 0
        if params is not None:
            self.params = params
        if self.spmd:
            decode_reqs = [req for req in self.decode_slots
                           if req is not None]
            for req in decode_reqs:
                _fold(req)
        else:
            self.batcher.requeue_inflight()
            decode_reqs = list(self.batcher.queue)
            self.batcher.queue.clear()
        staged_reqs = [req for (_, req, _, _) in self.staged]
        for req in staged_reqs:
            _fold(req)
        self.staged = []
        prefill_reqs = []
        for worker in self.workers:
            prefill_reqs.extend(worker.requeue_inflight())
        reqs = decode_reqs + staged_reqs + prefill_reqs
        self._decoding.clear()
        for req in reqs:
            self.admission.release(req)
        self.admission.requeue_front(reqs)
        self.topology = self.topology.rebuild(surviving_devices,
                                              n_prefill=n_prefill)
        self._build_domains()
        return len(reqs)

    # ---- introspection ----
    def stats(self) -> dict:
        topo = self.topology
        if self.spmd:
            from ..core.comm import unified_stats
            out = {"ticks": 0 if self.batcher is None
                   else self.batcher.ticks,
                   "max_batch": self.decode_batch,
                   "queued": 0,
                   "active": self._decode_pending(),
                   "done": len(self.done),
                   "a2a_comm_stats": unified_stats() if self.lost
                   else topo.decode_comm.stats()}
        else:
            out = self.batcher.stats()
        out.update({
            "server_ticks": self.ticks,
            "pending": self.pending,
            "staged": len(self.staged),
            "prefill_active": [w.active for w in self.workers],
            "topology": topo.describe(),
        })
        return out
