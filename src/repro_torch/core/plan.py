"""The cached plan objects of every all-to-all the port runs (port of
``repro.core.plan``): :class:`A2APlan` (dense), :class:`RaggedA2APlan`
and :class:`SparseA2APlan` (``MPI_Alltoallv`` semantics), and the
pencil re-shard :class:`TransposePlan`.

``plan_all_to_all`` resolves, once per ``(ranks, axes, shape, dtype,
knobs)`` key, the torus factorization (``core.cache``, with its process
groups when a ``DeviceMesh`` is given), the backend — requested
explicitly, chosen by the alpha-beta cost model (``backend="tuned"`` →
``tuning.choose_algorithm``) or replayed from the tuning DB
(``backend="autotune"`` → ``core.autotune``: a hit builds the measured
winner, a miss falls back to the cost model) — the forward and reverse
round orders and the chunk count, and returns an :class:`A2APlan` whose
``forward`` / ``reverse`` / ``tiled`` / ``overlap`` methods are the
execution surface (MoE dispatch and combine): ``direct``, ``factorized``,
and the chunked overlap engine (``pipelined``, ``overlap``:
``core.overlap``).

``plan_ragged_all_to_all`` composes two dense plans over the same torus,
the int32 counts plan and the bucket-padded data plan (``core.ragged``);
``plan_sparse_all_to_all`` keeps the counts plan and replaces the data
rounds with skippable per-peer lanes (``core.sparse``);
``plan_transpose`` wraps a dense plan over one pencil chunk into the
distributed FFT's re-shard (:class:`TransposePlan`);
``plan_kv_migration`` wraps a ragged or sparse plan into the
prefill -> decode KV handoff of disaggregated serving
(:class:`KVMigrationPlan`).  All plans live
in one bounded LRU registry; evicting a composite plan drops its nested
entries, and evicting the last plan over a factorization releases the
descriptor (the paper's delete callback).

With the tracer on (``core.telemetry.enable_tracing``), each call of an
execution method runs under a ``plan.execute`` span with ``plan.round``
children and feeds the drift detector; off, the check is one attribute
load and a branch.  The traced call runs what the untraced one does, pass
for pass, and only adds the spans and a device synchronise at each
round's end.

Under autograd (an operand that requires grad, grad mode on) every
execution method is differentiable, as ``jax.grad`` through the
reference's plans is: a blockwise all-to-all permutes the global buffer
and is its own transpose, so ``forward``'s backward is ``reverse`` on the
cotangent and ``reverse``'s is ``forward`` (``_BlockwiseFn``: the same
passes, exchanges and kernels, traced or not); ``tiled`` differentiates
through its split and join; ``overlap`` is one ``core.overlap.OverlapFn``
whose backward is the same pipeline; a ragged call's data rounds are the
dense plan's, and a sparse call's rounds run backward with the lanes of
the transposed count matrix (``core.sparse``).  Calls outside autograd
take the untraced path as before, launch for launch.

Resolution is the reference's, line for line (same cost model, same
keys), so ``describe()`` gives the reference's dict for every backend.
The reference's ``host_fn`` (a jitted call on a global ``(p, p, *block)``
array) has no SPMD counterpart here: each rank runs ``forward`` on its
own ``(p, *block)`` buffer (one process holding every rank's rows runs a
plan's exact host path, ``exact``).
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.ops import _trains

from . import telemetry
from .cache import (
    LRUCache,
    TorusFactorization,
    device_fingerprint,
    get_factorization,
    mesh_shape,
)
from .factorized import (
    _as_tuple,
    _check_order,
    _direct_impl,
    _direct_tiled_impl,
    _factorized_impl,
    _factorized_tiled_impl,
    _skip_trivial,
    _tiled,
)
from .overlap import (_overlapped_impl, _overlapped_tiled_impl,
                      overlap_autograd)
from .tuning import (
    LinkModel,
    Schedule,
    choose_algorithm,
    per_axis_round_seconds,
    predict_direct,
    predict_factorized,
    predict_kv_migration,
    predict_overlapped,
    predict_sparse,
    resolve_links,
    slowest_active_link,
)

BACKENDS = ("tuned", "autotune", "direct", "factorized", "pipelined",
            "overlap")

# The tracer singleton is never rebound (enable / disable mutate it in
# place), so the execution methods read ``_TRACER.enabled`` directly.
_TRACER = telemetry.get_tracer()


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def dtype_name(dtype) -> str:
    return str(torch_dtype(dtype)).removeprefix("torch.")


def itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _sync(t) -> None:
    """End a traced span with the device work it launched."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class _BlockwiseFn(torch.autograd.Function):
    """One plan call under autograd: ``run`` is the call, ``adjoint`` its
    transpose, which the backward runs on the cotangent.  A blockwise
    all-to-all permutes the global buffer (rank ``s``'s block ``d`` goes
    to rank ``d``'s slot ``s``) and is its own transpose, so its adjoint
    is the plan in the other direction: the same passes and exchanges,
    and bit for bit the adjoint (``run`` and ``adjoint`` are the plan's
    untraced or traced calls in the two round orders).  The gather
    family's all-gather and reduce-scatter (``core.comm``) are each
    other's transpose."""

    @staticmethod
    def forward(ctx, x, run, adjoint):
        ctx.adjoint = adjoint
        return run(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.adjoint(g.contiguous()), None, None


class A2APlan:
    """A resolved, reusable all-to-all execution plan.

    Construct via :func:`plan_all_to_all` (or ``TorusComm.all_to_all``);
    never directly.  All resolution happens at construction; the
    execution methods only replay the chosen algorithm on this rank's
    buffer, collectively with the other ranks of the torus.
    """

    def __init__(self, fact: TorusFactorization, *, requested_backend: str,
                 backend: str, variant: str, order: tuple[int, ...],
                 rev_order: tuple[int, ...], n_chunks: int,
                 block_shape: tuple[int, ...] | None, dtype,
                 links: tuple[LinkModel, ...], schedule: Schedule | None,
                 tuned_from: str | None = None,
                 measured: dict | None = None):
        self.fact = fact
        self.requested_backend = requested_backend
        self.backend = backend
        self.variant = variant
        self.order = order
        self.rev_order = rev_order
        self.n_chunks = n_chunks
        self.block_shape = block_shape
        self.dtype = dtype
        self.links = links
        self.schedule = schedule
        # Provenance of the backend choice: "model" (alpha-beta cost
        # model), "measured" (tuning-DB hit, ``measured`` holds the
        # record's table) or None (caller requested an explicit backend).
        self.tuned_from = tuned_from
        self.measured = measured
        self._from_cache = False

    # -- identity ----------------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.fact.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.fact.dims

    @property
    def p(self) -> int:
        return self.fact.p

    @property
    def d(self) -> int:
        return self.fact.d

    @property
    def block_bytes(self) -> int | None:
        if self.block_shape is None or self.dtype is None:
            return None
        return math.prod(self.block_shape) * itemsize(self.dtype)

    # -- execution surface (collective: every rank of the torus) ----------

    def forward(self, x):
        """Blockwise all-to-all: ``x`` is ``(p, *block)``, block ``i``
        destined for torus rank ``i``; returns ``out[i]`` = block received
        from rank ``i``.  Under autograd its backward is :meth:`reverse`
        on the cotangent."""
        return self._call(x, self.order, self.rev_order)

    def reverse(self, x):
        """The combine-direction all-to-all: same semantics as ``forward``
        but rounds run in the drain order (``rev_order``).  Bit-identical
        to ``forward`` for any order — rounds commute.  Under autograd its
        backward is :meth:`forward` on the cotangent."""
        return self._call(x, self.rev_order, self.order)

    def _call(self, x, order, adjoint_order):
        """One blockwise call in ``order``; under autograd through
        :class:`_BlockwiseFn`, whose backward runs ``adjoint_order``."""
        if _trains(x):
            return _BlockwiseFn.apply(
                x, lambda t: self._run(t, order),
                lambda g: self._run(g, adjoint_order))
        return self._run(x, order)

    def _run(self, x, order):
        if _TRACER.enabled:
            return self._traced_execute(x, order)
        return self._execute(x, order)

    def _execute(self, x, order, round_span=None):
        """The untraced blockwise call; ``round_span(i, k)`` (a factorized
        plan's stepped form) wraps round ``i`` of the call in a context."""
        if x.shape[0] != self.p:
            raise ValueError(f"leading dim {x.shape[0]} != p={self.p} "
                             f"({self.dims})")
        if self.backend == "direct":
            return _direct_impl(x, self.fact)
        if self.backend == "factorized":
            return _factorized_impl(x, self.fact, variant=self.variant,
                                    round_order=order, round_span=round_span)
        return _overlapped_impl(x, self.fact, n_chunks=self.n_chunks,
                                variant=self.variant, round_order=order)

    def tiled(self, x, split_axis: int, concat_axis: int, *,
              reverse: bool = False):
        """Tiled-semantics all-to-all: split ``split_axis`` into ``p``
        chunks (chunk ``t`` -> torus rank ``t``) and concatenate what
        arrives source-major along ``concat_axis``.  Under autograd the
        blockwise exchange inside is :class:`_BlockwiseFn` (the split and
        the join are views and reshapes autograd differentiates), so the
        backward is ``tiled(g, concat_axis, split_axis)`` in the other
        direction."""
        order, adjoint = (self.rev_order, self.order) if reverse \
            else (self.order, self.rev_order)
        if _TRACER.enabled or _trains(x):
            return _tiled(x, self.fact, split_axis, concat_axis,
                          lambda xb: self._call(xb, order, adjoint))
        if self.backend == "direct":
            return _direct_tiled_impl(x, self.fact, split_axis, concat_axis)
        if self.backend == "factorized":
            return _factorized_tiled_impl(x, self.fact, split_axis,
                                          concat_axis, variant=self.variant,
                                          round_order=order)
        return _overlapped_tiled_impl(x, self.fact, split_axis, concat_axis,
                                      n_chunks=self.n_chunks,
                                      variant=self.variant,
                                      round_order=order)

    def overlap(self, x, compute_fn: Callable | None = None, *,
                reverse: bool = True, chunk_axis: int | None = None,
                params=None):
        """Fused forward / per-chunk compute / reverse pipeline
        (``core.overlap``): chunk ``c``'s forward rounds are issued next
        to chunk ``c-1``'s compute and chunk ``c-2``'s reverse rounds.
        Bit for bit ``reverse(compute_fn(forward(x)))``, since chunks
        never interact.  Traced, the pipeline is one fused round span
        whose drift key gains ``:overlap`` (its time holds both
        directions and the compute).

        Under autograd (``x`` or one of ``params`` requires grad) the call
        is one ``core.overlap.OverlapFn``: ``params`` are the tensors
        ``compute_fn`` reads that need gradients (``()`` if none; with a
        ``compute_fn`` they must be given, so that no gradient is lost
        silently), and the backward runs the same pipeline on the
        cotangent; with ``reverse=False`` and a ``compute_fn``, per chunk
        the compute's vjp, then the rounds in the reverse order."""
        def run(t, fn, backward=False):
            # backward: the vjp of reverse=False's compute stage, then its
            # rounds in the reverse order (core.overlap.overlap_autograd)
            def pipeline():
                return _overlapped_impl(
                    t, self.fact, n_chunks=self.n_chunks,
                    variant=self.variant, round_order=self.order,
                    compute_fn=fn, reverse=reverse or backward,
                    reverse_round_order=self.rev_order,
                    chunk_axis=chunk_axis, forward_rounds=not backward)
            if _TRACER.enabled:
                return self._traced_execute(
                    t, self.rev_order if backward else self.order,
                    pipeline=pipeline, directions=1 + bool(reverse))
            return pipeline()
        params = tuple(params) if params is not None else None
        if _trains(x, *(params or ())):
            if compute_fn is not None and params is None:
                raise ValueError(
                    "overlap(compute_fn=...) under autograd needs params=: "
                    "the tensors compute_fn reads that need gradients "
                    "(() if none)")
            return overlap_autograd(x, run, compute_fn, reverse=reverse,
                                    params=params or ())
        return run(x, compute_fn)

    # -- telemetry-traced execution ----------------------------------------

    def _drift_key(self) -> str:
        """Stable drift-detector key: one time series per resolved plan
        identity (axes x dims x backend x block)."""
        dims = "x".join(str(s) for s in self.dims)
        return (f"dense[{','.join(self.axis_names)}]{dims}:{self.backend}"
                f":{self.block_bytes}")

    def _per_axis_predictions(self) -> dict[str, float] | None:
        """``{axis_name: model seconds}`` for the active rounds, or None
        without a sized block (tiled plans carry no block shape)."""
        if self.block_bytes is None:
            return None
        per_axis = per_axis_round_seconds(self.dims, self.links,
                                          float(self.block_bytes))
        return {name: t for name, Dk, t
                in zip(self.axis_names, self.dims, per_axis) if Dk > 1}

    def _traced_execute(self, x, order, *, pipeline=None, directions=1):
        """One call under a ``plan.execute`` span: a factorized plan's
        rounds one ``plan.round`` span each (round 0's holds the first
        pack; each holds its exchange and the reorder after it, the last
        the final unpack: the untraced call's passes), every other
        backend one fused round span; each round span ends in a device
        synchronise.  Feeds the drift detector per round and per call."""
        tr = _TRACER
        det = telemetry.drift_detector()
        key = self._drift_key()
        preds = self._per_axis_predictions()
        predicted = self.schedule.predicted_seconds \
            if self.schedule is not None \
            else (sum(preds.values()) if preds else None)
        if pipeline is not None:
            key += ":overlap"
            predicted = None if predicted is None else predicted * directions
        telemetry.metrics().counter("plan.traced_executions").inc()
        with tr.span("plan.execute", cat="plan", kind="dense",
                     backend=self.backend, axes=",".join(self.axis_names),
                     dims="x".join(str(s) for s in self.dims),
                     predicted_seconds=predicted, tuned_from=self.tuned_from,
                     drift_key=key) as ex:
            t0 = time.perf_counter()
            y = self._traced_rounds(x, order, key, preds, predicted,
                                    pipeline)
            measured = time.perf_counter() - t0
            ratio = det.observe(key, predicted, measured) \
                if predicted else None
            ex.set(measured_seconds=measured, drift_ratio=ratio)
        return y

    def _traced_rounds(self, x, order, key, preds, predicted,
                       pipeline=None):
        """The rounds of one traced call inside its ``plan.execute`` span
        (this plan's, or a :class:`TransposePlan`'s, whose drift ``key``
        the per-round observations then carry)."""
        tr = _TRACER
        det = telemetry.drift_detector()
        # An installed fault injector (core.faults) exposes a per-round
        # guard, so injected slow rounds land inside the round spans.
        check = getattr(self, "_round_fault_check", None)
        if self.backend == "factorized" and pipeline is None:
            names, sizes = _skip_trivial(self.axis_names, self.dims)

            @contextlib.contextmanager
            def round_span(i, k):
                pred_k = None if preds is None else preds.get(names[k])
                with tr.span("plan.round", cat="plan", axis=names[k],
                             round=k, dim=sizes[k],
                             predicted_seconds=pred_k):
                    # the round's time holds an injected delay, so a
                    # slow round reads as that axis's drift
                    tr0 = time.perf_counter()
                    if check is not None:
                        check()
                    yield
                    _sync(x)
                    if pred_k:
                        det.observe(f"{key}:axis={names[k]}", pred_k,
                                    time.perf_counter() - tr0)
            return self._execute(x, order, round_span)
        # direct = a single product-communicator round; overlap
        # interleaves rounds across chunks — neither splits into
        # host-steppable rounds, so one fused span covers them.
        with tr.span("plan.round", cat="plan", axis="*",
                     backend=self.backend, timing="fused",
                     predicted_seconds=predicted):
            if check is not None:
                check()
            y = pipeline() if pipeline is not None \
                else self._execute(x, order)
            _sync(y)
        return y

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved plan (the
        reference's keys and values)."""
        sched = self.schedule
        return {
            "kind": "dense",
            "axis_names": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": self.backend,
            "requested_backend": self.requested_backend,
            "variant": self.variant,
            "round_order": list(self.order),
            "reverse_round_order": list(self.rev_order),
            "n_chunks": self.n_chunks,
            "block_shape": None if self.block_shape is None
            else list(self.block_shape),
            "dtype": None if self.dtype is None else dtype_name(self.dtype),
            "block_bytes": self.block_bytes,
            "predicted_seconds": None if sched is None
            else sched.predicted_seconds,
            "blocks_sent_per_device": self.fact.blocks_sent_per_device(),
            "links": [{"alpha": l.alpha, "bandwidth": l.bandwidth}
                      for l in self.links],
            "tuned_from": self.tuned_from,
            "measured": self.measured,
            "drift_ratio": telemetry.drift_detector()
            .drift_ratio(self._drift_key()),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"A2APlan(dims={self.dims}, axes={self.axis_names}, "
                f"backend={self.backend!r}, n_chunks={self.n_chunks}, "
                f"variant={self.variant!r})")


# ---------------------------------------------------------------------------
# Construction + the plan registry
# ---------------------------------------------------------------------------


def _sub_plans(plan) -> tuple:
    """Nested plans a composite plan owns (ragged: data + counts; sparse:
    counts only, its data rounds are its own; transpose: its inner dense
    plan; kv_migrate: the inner ragged / sparse plan, whose own nested
    entries drop recursively when it does)."""
    if isinstance(plan, RaggedA2APlan):
        return (plan.data, plan.counts_plan)
    if isinstance(plan, SparseA2APlan):
        return (plan.counts_plan,)
    if isinstance(plan, (KVMigrationPlan, TransposePlan)):
        return (plan.inner,)
    return ()


def _plan_fact(plan):
    """The factorization descriptor behind any plan kind."""
    fact = getattr(plan, "fact", None)
    return plan.data.fact if fact is None else fact


def _release_fact(fact) -> None:
    """Drop the factorization registry entries for ``fact`` once no live
    plan uses it — the paper's delete callback (Listing 2's ``torusdel``),
    run from the plan layer so the two registries tear down together."""
    for q in _PLANS.values():
        if _plan_fact(q) == fact:
            return
    from . import cache as _cache
    _cache.free(fact)


def _on_plan_evict(plan) -> None:
    """Evicting (or dropping) a composite plan also drops its nested
    plans' registry entries, unless another live composite still owns one
    (two ragged plans over one torus share a counts plan); the last plan
    over a factorization releases the descriptor."""
    for subp in _sub_plans(plan):
        key = getattr(subp, "_registry_key", None)
        # only drop the entry if the registry still holds *this* object:
        # after LRU churn a fresh equal-key plan may occupy the slot
        if key is None or _PLANS._data.get(key) is not subp:
            continue
        if any(subp in _sub_plans(q) for q in _PLANS.values()):
            continue
        dropped = _PLANS.pop(key)
        if dropped is not None:
            _on_plan_evict(dropped)
    _release_fact(_plan_fact(plan))


_PLANS: LRUCache = LRUCache(capacity=256, on_evict=_on_plan_evict)


def _registry_fetch(key):
    cached = _PLANS.get(key)
    if cached is not None:
        cached._from_cache = True
    return cached


def _registry_store(key, plan):
    plan._registry_key = key
    _PLANS.put(key, plan)
    return plan


def _drop_plan(key) -> None:
    """Explicitly remove one plan entry, with the same teardown as LRU
    eviction (used by ``TorusComm.free``)."""
    plan = _PLANS.pop(key)
    if plan is not None:
        _on_plan_evict(plan)


def _resolve(dims, axis_names, block_shape, dtype, requested_backend,
             variant, round_order, reverse_round_order, n_chunks,
             max_chunks, links, compute_seconds):
    """All the once-per-plan decisions, in one place."""
    if requested_backend not in BACKENDS:
        raise ValueError(f"unknown a2a backend {requested_backend!r}; "
                         f"expected one of {BACKENDS}")
    if variant not in ("natural", "paper"):
        raise ValueError(f"unknown variant {variant!r}")
    links = resolve_links(links, dims, axis_names)

    # Round orders act on the *active* (size > 1) dimensions, matching the
    # kernels' skip-trivial semantics; validated here, at plan time.
    _, active = _skip_trivial(axis_names, dims)
    d_active = len(active)
    order = _check_order(round_order, d_active)
    rev_order = (tuple(reversed(order)) if reverse_round_order is None
                 else _check_order(reverse_round_order, d_active))

    p = math.prod(dims)
    block_bytes = None
    if block_shape is not None and dtype is not None:
        block_bytes = math.prod(block_shape) * itemsize(dtype)

    if requested_backend == "tuned":
        if block_bytes is None:
            raise ValueError('backend="tuned" needs block_shape and dtype '
                             "for the cost model")
        sched = choose_algorithm(dims, links, float(block_bytes),
                                 max_chunks=max_chunks,
                                 compute_seconds=compute_seconds)
        n = n_chunks or sched.n_chunks
        return sched.kind, order, rev_order, max(1, n), links, sched

    backend = requested_backend
    n = n_chunks or (2 if backend in ("overlap", "pipelined") else 1)
    n = max(1, n)
    sched = None
    if block_bytes is not None:
        if backend == "direct":
            slowest = slowest_active_link(dims, links)
            t = predict_direct(p, float(block_bytes), slowest) \
                + compute_seconds
        elif backend == "factorized":
            t = predict_factorized(dims, links, float(block_bytes), p) \
                + compute_seconds
        else:
            t = predict_overlapped(dims, links, float(block_bytes), p, n,
                                   compute_seconds)
        sched = Schedule(backend, dims, links, t, n_chunks=n)
    return backend, order, rev_order, n, links, sched


def plan_all_to_all(mesh_or_axis_dims, axis_names, block_shape=None,
                    dtype=None, *, backend: str = "tuned",
                    variant: str = "natural", round_order=None,
                    reverse_round_order=None, n_chunks: int = 0,
                    max_chunks: int = 8, links=None,
                    compute_seconds: float = 0.0, db=None) -> A2APlan:
    """Build (or fetch from the LRU registry) an :class:`A2APlan`, through
    the implicit communicator ``torus_comm(mesh_or_axis_dims,
    axis_names)``.

    Args:
      mesh_or_axis_dims: a ``DeviceMesh`` (the torus dims are looked up on
        it, the plan is keyed by its rank fingerprint and can run) or an
        explicit tuple of per-axis sizes, fastest digit first (resolution
        and ``describe()`` only: such a plan has no process groups).
      axis_names: torus dimensions, fastest digit first.
      block_shape, dtype: shape/dtype of one per-rank block — feeds the
        cost model.  Needed for ``backend="tuned"`` and ``"autotune"``.
      backend: "tuned" (cost-model choice), "autotune" (measured choice
        from the tuning DB — a hit rebuilds the recorded winner, a miss
        falls back to the cost model without measuring; see
        ``core.autotune``), or "direct" | "factorized" | "pipelined" |
        "overlap".
      variant: "natural" or "paper".
      round_order / reverse_round_order: permutations of the active rounds
        (default: identity, and its reversal for the drain direction).
      n_chunks: payload chunks for the overlap engine; 0 = resolve.
      max_chunks: search bound for the tuned chunk count.
      links: per-axis :class:`LinkModel` overrides (default: DCN for
        ``pod``-like axes, ICI otherwise; the measured per-axis fits
        under a tuning-DB hit).
      compute_seconds: per-call interleaved compute estimate for tuning.
      db: tuning-DB handle for ``backend="autotune"`` (default: the
        ``REPRO_TORCH_TUNING_DB`` / ``~/.cache/repro_torch/tuning.json``
        database).
    """
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).all_to_all(
        block_shape, dtype, backend=backend, round_order=round_order,
        reverse_round_order=reverse_round_order, n_chunks=n_chunks,
        max_chunks=max_chunks, links=links,
        compute_seconds=compute_seconds, db=db)


def _build_dense_plan(mesh_or_axis_dims, axis_names, block_shape=None,
                      dtype=None, *, backend: str = "tuned",
                      variant: str = "natural", round_order=None,
                      reverse_round_order=None, n_chunks: int = 0,
                      max_chunks: int = 8, links=None,
                      compute_seconds: float = 0.0, db=None) -> A2APlan:
    """The resolution machinery behind ``TorusComm.all_to_all``: all
    once-per-plan decisions plus the LRU registry."""
    axis_names = _as_tuple(axis_names)
    mesh = None
    if isinstance(mesh_or_axis_dims, DeviceMesh):
        mesh = mesh_or_axis_dims
        fact = get_factorization(mesh, axis_names, variant=variant)
        dims = fact.dims
        dev_key = device_fingerprint(mesh)
    else:
        dims = tuple(int(s) for s in mesh_or_axis_dims)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for {len(axis_names)} axes")
        fact = TorusFactorization(axis_names, dims, variant)
        dev_key = None

    # None stays None in the key (under "autotune" it means measured
    # links may substitute); anything else is normalized so a uniform
    # LinkModel and its broadcast tuple key identically.
    links_key = None if links is None else resolve_links(links, dims)
    key = (dev_key, dims, axis_names, None if block_shape is None
           else tuple(block_shape),
           None if dtype is None else dtype_name(dtype),
           backend, variant,
           None if round_order is None else tuple(round_order),
           None if reverse_round_order is None
           else tuple(reverse_round_order),
           int(n_chunks), int(max_chunks), links_key,
           float(compute_seconds))
    if backend == "autotune":
        # Cached autotune plans must be re-resolved when the DB changes
        # (a new measurement landed, or the file was deleted): key on the
        # DB identity + its per-path write generation.
        from .autotune import get_default_db
        db = db if db is not None else get_default_db()
        key = key + (db.path_key, db.generation())
    cached = _registry_fetch(key)
    if cached is not None:
        return cached

    def build(req_backend, order_, chunks_, links_):
        return _resolve(dims, axis_names, block_shape, dtype, req_backend,
                        variant, order_, reverse_round_order, chunks_,
                        max_chunks, links_, compute_seconds)

    tuned_from, measured = None, None
    if backend == "tuned":
        tuned_from = "model"
        parts = build("tuned", round_order, n_chunks, links)
    elif backend == "autotune":
        if block_shape is None or dtype is None:
            raise ValueError('backend="autotune" needs block_shape and '
                             "dtype (the tuning-DB key)")
        from .autotune import (db_fingerprint, lookup_measured,
                               measured_links)
        rec = lookup_measured(None if mesh is None else db_fingerprint(mesh),
                              dims, axis_names, tuple(block_shape), dtype,
                              variant, db=db)
        parts = None
        if rec is not None:
            w = rec["winner"]
            rec_order = round_order if round_order is not None else \
                (tuple(w["round_order"]) if w.get("round_order") is not None
                 else None)
            rec_chunks = n_chunks or int(w.get("n_chunks", 0))
            rec_links = links
            if rec_links is None:
                rec_links = measured_links(rec)
            try:
                parts = build(w["backend"], rec_order, rec_chunks,
                              rec_links)
                tuned_from = "measured"
                measured = {"median_us": w.get("median_us"),
                            "table": rec.get("table", []),
                            "best_factorization":
                                rec.get("best_factorization"),
                            "db_path": str(db.path)}
            except ValueError as e:
                from .autotune import demote_hit_to_miss
                demote_hit_to_miss()   # telemetry: this plan is model-built
                warnings.warn(f"tuning-DB record unusable for this plan "
                              f"({e}); falling back to the cost model")
        if parts is None:   # DB miss (or unusable record): analytic choice,
            tuned_from = "model"   # never a blocking measurement
            parts = build("tuned", round_order, n_chunks, links)
    else:
        parts = build(backend, round_order, n_chunks, links)

    resolved, order, rev_order, n, link_models, sched = parts
    plan = A2APlan(fact, requested_backend=backend, backend=resolved,
                   variant=variant, order=order, rev_order=rev_order,
                   n_chunks=n, block_shape=None if block_shape is None
                   else tuple(block_shape), dtype=dtype, links=link_models,
                   schedule=sched, tuned_from=tuned_from, measured=measured)
    return _registry_store(key, plan)


# ---------------------------------------------------------------------------
# Pencil-transpose plans (distributed-FFT re-shard)
# ---------------------------------------------------------------------------


class TransposePlan:
    """A resolved, reusable pencil <-> pencil transpose plan.

    Construct via ``TorusComm.transpose`` (or :func:`plan_transpose`);
    never directly.  The global transpose of a pencil-decomposed FFT
    (``workloads.fft``) is an all-to-all of uniform contiguous chunks:
    this rank's pencil ``in_shape`` is split into ``p`` chunks along
    ``split_axis`` (chunk ``t`` -> torus rank ``t``) and the received
    chunks are concatenated source-major along ``concat_axis``, the
    tiled collective.  The plan wraps an inner dense :class:`A2APlan`
    over the same torus whose per-peer block is one chunk, so the
    transpose resolves through any dense backend and shares the
    registry, the cost model, the tuning DB and the tracer; a stage and
    its inverse (split and concat swapped) share that inner plan.

    Each rank calls :meth:`apply` / :meth:`inverse_apply` on its own
    pencil (the reference's jitted ``host_fn`` over the global array has
    no SPMD counterpart here); :meth:`specs` describes the global
    sharding on each side.  Correctness oracle:
    ``core.simulator.simulate_pencil_transpose``.
    """

    kind = "transpose"

    def __init__(self, inner: A2APlan, *, in_shape: tuple[int, ...],
                 split_axis: int, concat_axis: int, parent=None):
        self.inner = inner
        self.in_shape = tuple(in_shape)
        self.split_axis = int(split_axis)
        self.concat_axis = int(concat_axis)
        out = list(self.in_shape)
        out[self.split_axis] //= inner.p
        out[self.concat_axis] *= inner.p
        self.out_shape = tuple(out)
        self.parent = parent
        self._from_cache = False

    # -- identity ----------------------------------------------------------

    @property
    def fact(self) -> TorusFactorization:
        return self.inner.fact

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.inner.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.inner.dims

    @property
    def p(self) -> int:
        return self.inner.p

    @property
    def d(self) -> int:
        return self.inner.d

    @property
    def variant(self) -> str:
        return self.inner.variant

    @property
    def backend(self) -> str:
        return self.inner.backend

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def block_shape(self) -> tuple[int, ...]:
        """One per-peer chunk: ``in_shape`` with ``split_axis`` divided by
        ``p``, the inner dense plan's block."""
        return self.inner.block_shape

    @property
    def block_bytes(self) -> int | None:
        return self.inner.block_bytes

    @property
    def pencil_bytes(self) -> int | None:
        bb = self.inner.block_bytes
        return None if bb is None else bb * self.p

    # -- execution surface (collective: every rank of the torus) ----------

    def apply(self, x):
        """The forward re-shard: ``x`` is this rank's ``in_shape`` pencil;
        returns its ``out_shape`` pencil (``split_axis`` sharded,
        ``concat_axis`` gathered)."""
        if tuple(x.shape) != self.in_shape:
            raise ValueError(f"pencil shape {tuple(x.shape)} != plan "
                             f"in_shape {self.in_shape}")
        return self._run(x, self.split_axis, self.concat_axis, False)

    def inverse_apply(self, y):
        """The exact inverse re-shard (split and concat swapped, rounds in
        the drain order): bit-identical round trip with :meth:`apply` for
        any backend."""
        if tuple(y.shape) != self.out_shape:
            raise ValueError(f"pencil shape {tuple(y.shape)} != plan "
                             f"out_shape {self.out_shape}")
        return self._run(y, self.concat_axis, self.split_axis, True)

    def _run(self, x, split_axis, concat_axis, reverse):
        if _TRACER.enabled:
            return self._traced_execute(x, split_axis, concat_axis, reverse)
        return self.inner.tiled(x, split_axis, concat_axis, reverse=reverse)

    def specs(self) -> tuple[tuple, tuple]:
        """The global sharding on each side, per array axis the tuple of
        torus axis names that shards it (major to minor) or None: the
        distributed pencil axis (``concat_axis`` in, ``split_axis`` out)
        over the plan's torus axes.  Complete only when the plan spans
        every torus axis; a sub-group transpose's pencil is also sharded
        on the other groups' axes."""
        axes = tuple(reversed(self.axis_names))
        in_spec = [None] * len(self.in_shape)
        in_spec[self.concat_axis] = axes
        out_spec = [None] * len(self.in_shape)
        out_spec[self.split_axis] = axes
        return tuple(in_spec), tuple(out_spec)

    # -- telemetry-traced execution ----------------------------------------

    def _drift_key(self) -> str:
        dims = "x".join(str(s) for s in self.dims)
        shape = "x".join(str(s) for s in self.in_shape)
        return (f"transpose[{','.join(self.axis_names)}]{dims}"
                f":{self.backend}:{shape}:{self.split_axis}"
                f"->{self.concat_axis}")

    def _traced_execute(self, x, split_axis, concat_axis, reverse):
        """One call under its own ``plan.execute`` span (``kind=
        "transpose"``): the inner plan's rounds as its ``plan.round``
        children (one per active round when factorized, else one fused),
        without the inner plan's own ``plan.execute``.  Under autograd the
        backward is the transpose the other way, traced alike: the inner
        rounds in the adjoint order under a transpose span of its own.
        Feeds the drift detector per round and per call under the
        transpose's key."""
        inner = self.inner
        key = self._drift_key()
        preds = inner._per_axis_predictions()
        predicted = inner.schedule.predicted_seconds \
            if inner.schedule is not None \
            else (sum(preds.values()) if preds else None)
        order, adjoint = (inner.rev_order, inner.order) if reverse \
            else (inner.order, inner.rev_order)

        def traced(fn):
            telemetry.metrics().counter("plan.traced_executions").inc()
            with _TRACER.span("plan.execute", cat="plan", kind="transpose",
                              backend=self.backend,
                              axes=",".join(self.axis_names),
                              dims="x".join(str(n) for n in self.dims),
                              pencil="x".join(str(n) for n in self.in_shape),
                              predicted_seconds=predicted,
                              tuned_from=inner.tuned_from,
                              drift_key=key) as ex:
                t0 = time.perf_counter()
                y = fn()
                _sync(y)
                measured = time.perf_counter() - t0
                ratio = telemetry.drift_detector().observe(
                    key, predicted, measured) if predicted else None
                ex.set(measured_seconds=measured, drift_ratio=ratio)
            return y

        def rounds(xb, o):
            return inner._traced_rounds(xb, o, key, preds, predicted)

        def backward(g):
            if not _TRACER.enabled:
                return inner._execute(g, adjoint)
            return traced(lambda: rounds(g, adjoint))

        def blockwise(xb):
            if _trains(xb):
                return _BlockwiseFn.apply(xb, lambda t: rounds(t, order),
                                          backward)
            return rounds(xb, order)

        return traced(lambda: _tiled(x, inner.fact, split_axis, concat_axis,
                                     blockwise))

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved plan (the
        reference's keys and values)."""
        inner = self.inner.describe()
        return {
            "kind": "transpose",
            "axis_names": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": self.backend,
            "requested_backend": self.inner.requested_backend,
            "variant": self.variant,
            "in_shape": list(self.in_shape),
            "out_shape": list(self.out_shape),
            "split_axis": self.split_axis,
            "concat_axis": self.concat_axis,
            "block_shape": None if self.block_shape is None
            else list(self.block_shape),
            "dtype": inner["dtype"],
            "pencil_bytes": self.pencil_bytes,
            "block_bytes": self.block_bytes,
            "predicted_seconds": inner["predicted_seconds"],
            "tuned_from": self.inner.tuned_from,
            "parent": None if self.parent is None else list(self.parent),
            "drift_ratio": telemetry.drift_detector()
            .drift_ratio(self._drift_key()),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"TransposePlan(dims={self.dims}, axes={self.axis_names}, "
                f"in_shape={self.in_shape}, split={self.split_axis}, "
                f"concat={self.concat_axis}, backend={self.backend!r})")


def plan_transpose(mesh_or_axis_dims, axis_names, local_shape, dtype, *,
                   split_axis: int, concat_axis: int,
                   backend: str = "tuned", variant: str = "natural",
                   round_order=None, reverse_round_order=None,
                   n_chunks: int = 0, max_chunks: int = 8, links=None,
                   db=None) -> TransposePlan:
    """Build (or fetch) a :class:`TransposePlan` through the implicit
    communicator ``torus_comm(mesh_or_axis_dims, axis_names)``; the knobs
    are :func:`plan_all_to_all`'s."""
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).transpose(
        local_shape, dtype, split_axis=split_axis, concat_axis=concat_axis,
        backend=backend, round_order=round_order,
        reverse_round_order=reverse_round_order, n_chunks=n_chunks,
        max_chunks=max_chunks, links=links, db=db)


def _build_transpose_plan(mesh_or_axis_dims, axis_names, local_shape, dtype,
                          *, split_axis: int, concat_axis: int,
                          backend: str = "tuned", variant: str = "natural",
                          round_order=None, reverse_round_order=None,
                          n_chunks: int = 0, max_chunks: int = 8,
                          links=None, db=None,
                          parent=None) -> TransposePlan:
    """The resolution behind ``TorusComm.transpose``: check the re-shard
    geometry, resolve the inner dense plan over the per-peer chunk (any
    backend, the tuning DB included), and key the composite on the
    inner's registry key, so that a tuning-DB generation change
    re-resolves it too."""
    local_shape = tuple(int(n) for n in local_shape)
    nd = len(local_shape)
    if not 0 <= split_axis < nd or not 0 <= concat_axis < nd:
        raise ValueError(f"split/concat axes ({split_axis}, {concat_axis}) "
                         f"outside pencil rank {nd}")
    if split_axis == concat_axis:
        raise ValueError("split_axis and concat_axis must differ")
    axis_names = _as_tuple(axis_names)
    if isinstance(mesh_or_axis_dims, DeviceMesh):
        dims = get_factorization(mesh_or_axis_dims, axis_names,
                                 variant=variant).dims
    else:
        dims = tuple(int(s) for s in mesh_or_axis_dims)
    p = math.prod(dims)
    if local_shape[split_axis] % p:
        raise ValueError(f"split axis size {local_shape[split_axis]} not "
                         f"divisible by p={p} (dims {dims})")
    block_shape = list(local_shape)
    block_shape[split_axis] //= p
    inner = _build_dense_plan(
        mesh_or_axis_dims, axis_names, tuple(block_shape), dtype,
        backend=backend, variant=variant, round_order=round_order,
        reverse_round_order=reverse_round_order, n_chunks=n_chunks,
        max_chunks=max_chunks, links=links, db=db)
    key = ("transpose", inner._registry_key, local_shape, int(split_axis),
           int(concat_axis), parent)
    cached = _registry_fetch(key)
    if cached is not None:
        return cached
    plan = TransposePlan(inner, in_shape=local_shape,
                         split_axis=split_axis, concat_axis=concat_axis,
                         parent=parent)
    return _registry_store(key, plan)


# ---------------------------------------------------------------------------
# Ragged (Alltoallv) plans
# ---------------------------------------------------------------------------


class RaggedA2APlan:
    """A resolved, reusable ragged all-to-all (Alltoallv) plan.

    Construct via :func:`plan_ragged_all_to_all` (or
    ``TorusComm.ragged_all_to_all``); never directly.  It composes two
    dense :class:`A2APlan` resolutions over the same torus — the tiny
    int32 *counts* plan and the bucket-padded *data* plan — plus the
    bucket, the power-of-two row bound that keeps every round
    fixed-shape (``core.ragged``).  Cached in the same LRU registry.
    """

    def __init__(self, data: A2APlan, counts: A2APlan, *, max_count: int,
                 avg_count: float, row_shape: tuple[int, ...], dtype,
                 predicted_seconds: float | None):
        self.data = data
        self.counts_plan = counts
        self.max_count = max_count
        self.avg_count = avg_count
        self.row_shape = row_shape
        self.dtype = dtype
        self.predicted_seconds = predicted_seconds
        self._from_cache = False

    # -- identity ----------------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.data.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.data.dims

    @property
    def p(self) -> int:
        return self.data.p

    @property
    def d(self) -> int:
        return self.data.d

    @property
    def bucket(self) -> int:
        return self.data.block_shape[0]

    @property
    def backend(self) -> str:
        return self.data.backend

    @property
    def variant(self) -> str:
        return self.data.variant

    @property
    def n_chunks(self) -> int:
        return self.data.n_chunks

    @property
    def tuned_from(self) -> str | None:
        return self.data.tuned_from

    @property
    def row_bytes(self) -> int:
        return math.prod(self.row_shape) * itemsize(self.dtype)

    @property
    def expected_occupancy(self) -> float:
        return float(self.avg_count) / float(self.bucket)

    # -- execution surface (collective: every rank of the torus) ----------

    def counts_matrix(self, send_counts):
        """The counts phase alone: ``(p,)`` int32 send counts -> the full
        ``(p, p)`` matrix, identical on every rank."""
        from .ragged import _counts_matrix_impl
        return _counts_matrix_impl(send_counts, self.counts_plan)

    def forward(self, x, send_counts):
        """Bucketed ragged all-to-all: ``x`` is ``(p, m, *row)`` with
        ``m <= bucket``, block ``i``'s rows destined for torus rank ``i``;
        returns ``(recv, recv_counts)`` — ``recv[i]`` the ``(bucket,
        *row)`` window received from rank ``i``."""
        if _TRACER.enabled:
            return self._traced_execute(x, send_counts, reverse=False)
        from .ragged import _bucketed_impl
        return _bucketed_impl(x, send_counts, data_plan=self.data,
                              counts_plan=self.counts_plan)

    def reverse(self, x, send_counts):
        """The combine-direction bucketed exchange (drain round order);
        ``send_counts`` is typically the ``recv_counts`` of the matching
        ``forward``."""
        if _TRACER.enabled:
            return self._traced_execute(x, send_counts, reverse=True)
        from .ragged import _bucketed_impl
        return _bucketed_impl(x, send_counts, data_plan=self.data,
                              counts_plan=self.counts_plan, reverse=True)

    # -- telemetry-traced execution ----------------------------------------

    def _drift_key(self) -> str:
        dims = "x".join(str(s) for s in self.dims)
        return (f"ragged[{','.join(self.axis_names)}]{dims}"
                f":{self.backend}:b{self.bucket}")

    def _traced_execute(self, x, send_counts, *, reverse: bool):
        """One call under a ``plan.execute`` span: the counts phase in a
        ``ragged.counts`` span, then the data plan's traced call (its own
        ``plan.execute`` with its round spans)."""
        from .ragged import _pad_to_bucket, _recv_counts_phase
        det = telemetry.drift_detector()
        key = self._drift_key()
        with _TRACER.span("plan.execute", cat="plan", kind="ragged",
                          backend=self.backend,
                          axes=",".join(self.axis_names),
                          dims="x".join(str(s) for s in self.dims),
                          bucket=self.bucket,
                          predicted_seconds=self.predicted_seconds,
                          tuned_from=self.tuned_from, drift_key=key) as ex:
            t0 = time.perf_counter()
            counts_sched = self.counts_plan.schedule
            with _TRACER.span("ragged.counts", cat="plan",
                              backend=self.counts_plan.backend,
                              block_bytes=self.counts_plan.block_bytes,
                              predicted_seconds=None if counts_sched is None
                              else counts_sched.predicted_seconds):
                rc = _recv_counts_phase(x, send_counts, self.data.p,
                                        self.counts_plan)
                _sync(rc)
            padded = _pad_to_bucket(x, self.bucket)
            recv = self.data.reverse(padded) if reverse \
                else self.data.forward(padded)
            measured = time.perf_counter() - t0
            ratio = det.observe(key, self.predicted_seconds, measured) \
                if self.predicted_seconds else None
            ex.set(measured_seconds=measured, drift_ratio=ratio)
        return recv, rc

    def occupancy(self, send_counts):
        """Measured occupancy of one call (a tensor): useful rows over
        ``p * bucket`` padded rows."""
        from .ragged import bucket_occupancy
        return bucket_occupancy(send_counts, self.bucket)

    def exact(self, rows):
        """The exact two-phase host path (``core.ragged
        .exact_alltoallv``): global nested ``rows[s][d]`` arrays in, exact
        per-pair arrays out — no bucket, no padding.  Runs the plan's
        forward round order over the active dimensions."""
        from .ragged import exact_alltoallv
        active = [i for i, Dk in enumerate(self.dims) if Dk > 1]
        trivial = [i for i, Dk in enumerate(self.dims) if Dk == 1]
        full_order = [active[k] for k in self.data.order] + trivial
        return exact_alltoallv(rows, self.dims, round_order=full_order)

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved ragged plan
        (the reference's keys and values); ``expected_occupancy`` is the
        plan-time ``avg_count / bucket``."""
        return {
            "kind": "ragged",
            "axis_names": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": self.backend,
            "requested_backend": self.data.requested_backend,
            "variant": self.variant,
            "round_order": list(self.data.order),
            "reverse_round_order": list(self.data.rev_order),
            "n_chunks": self.n_chunks,
            "row_shape": list(self.row_shape),
            "dtype": dtype_name(self.dtype),
            "row_bytes": self.row_bytes,
            "max_count": self.max_count,
            "avg_count": self.avg_count,
            "bucket": self.bucket,
            "bucket_block_bytes": self.data.block_bytes,
            "expected_occupancy": self.expected_occupancy,
            "counts_backend": self.counts_plan.backend,
            "counts_block_bytes": self.counts_plan.block_bytes,
            "predicted_seconds": self.predicted_seconds,
            "blocks_sent_per_device": self.data.fact
            .blocks_sent_per_device(),
            "links": [{"alpha": l.alpha, "bandwidth": l.bandwidth}
                      for l in self.data.links],
            "tuned_from": self.tuned_from,
            "measured": self.data.measured,
            "drift_ratio": telemetry.drift_detector()
            .drift_ratio(self._drift_key()),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"RaggedA2APlan(dims={self.dims}, axes={self.axis_names}, "
                f"backend={self.backend!r}, bucket={self.bucket}, "
                f"max_count={self.max_count})")


def _bucket_and_avg(max_count, avg_count) -> tuple[int, int, float]:
    from .ragged import next_pow2
    max_count = int(max_count)
    # Power-of-two bucket: any static bound keeps the rounds fixed-shape;
    # snapping to pow2 bounds the set of distinct shapes (and plan-cache
    # entries) across workloads whose max_count drifts.
    bucket = next_pow2(max_count)
    avg = float(max_count if avg_count is None else avg_count)
    if not 0.0 < avg <= bucket:
        raise ValueError(f"avg_count {avg} outside (0, bucket={bucket}]")
    return max_count, bucket, avg


def plan_ragged_all_to_all(mesh_or_axis_dims, axis_names, row_shape=(),
                           dtype="float32", *, max_count: int,
                           avg_count: float | None = None,
                           backend: str = "tuned", variant: str = "natural",
                           round_order=None, reverse_round_order=None,
                           n_chunks: int = 0, max_chunks: int = 8,
                           links=None, compute_seconds: float = 0.0,
                           db=None) -> RaggedA2APlan:
    """Build (or fetch from the LRU registry) a :class:`RaggedA2APlan`,
    through the implicit communicator.  The knobs are
    :func:`plan_all_to_all`'s, plus:

      row_shape, dtype: shape / dtype of ONE ragged row (the unit the
        per-pair counts count); ``()`` means scalar rows.
      max_count: static upper bound on any ``send_counts`` entry.  The
        bucket is its power-of-two round-up, so every round has a fixed
        shape and no call reads the counts on the host.
      avg_count: expected mean per-pair count, for
        ``expected_occupancy`` and the ragged cost term (default
        ``max_count``).
      backend: resolves the *data* plan (padded ``(bucket, *row_shape)``
        blocks) exactly like the dense API ("autotune" replays the winner
        measured for the padded block shape); the counts plan is always
        resolved as "tuned" over its ``(p,)`` int32 block.
    """
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).ragged_all_to_all(
        row_shape, dtype, max_count=max_count, avg_count=avg_count,
        backend=backend, round_order=round_order,
        reverse_round_order=reverse_round_order, n_chunks=n_chunks,
        max_chunks=max_chunks, links=links,
        compute_seconds=compute_seconds, db=db)


def _build_ragged_plan(mesh_or_axis_dims, axis_names, row_shape=(),
                       dtype="float32", *, max_count: int,
                       avg_count: float | None = None,
                       backend: str = "tuned", variant: str = "natural",
                       round_order=None, reverse_round_order=None,
                       n_chunks: int = 0, max_chunks: int = 8,
                       links=None, compute_seconds: float = 0.0,
                       db=None) -> RaggedA2APlan:
    """The resolution behind ``TorusComm.ragged_all_to_all``: the bucket,
    the nested dense data / counts plans, and the shared registry."""
    axis_names = _as_tuple(axis_names)
    if isinstance(mesh_or_axis_dims, DeviceMesh):
        shape = mesh_shape(mesh_or_axis_dims)
        dims = tuple(shape[n] for n in axis_names)
        dev_key = device_fingerprint(mesh_or_axis_dims)
    else:
        dims = tuple(int(s) for s in mesh_or_axis_dims)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for {len(axis_names)} axes")
        dev_key = None
    max_count, bucket, avg = _bucket_and_avg(max_count, avg_count)
    row_shape = tuple(int(s) for s in row_shape)
    p = math.prod(dims)

    links_key = None if links is None else resolve_links(links, dims)
    key = ("ragged", dev_key, dims, axis_names, row_shape,
           dtype_name(dtype), max_count, avg, backend, variant,
           None if round_order is None else tuple(round_order),
           None if reverse_round_order is None
           else tuple(reverse_round_order),
           int(n_chunks), int(max_chunks), links_key,
           float(compute_seconds))
    if backend == "autotune":
        from .autotune import get_default_db
        db = db if db is not None else get_default_db()
        key = key + (db.path_key, db.generation())
    cached = _registry_fetch(key)
    if cached is not None:
        return cached

    data = _build_dense_plan(mesh_or_axis_dims, axis_names,
                             (bucket,) + row_shape, dtype, backend=backend,
                             variant=variant, round_order=round_order,
                             reverse_round_order=reverse_round_order,
                             n_chunks=n_chunks, max_chunks=max_chunks,
                             links=links, compute_seconds=compute_seconds,
                             db=db)
    counts = _build_dense_plan(mesh_or_axis_dims, axis_names, (p,),
                               torch.int32, backend="tuned", variant=variant,
                               round_order=round_order,
                               reverse_round_order=reverse_round_order,
                               max_chunks=1, links=links)
    predicted = None
    if data.schedule is not None and counts.schedule is not None:
        predicted = data.schedule.predicted_seconds \
            + counts.schedule.predicted_seconds
    plan = RaggedA2APlan(data, counts, max_count=max_count, avg_count=avg,
                         row_shape=row_shape, dtype=dtype,
                         predicted_seconds=predicted)
    return _registry_store(key, plan)


# ---------------------------------------------------------------------------
# Sparse neighborhood (message-combining) Alltoallv plans
# ---------------------------------------------------------------------------


class SparseA2APlan:
    """A resolved, reusable sparse-neighborhood Alltoallv plan.

    Construct via :func:`plan_sparse_all_to_all` (or
    ``TorusComm.sparse_all_to_all``); never directly.  It keeps the
    ragged counts phase and bucket contract but splits each round into
    its ``D[k] - 1`` per-peer lanes; a lane whose combined payload is
    empty — read from the replicated counts matrix against the plan-time
    ``round_message_masks`` — is skipped by every rank alike
    (``core.sparse``).  ``forward`` / ``reverse`` take and return what
    :class:`RaggedA2APlan`'s do, so the dropless MoE path runs either;
    rows beyond ``recv_counts[i]`` are unspecified.
    """

    def __init__(self, fact: TorusFactorization, counts: A2APlan, *,
                 max_count: int, avg_count: float, expected_density: float,
                 row_shape: tuple[int, ...], dtype, order: tuple[int, ...],
                 rev_order: tuple[int, ...], masks_fwd, masks_rev,
                 links: tuple[LinkModel, ...],
                 predicted_seconds: float | None):
        self.fact = fact
        self.counts_plan = counts
        self.max_count = max_count
        self.avg_count = avg_count
        self.expected_density = expected_density
        self.row_shape = row_shape
        self.dtype = dtype
        self.order = order
        self.rev_order = rev_order
        self._masks_fwd = masks_fwd
        self._masks_rev = masks_rev
        self.links = links
        self.predicted_seconds = predicted_seconds
        # Traffic stats of the last host-side analyze() / exact() call;
        # None until the first analysis.
        self.last_stats: dict | None = None
        self._lane_masks: dict = {}     # (reverse, device) -> masks
        self._from_cache = False

    # -- identity ----------------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.fact.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.fact.dims

    @property
    def p(self) -> int:
        return self.fact.p

    @property
    def d(self) -> int:
        return self.fact.d

    @property
    def variant(self) -> str:
        return self.fact.variant

    @property
    def backend(self) -> str:
        return "sparse"

    @property
    def bucket(self) -> int:
        from .ragged import next_pow2
        return next_pow2(self.max_count)

    @property
    def round_order(self) -> tuple[int, ...]:
        return self.order

    @property
    def reverse_round_order(self) -> tuple[int, ...]:
        return self.rev_order

    @property
    def row_bytes(self) -> int:
        return math.prod(self.row_shape) * itemsize(self.dtype)

    @property
    def expected_occupancy(self) -> float:
        return float(self.avg_count) / float(self.bucket)

    # -- execution surface (collective: every rank of the torus) ----------

    def counts_matrix(self, send_counts):
        """The counts phase alone: ``(p,)`` int32 send counts -> the full
        ``(p, p)`` matrix, identical on every rank."""
        from .ragged import _counts_matrix_impl
        return _counts_matrix_impl(send_counts, self.counts_plan)

    def forward(self, x, send_counts):
        """Bucketed sparse all-to-all: :meth:`RaggedA2APlan.forward`'s
        signature and result, with empty per-peer lanes skipped."""
        from .sparse import _sparse_bucketed_impl
        if _TRACER.enabled:
            return self._traced_execute(
                lambda: _sparse_bucketed_impl(x, send_counts, plan=self))
        return _sparse_bucketed_impl(x, send_counts, plan=self)

    def reverse(self, x, send_counts):
        """The combine-direction sparse exchange (drain round order)."""
        from .sparse import _sparse_bucketed_impl
        if _TRACER.enabled:
            return self._traced_execute(
                lambda: _sparse_bucketed_impl(x, send_counts, plan=self,
                                              reverse=True))
        return _sparse_bucketed_impl(x, send_counts, plan=self,
                                     reverse=True)

    # -- telemetry-traced execution ----------------------------------------

    def _drift_key(self) -> str:
        dims = "x".join(str(s) for s in self.dims)
        return (f"sparse[{','.join(self.axis_names)}]{dims}"
                f":b{self.bucket}:rho{self.expected_density}")

    def _traced_execute(self, run):
        """One measured ``plan.execute`` span around the whole call: the
        lanes a call skips are decided inside it, from the counts it
        exchanges, so the rounds are not stepped one by one."""
        det = telemetry.drift_detector()
        key = self._drift_key()
        with _TRACER.span("plan.execute", cat="plan", kind="sparse",
                          backend="sparse", axes=",".join(self.axis_names),
                          dims="x".join(str(s) for s in self.dims),
                          bucket=self.bucket,
                          expected_density=self.expected_density,
                          predicted_seconds=self.predicted_seconds,
                          drift_key=key, timing="fused") as ex:
            t0 = time.perf_counter()
            out = run()
            _sync(out[0])
            measured = time.perf_counter() - t0
            ratio = det.observe(key, self.predicted_seconds, measured) \
                if self.predicted_seconds else None
            ex.set(measured_seconds=measured, drift_ratio=ratio)
        return out

    def occupancy(self, send_counts):
        """Measured occupancy of one call (a tensor): useful rows over
        ``p * bucket`` padded rows."""
        from .ragged import bucket_occupancy
        return bucket_occupancy(send_counts, self.bucket)

    def lane_masks(self, reverse: bool, device):
        """The round message masks of one direction as one boolean
        ``(lanes, p, p)`` tensor on ``device``, made once."""
        key = (reverse, device)
        if key not in self._lane_masks:
            masks = self._masks_rev if reverse else self._masks_fwd
            flat = [m for per_round in masks for m in per_round]
            self._lane_masks[key] = torch.from_numpy(
                np.stack(flat) if flat else np.zeros((0, self.p, self.p),
                                                     bool)).to(device)
        return self._lane_masks[key]

    # -- host-level paths --------------------------------------------------

    def _full_order(self, order) -> list[int]:
        active = [i for i, Dk in enumerate(self.dims) if Dk > 1]
        trivial = [i for i, Dk in enumerate(self.dims) if Dk == 1]
        return [active[k] for k in order] + trivial

    def analyze(self, counts) -> dict:
        """Host-side traffic analysis of a concrete ``(p, p)`` count
        matrix through the simulator's sparse oracle: density, skipped and
        combined messages, whole skipped rounds.  Cached on the plan
        (``describe()`` reports it)."""
        from .sparse import sparse_traffic_stats
        self.last_stats = sparse_traffic_stats(
            self.dims, counts, round_order=self._full_order(self.order))
        return self.last_stats

    def exact(self, rows):
        """The exact sparse host path (``core.sparse
        .sparse_exact_alltoallv``): global nested ``rows[s][d]`` arrays
        in, exact per-pair arrays out plus the per-round skip accounting
        (also cached in :attr:`last_stats`)."""
        from .sparse import sparse_exact_alltoallv
        recv, counts, vol = sparse_exact_alltoallv(
            rows, self.dims, round_order=self._full_order(self.order))
        self.analyze(counts)
        return recv, counts, vol

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved sparse plan
        (the reference's keys and values); ``density`` and the skip
        counts come from the last :meth:`analyze` / :meth:`exact`."""
        stats = self.last_stats or {}
        return {
            "kind": "sparse",
            "axis_names": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": "sparse",
            "requested_backend": "sparse",
            "variant": self.variant,
            "round_order": list(self.order),
            "reverse_round_order": list(self.rev_order),
            "n_chunks": 1,
            "row_shape": list(self.row_shape),
            "dtype": dtype_name(self.dtype),
            "row_bytes": self.row_bytes,
            "max_count": self.max_count,
            "avg_count": self.avg_count,
            "bucket": self.bucket,
            "expected_occupancy": self.expected_occupancy,
            "expected_density": self.expected_density,
            "density": stats.get("density"),
            "skipped_rounds": stats.get("skipped_rounds"),
            "combined_messages": stats.get("combined_messages"),
            "skipped_exchanges": stats.get("skipped_exchanges"),
            "total_exchanges": stats.get("total_exchanges"),
            "counts_backend": self.counts_plan.backend,
            "counts_block_bytes": self.counts_plan.block_bytes,
            "predicted_seconds": self.predicted_seconds,
            "blocks_sent_per_device": self.fact.blocks_sent_per_device(),
            "links": [{"alpha": l.alpha, "bandwidth": l.bandwidth}
                      for l in self.links],
            "tuned_from": None,
            "measured": None,
            "drift_ratio": telemetry.drift_detector()
            .drift_ratio(self._drift_key()),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"SparseA2APlan(dims={self.dims}, axes={self.axis_names}, "
                f"bucket={self.bucket}, max_count={self.max_count}, "
                f"expected_density={self.expected_density})")


def plan_sparse_all_to_all(mesh_or_axis_dims, axis_names, row_shape=(),
                           dtype="float32", *, max_count: int,
                           avg_count: float | None = None,
                           density: float | None = None,
                           variant: str = "natural", round_order=None,
                           reverse_round_order=None,
                           links=None) -> SparseA2APlan:
    """Build (or fetch from the LRU registry) a :class:`SparseA2APlan`,
    through the implicit communicator.  The knobs are
    :func:`plan_ragged_all_to_all`'s without the backend ones, plus
    ``density``: the expected non-zero fraction of the ``p x p`` count
    matrix (default 1.0), which ``tuning.predict_sparse`` prices; it must
    be in (0, 1]."""
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).sparse_all_to_all(
        row_shape, dtype, max_count=max_count, avg_count=avg_count,
        density=density, round_order=round_order,
        reverse_round_order=reverse_round_order, links=links)


def _build_sparse_plan(mesh_or_axis_dims, axis_names, row_shape=(),
                       dtype="float32", *, max_count: int,
                       avg_count: float | None = None,
                       density: float | None = None,
                       variant: str = "natural", round_order=None,
                       reverse_round_order=None,
                       links=None) -> SparseA2APlan:
    """The resolution behind ``TorusComm.sparse_all_to_all``: bucket,
    counts plan, plan-time message masks, and the shared registry."""
    axis_names = _as_tuple(axis_names)
    if isinstance(mesh_or_axis_dims, DeviceMesh):
        fact = get_factorization(mesh_or_axis_dims, axis_names,
                                 variant=variant)
        dims = fact.dims
        dev_key = device_fingerprint(mesh_or_axis_dims)
    else:
        dims = tuple(int(s) for s in mesh_or_axis_dims)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for {len(axis_names)} axes")
        fact = TorusFactorization(axis_names, dims, variant)
        dev_key = None
    if variant not in ("natural", "paper"):
        raise ValueError(f"unknown variant {variant!r}")
    max_count, bucket, avg = _bucket_and_avg(max_count, avg_count)
    rho = float(1.0 if density is None else density)
    if not 0.0 < rho <= 1.0:
        raise ValueError(f"density {rho} outside (0, 1]")
    row_shape = tuple(int(s) for s in row_shape)
    p = math.prod(dims)

    _, active = _skip_trivial(axis_names, dims)
    order = _check_order(round_order, len(active))
    rev_order = (tuple(reversed(order)) if reverse_round_order is None
                 else _check_order(reverse_round_order, len(active)))

    links_key = None if links is None else resolve_links(links, dims)
    key = ("sparse", dev_key, dims, axis_names, row_shape,
           dtype_name(dtype), max_count, avg, rho, variant, order,
           rev_order, links_key)
    cached = _registry_fetch(key)
    if cached is not None:
        return cached

    # The ragged family's counts plan, so a ragged and a sparse plan over
    # one torus share the registry entry.
    counts = _build_dense_plan(mesh_or_axis_dims, axis_names, (p,),
                               torch.int32, backend="tuned", variant=variant,
                               round_order=round_order,
                               reverse_round_order=reverse_round_order,
                               max_chunks=1, links=links)

    from .sparse import round_message_masks
    masks_fwd = round_message_masks(active, order)
    masks_rev = masks_fwd if rev_order == order \
        else round_message_masks(active, rev_order)

    link_models = resolve_links(links, dims, axis_names)
    row_bytes = math.prod(row_shape) * itemsize(dtype)
    predicted = predict_sparse(dims, link_models, float(row_bytes), bucket,
                               p, density=rho)

    plan = SparseA2APlan(fact, counts, max_count=max_count, avg_count=avg,
                         expected_density=rho, row_shape=row_shape,
                         dtype=dtype, order=order, rev_order=rev_order,
                         masks_fwd=masks_fwd, masks_rev=masks_rev,
                         links=link_models, predicted_seconds=predicted)
    return _registry_store(key, plan)


# ---------------------------------------------------------------------------
# KV-migration (prefill -> decode handoff) plans
# ---------------------------------------------------------------------------


class KVMigrationPlan:
    """A resolved, reusable prefill -> decode KV-cache migration plan.

    Construct via :func:`plan_kv_migration` (or
    ``TorusComm.kv_migration``); never directly.  The KV handoff of a
    disaggregated serving topology is an Alltoallv over the *full*
    serving comm whose count matrix is non-zero only in the
    prefill -> decode block (rows ``< n_prefill``, columns ``>=
    n_prefill``): per-sequence variable lengths are the send counts and
    the scheduler's placement is the router.  The plan wraps the
    matching exchange, a :class:`RaggedA2APlan` or, in the
    few-migrations-per-tick regime the cost model prices via the block
    density, a :class:`SparseA2APlan`, and adds the block-structure
    validation (:meth:`pair_counts`), so that a misplaced sequence fails
    at the datatype layer, not as silent corruption.

    ``forward`` / ``reverse`` are the inner plan's SPMD calls (each rank
    its own ``(p, m, *row)`` send block), traced under the inner plan's
    ``plan.execute``; ``exact`` is the inner plan's host path over every
    rank's rows in one process.  Cached in the shared LRU registry;
    evicting it drops the inner plan with the same teardown.
    """

    kind = "kv_migrate"

    def __init__(self, inner, *, requested_backend: str, n_prefill: int,
                 migrations_per_tick: float, expected_density: float,
                 predicted_seconds: float | None, tuned_from: str | None):
        self.inner = inner
        self.requested_backend = requested_backend
        self.n_prefill = int(n_prefill)
        self.migrations_per_tick = float(migrations_per_tick)
        self.expected_density = float(expected_density)
        self.predicted_seconds = predicted_seconds
        self.tuned_from = tuned_from
        self._from_cache = False

    # -- identity ----------------------------------------------------------

    @property
    def fact(self) -> TorusFactorization:
        return _plan_fact(self.inner)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.inner.axis_names

    @property
    def dims(self) -> tuple[int, ...]:
        return self.inner.dims

    @property
    def p(self) -> int:
        return self.inner.p

    @property
    def d(self) -> int:
        return self.inner.d

    @property
    def n_decode(self) -> int:
        return self.p - self.n_prefill

    @property
    def inner_kind(self) -> str:
        return "sparse" if isinstance(self.inner, SparseA2APlan) \
            else "ragged"

    @property
    def backend(self) -> str:
        return self.inner.backend

    @property
    def variant(self) -> str:
        return self.inner.variant

    @property
    def bucket(self) -> int:
        return self.inner.bucket

    @property
    def max_count(self) -> int:
        return self.inner.max_count

    @property
    def avg_count(self) -> float:
        return self.inner.avg_count

    @property
    def row_shape(self) -> tuple[int, ...]:
        return self.inner.row_shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def row_bytes(self) -> int:
        return self.inner.row_bytes

    @property
    def expected_occupancy(self) -> float:
        return self.inner.expected_occupancy

    # -- the datatype layer ------------------------------------------------

    def pair_counts(self, pairs) -> np.ndarray:
        """Validate scheduler placements and build the ``(p, p)`` int32
        count matrix: ``pairs`` maps ``(src, dst) -> row count``.  Every
        source must be a prefill rank (``src < n_prefill``), every
        destination a decode rank (``dst >= n_prefill``), and every
        count within the plan's ``max_count`` bound, the fixed-shape
        contract of the bucketed exchange."""
        counts = np.zeros((self.p, self.p), np.int32)
        for (src, dst), n in pairs.items():
            src, dst, n = int(src), int(dst), int(n)
            if not 0 <= src < self.n_prefill:
                raise ValueError(f"migration source {src} is not a prefill "
                                 f"rank (n_prefill={self.n_prefill})")
            if not self.n_prefill <= dst < self.p:
                raise ValueError(f"migration destination {dst} is not a "
                                 f"decode rank (n_prefill="
                                 f"{self.n_prefill}, p={self.p})")
            if not 0 <= n <= self.max_count:
                raise ValueError(f"migration count {n} for pair "
                                 f"({src}, {dst}) outside [0, max_count="
                                 f"{self.max_count}]")
            counts[src, dst] = n
        return counts

    # -- execution surface (collective: every rank of the torus) ----------

    def forward(self, x, send_counts):
        """The bucketed exchange: this rank's ``(p, m, *row)`` send block
        (``m <= bucket``) and ``(p,)`` int32 send counts in, ``(recv,
        recv_counts)`` out, as the inner ragged / sparse plan's."""
        return self.inner.forward(x, send_counts)

    def reverse(self, x, send_counts):
        return self.inner.reverse(x, send_counts)

    def counts_matrix(self, send_counts):
        return self.inner.counts_matrix(send_counts)

    def occupancy(self, send_counts):
        return self.inner.occupancy(send_counts)

    def exact(self, rows):
        """The exact host path: nested ``rows[s][d]`` in, ``(recv,
        counts)`` out with ``recv[r][s]`` the rows rank ``r`` received
        from ``s``; the sparse inner plan's volume accounting lands on
        ``inner.last_stats``."""
        out = self.inner.exact(rows)
        if len(out) == 3:            # sparse: (recv, counts, vol)
            recv, counts, _ = out
            return recv, counts
        return out

    def _drift_key(self) -> str:
        return self.inner._drift_key()

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved plan (the
        reference's keys and values): ``kind="kv_migrate"``, occupancy and
        ``tuned_from`` like every other plan, and the serving-topology
        fields (``n_prefill`` / ``n_decode`` / ``expected_density`` /
        ``inner_kind``)."""
        return {
            "kind": "kv_migrate",
            "inner_kind": self.inner_kind,
            "axis_names": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": self.backend,
            "requested_backend": self.requested_backend,
            "variant": self.variant,
            "row_shape": list(self.row_shape),
            "dtype": dtype_name(self.dtype),
            "row_bytes": self.row_bytes,
            "max_count": self.max_count,
            "avg_count": self.avg_count,
            "bucket": self.bucket,
            "expected_occupancy": self.expected_occupancy,
            "n_prefill": self.n_prefill,
            "n_decode": self.n_decode,
            "migrations_per_tick": self.migrations_per_tick,
            "expected_density": self.expected_density,
            "predicted_seconds": self.predicted_seconds,
            "tuned_from": self.tuned_from,
            "drift_ratio": telemetry.drift_detector()
            .drift_ratio(self._drift_key()),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"KVMigrationPlan(dims={self.dims}, "
                f"axes={self.axis_names}, inner={self.inner_kind!r}, "
                f"n_prefill={self.n_prefill}, bucket={self.bucket})")


def plan_kv_migration(mesh_or_axis_dims, axis_names, row_shape=(),
                      dtype="float32", *, max_count: int, n_prefill: int,
                      avg_count: float | None = None,
                      migrations_per_tick: float = 1.0,
                      backend: str = "tuned", variant: str = "natural",
                      round_order=None, reverse_round_order=None,
                      links=None, db=None) -> KVMigrationPlan:
    """Build (or fetch from the LRU registry) a :class:`KVMigrationPlan`,
    through the implicit communicator.  The knobs are
    :func:`plan_ragged_all_to_all`'s, plus:

      n_prefill: ranks ``0..n_prefill-1`` are the prefill domain, the
        rest the decode domain: the block structure
        :meth:`KVMigrationPlan.pair_counts` enforces.
      migrations_per_tick: expected concurrently migrating sequences per
        serving tick; with ``backend="tuned"`` it sets the count-matrix
        density the cost model prices (``tuning.predict_kv_migration``)
        to pick the ragged or the sparse inner exchange.
      backend: ``"tuned"`` (the cost model's choice between the
        bucketed ragged exchange and the sparse one), ``"ragged"`` /
        ``"sparse"`` (an explicit inner kind), or a dense data backend
        (``"direct"`` | ``"factorized"`` | ``"overlap"`` |
        ``"pipelined"`` | ``"autotune"``: a ragged plan with that data
        phase).
    """
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).kv_migration(
        row_shape, dtype, max_count=max_count, n_prefill=n_prefill,
        avg_count=avg_count, migrations_per_tick=migrations_per_tick,
        backend=backend, round_order=round_order,
        reverse_round_order=reverse_round_order, links=links, db=db)


def _build_kv_plan(mesh_or_axis_dims, axis_names, row_shape=(),
                   dtype="float32", *, max_count: int, n_prefill: int,
                   avg_count: float | None = None,
                   migrations_per_tick: float = 1.0,
                   backend: str = "tuned", variant: str = "natural",
                   round_order=None, reverse_round_order=None,
                   links=None, db=None) -> KVMigrationPlan:
    """The resolution behind ``TorusComm.kv_migration``: the block-density
    estimate, the ragged-vs-sparse inner choice, and the shared
    registry."""
    axis_names = _as_tuple(axis_names)
    if isinstance(mesh_or_axis_dims, DeviceMesh):
        shape = mesh_shape(mesh_or_axis_dims)
        dims = tuple(shape[n] for n in axis_names)
        dev_key = device_fingerprint(mesh_or_axis_dims)
    else:
        dims = tuple(int(s) for s in mesh_or_axis_dims)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for {len(axis_names)} axes")
        dev_key = None
    p = math.prod(dims)
    n_prefill = int(n_prefill)
    if not 0 < n_prefill < p:
        raise ValueError(f"n_prefill {n_prefill} outside (0, p={p}); a "
                         "disaggregated topology needs at least one rank "
                         "in each domain")
    migrations = float(migrations_per_tick)
    if migrations <= 0:
        raise ValueError(f"migrations_per_tick must be > 0, got "
                         f"{migrations}")
    pairs = min(migrations, float(n_prefill * (p - n_prefill)))
    density = max(pairs, 1.0) / float(p * p)

    from .ragged import next_pow2
    bucket = next_pow2(int(max_count))
    row_shape = tuple(int(s) for s in row_shape)
    links_key = None if links is None else resolve_links(links, dims)
    key = ("kv_migrate", dev_key, dims, axis_names, row_shape,
           dtype_name(dtype), int(max_count),
           None if avg_count is None else float(avg_count), n_prefill,
           migrations, backend, variant,
           None if round_order is None else tuple(round_order),
           None if reverse_round_order is None
           else tuple(reverse_round_order), links_key)
    cached = _registry_fetch(key)
    if cached is not None:
        return cached

    link_models = resolve_links(links, dims, axis_names)
    row_bytes = math.prod(row_shape) * itemsize(dtype)
    sched = predict_kv_migration(dims, link_models, float(row_bytes),
                                 bucket, n_prefill=n_prefill,
                                 migrations_per_tick=migrations)

    inner_kind = backend
    tuned_from = None
    if backend == "tuned":
        inner_kind = "sparse" if sched.kind == "sparse" else "ragged"
        tuned_from = "model"
    if inner_kind == "sparse":
        inner = _build_sparse_plan(
            mesh_or_axis_dims, axis_names, row_shape, dtype,
            max_count=max_count, avg_count=avg_count, density=density,
            variant=variant, round_order=round_order,
            reverse_round_order=reverse_round_order, links=links)
    else:
        # "ragged" resolves the data phase through the cost model; any
        # other name is an explicit dense data backend, passed through.
        data_backend = "tuned" if inner_kind == "ragged" else inner_kind
        inner = _build_ragged_plan(
            mesh_or_axis_dims, axis_names, row_shape, dtype,
            max_count=max_count, avg_count=avg_count,
            backend=data_backend, variant=variant,
            round_order=round_order,
            reverse_round_order=reverse_round_order, links=links, db=db)
        if tuned_from is None:
            tuned_from = inner.tuned_from

    plan = KVMigrationPlan(inner, requested_backend=backend,
                           n_prefill=n_prefill,
                           migrations_per_tick=migrations,
                           expected_density=density,
                           predicted_seconds=sched.predicted_seconds,
                           tuned_from=tuned_from)
    return _registry_store(key, plan)


def free_plans() -> None:
    """Evict every cached plan, running the delete callback on each."""
    while True:
        keys = _PLANS.keys()
        if not keys:
            return
        _drop_plan(keys[0])


def set_plan_cache_capacity(capacity: int) -> None:
    """Bound the plan registry (evicting LRU entries if needed)."""
    _PLANS.set_capacity(capacity)


def plan_cache_stats() -> dict[str, int]:
    out = dict(_PLANS.stats)
    out["size"] = len(_PLANS)
    out["capacity"] = _PLANS.capacity
    return out


def plan_cache_entries() -> list:
    """Snapshot of the live plans, LRU-oldest first (for logging and the
    dry run's records; does not touch recency or stats)."""
    return _PLANS.values()


telemetry.register_stats_provider("plan_cache", plan_cache_stats)
