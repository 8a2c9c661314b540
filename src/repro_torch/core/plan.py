"""A2APlan — the cached plan-object API for the dense all-to-all (the dense
half of ``repro.core.plan``).

``plan_all_to_all`` resolves, once per ``(ranks, axes, shape, dtype,
knobs)`` key, the torus factorization (``core.cache``, with its process
groups when a ``DeviceMesh`` is given), the backend — requested
explicitly or chosen by the alpha-beta cost model (``backend="tuned"`` →
``tuning.choose_algorithm``) — and the forward and reverse round orders,
and returns an :class:`A2APlan` whose ``forward`` / ``reverse`` /
``tiled`` methods are the execution surface (MoE dispatch and combine).
Plans live in a bounded LRU registry; evicting the last plan over a
factorization releases the descriptor (the paper's delete callback).

Resolution is the reference's, line for line (same cost model, same
keys), so ``describe()`` gives the reference's dict for every backend.
Execution covers ``direct`` and ``factorized``: a plan that resolved to
``pipelined`` or ``overlap`` — the chunked overlap engine — or that was
requested as ``autotune`` raises ``NotImplementedError`` when run, and
never runs another backend in its place.  The reference's ``host_fn``
(a jitted call on a global ``(p, p, *block)`` array) has no SPMD
counterpart here: each rank runs ``forward`` on its own ``(p, *block)``
buffer.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import telemetry
from .cache import (
    LRUCache,
    TorusFactorization,
    device_fingerprint,
    get_factorization,
)
from .factorized import (
    _as_tuple,
    _check_order,
    _direct_impl,
    _direct_tiled_impl,
    _factorized_impl,
    _factorized_tiled_impl,
    _skip_trivial,
)
from .tuning import (
    LinkModel,
    Schedule,
    choose_algorithm,
    predict_direct,
    predict_factorized,
    predict_overlapped,
    resolve_links,
    slowest_active_link,
)

BACKENDS = ("tuned", "autotune", "direct", "factorized", "pipelined",
            "overlap")
_NOT_PORTED = {
    "overlap": "the overlap engine (ROADMAP queue 1 item 6)",
    "pipelined": "the overlap engine (ROADMAP queue 1 item 6)",
    "autotune": "the tuning DB (ROADMAP queue 1 item 8)",
}


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


def not_ported(backend: str, what: str):
    return NotImplementedError(
        f"{what} with backend {backend!r} needs {_NOT_PORTED[backend]}, "
        "not ported yet; use backend='direct' or 'factorized'")


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
                 tuned_from: str | None = None):
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
        # model) or None (caller requested an explicit backend).
        self.tuned_from = tuned_from
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
        from rank ``i``."""
        return self._run(x, self.order)

    def reverse(self, x):
        """The combine-direction all-to-all: same semantics as ``forward``
        but rounds run in the drain order (``rev_order``).  Bit-identical
        to ``forward`` for any order — rounds commute."""
        return self._run(x, self.rev_order)

    def _executable(self, what: str) -> None:
        if self.requested_backend == "autotune":
            raise not_ported("autotune", what)
        if self.backend not in ("direct", "factorized"):
            raise not_ported(self.backend, what)

    def _run(self, x, order):
        self._executable("A2APlan.forward/reverse")
        if x.shape[0] != self.p:
            raise ValueError(f"leading dim {x.shape[0]} != p={self.p} "
                             f"({self.dims})")
        if self.backend == "direct":
            return _direct_impl(x, self.fact)
        return _factorized_impl(x, self.fact, variant=self.variant,
                                round_order=order)

    def tiled(self, x, split_axis: int, concat_axis: int, *,
              reverse: bool = False):
        """Tiled-semantics all-to-all: split ``split_axis`` into ``p``
        chunks (chunk ``t`` -> torus rank ``t``) and concatenate what
        arrives source-major along ``concat_axis``."""
        self._executable("A2APlan.tiled")
        if self.backend == "direct":
            return _direct_tiled_impl(x, self.fact, split_axis, concat_axis)
        order = self.rev_order if reverse else self.order
        return _factorized_tiled_impl(x, self.fact, split_axis, concat_axis,
                                      variant=self.variant,
                                      round_order=order)

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
            "measured": None,        # no tuning DB yet
            "drift_ratio": None,     # no drift detector yet
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"A2APlan(dims={self.dims}, axes={self.axis_names}, "
                f"backend={self.backend!r}, n_chunks={self.n_chunks}, "
                f"variant={self.variant!r})")


# ---------------------------------------------------------------------------
# Construction + the plan registry
# ---------------------------------------------------------------------------


def _release_fact(fact) -> None:
    """Drop the factorization registry entries for ``fact`` once no live
    plan uses it — the paper's delete callback (Listing 2's ``torusdel``),
    run from the plan layer so the two registries tear down together."""
    for q in _PLANS.values():
        if q.fact == fact:
            return
    from . import cache as _cache
    _cache.free(fact)


def _on_plan_evict(plan) -> None:
    _release_fact(plan.fact)


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
                    compute_seconds: float = 0.0) -> A2APlan:
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
      backend: "tuned" (cost-model choice) or "direct" | "factorized" |
        "pipelined" | "overlap"; "autotune" resolves as a tuning-DB miss
        (the cost model) until the DB is ported.
      variant: "natural" or "paper".
      round_order / reverse_round_order: permutations of the active rounds
        (default: identity, and its reversal for the drain direction).
      n_chunks: payload chunks for the overlap engine; 0 = resolve.
      max_chunks: search bound for the tuned chunk count.
      links: per-axis :class:`LinkModel` overrides (default: DCN for
        ``pod``-like axes, ICI otherwise).
      compute_seconds: per-call interleaved compute estimate for tuning.
    """
    from .comm import torus_comm
    return torus_comm(mesh_or_axis_dims, axis_names,
                      variant=variant).all_to_all(
        block_shape, dtype, backend=backend, round_order=round_order,
        reverse_round_order=reverse_round_order, n_chunks=n_chunks,
        max_chunks=max_chunks, links=links,
        compute_seconds=compute_seconds)


def _build_dense_plan(mesh_or_axis_dims, axis_names, block_shape=None,
                      dtype=None, *, backend: str = "tuned",
                      variant: str = "natural", round_order=None,
                      reverse_round_order=None, n_chunks: int = 0,
                      max_chunks: int = 8, links=None,
                      compute_seconds: float = 0.0) -> A2APlan:
    """The resolution machinery behind ``TorusComm.all_to_all``: all
    once-per-plan decisions plus the LRU registry."""
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
    cached = _registry_fetch(key)
    if cached is not None:
        return cached

    if backend == "autotune" and (block_shape is None or dtype is None):
        raise ValueError('backend="autotune" needs block_shape and dtype '
                         "(the tuning-DB key)")
    tuned = backend in ("tuned", "autotune")
    resolved, order, rev_order, n, link_models, sched = _resolve(
        dims, axis_names, block_shape, dtype, "tuned" if tuned else backend,
        variant, round_order, reverse_round_order, n_chunks, max_chunks,
        links, compute_seconds)
    plan = A2APlan(fact, requested_backend=backend, backend=resolved,
                   variant=variant, order=order, rev_order=rev_order,
                   n_chunks=n, block_shape=None if block_shape is None
                   else tuple(block_shape), dtype=dtype, links=link_models,
                   schedule=sched, tuned_from="model" if tuned else None)
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


telemetry.register_stats_provider("plan_cache", plan_cache_stats)
