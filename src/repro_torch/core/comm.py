"""TorusComm — the cached Cartesian communicator as the API root (the dense
half of ``repro.core.comm``).

The paper's load-bearing object is the *cached Cartesian communicator*:
``MPI_Cart_create`` once, split into d dimension-wise sub-communicators
once, cache both, and express every collective as d dimension-wise
exchanges.  :class:`TorusComm` makes it explicit over a ``DeviceMesh``:

* ``torus_comm(mesh_or_dims, axes, *, d=None, variant=...)`` builds (or
  fetches from a bounded LRU registry) the communicator: it owns the
  torus factorization descriptor (with its process groups), the rank
  fingerprint, and its slice of the plan registry.
* ``comm.sub(axes)`` is the dimension-wise split made user-visible and
  recursive; sub-comm all-to-all plans share the plan registry with
  their top-level equivalents.
* ``comm.all_to_all`` builds the dense :class:`~repro_torch.core.plan
  .A2APlan`; ``comm.ragged_all_to_all`` / ``comm.sparse_all_to_all``
  the Alltoallv plans (:class:`~repro_torch.core.plan.RaggedA2APlan`,
  :class:`~repro_torch.core.plan.SparseA2APlan`); ``comm.all_gather`` /
  ``comm.reduce_scatter`` the dimension-wise gather family: one
  all-gather / reduce-scatter per torus dimension (``"factorized"``,
  its ``n_chunks`` chunks pipelined with async collectives), or one
  over the whole torus (``"direct"``); ``comm.transpose`` the
  pencil re-shard of the distributed FFT
  (:class:`~repro_torch.core.plan.TransposePlan`, ``workloads.fft``);
  ``comm.kv_migration`` the prefill -> decode KV handoff of
  disaggregated serving (:class:`~repro_torch.core.plan.KVMigrationPlan`,
  ``runtime.serving``).
* ``comm.free()`` (or the context-manager form) is the delete callback;
  ``comm.stats()`` is the unified cache report.

* ``comm.partition(n_first)`` is the ``MPI_Comm_split`` analogue by rank
  range (two balanced tori of ``n_first`` and ``p - n_first`` ranks);
  ``comm.rebuild(surviving)`` the elastic step after a device loss: the
  survivors re-factorized by ``dims_create``, the dead comm's plan slice
  freed, its tuning records migrated where their extents survived.

Like every collective here, construction is collective (it may create
process groups) and execution is SPMD: every rank of the torus calls the
same methods in the same order.  A mesh over a strict subset of the world
(a rebuilt comm's survivors, a partition's child) is built by its members
alone (``core.cache``), so ``rebuild`` is collective over the survivors
only and a lost rank makes no call.  A comm may be bound to a tuning DB
(``db=``), which its ``backend="autotune"`` plans read.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.block_reorder import to_group_order, to_torus_order
from repro_torch.kernels.ops import _trains

from . import plan as _planmod
from . import telemetry
from .cache import (
    LRUCache,
    TorusFactorization,
    cache_stats,
    cart_create,
    device_fingerprint,
    get_factorization,
)
from .factorized import _as_tuple, _check_order, _require_groups, \
    _skip_trivial
from .overlap import _Chunk, _split_chunks, run_pipelined
from .plan import dtype_name, itemsize
from .tuning import (
    choose_dimwise_algorithm,
    predict_allgather,
    predict_direct,
    predict_reduce_scatter,
    resolve_links,
    slowest_active_link,
)

GATHER_BACKENDS = ("tuned", "direct", "factorized")


# ---------------------------------------------------------------------------
# Dimension-wise gather kernels (collective, on this rank's tensors)
# ---------------------------------------------------------------------------


def _allgather_stages(sizes, groups, order):
    """One stage per round of ``order`` on a chunk's block view (axes
    ``[dim d-1, ..., dim 0, *chunk]``): stage ``k`` issues the
    all-gather over dimension ``k``'s group asynchronously and leaves the
    growth of dimension ``k``'s axis from 1 to ``D[k]`` as the chunk's
    ``tail``, which the next stage (or the join) runs after ``wait()``."""
    d = len(sizes)

    def stage(k):
        pos = d - 1 - k

        def run(st, _c):
            src = st.settle().contiguous()
            st.buf = torch.empty((sizes[k], src.numel()), dtype=src.dtype,
                                 device=src.device)
            st.send = src.reshape(1, -1)
            st.work = dist.all_gather_into_tensor(
                st.buf, st.send, group=groups[k].pg, async_op=True)
            st.tail = lambda out: to_torus_order(out, groups[k].order) \
                .reshape((sizes[k],) + tuple(src.shape)) \
                .squeeze(pos + 1).movedim(0, pos)
            return st
        return run
    return [stage(k) for k in order]


def _allgather_impl(x, fact: TorusFactorization, *, round_order=None,
                    n_chunks: int = 1):
    """d-stage dimension-wise all-gather: ``x`` is this rank's
    ``(*block)`` contribution; returns ``(p, *block)`` with ``out[i]`` =
    the block contributed by torus rank ``i``.

    The flattened block is cut into ``n_chunks`` chunks on dim 0
    (``core.overlap._split_chunks``: the count shrinks to a divisor of
    the block's size) and every chunk's d stages run in the overlap
    engine's program order (``run_pipelined``), each stage's gather
    issued with ``async_op=True`` and waited for right before the stage
    that consumes it, so one chunk's gather is in flight while the host
    issues the next one's.  Data movement only: bit for bit the
    unchunked gather."""
    _, sizes = _skip_trivial(fact.axis_names, fact.dims)
    d = len(sizes)
    if d == 0:
        return x[None]
    order = _check_order(round_order, d)
    groups = [g for g in fact.dim_groups if g is not None]
    chunks = _split_chunks(x.reshape(-1), 0, max(1, n_chunks))
    states = [_Chunk(c.reshape((1,) * d + tuple(c.shape))) for c in chunks]
    outs = [st.settle().reshape(fact.p, -1) for st in
            run_pipelined(states, _allgather_stages(sizes, groups, order))]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape((fact.p,) + tuple(x.shape))


def _direct_allgather_impl(x, fact: TorusFactorization):
    """Baseline: one gather over the product communicator."""
    if fact.group is None:
        return x[None]
    out = torch.empty((fact.p, x.numel()), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(1, -1).contiguous(),
                                group=fact.group.pg)
    return to_torus_order(out, fact.group.order).reshape(
        (fact.p,) + tuple(x.shape))


def _reduce_scatter_stages(sizes, groups, order):
    """The mirror of :func:`_allgather_stages`: stage ``k`` issues the
    reduce-scatter over dimension ``k``'s group asynchronously and leaves
    the shrinking of dimension ``k``'s axis from ``D[k]`` to 1 as the
    chunk's ``tail``."""
    d = len(sizes)

    def stage(k):
        pos = d - 1 - k

        def run(st, _c):
            src = to_group_order(st.settle().movedim(pos, 0),
                                 groups[k].order)
            st.buf = torch.empty((1, src[0].numel()), dtype=src.dtype,
                                 device=src.device)
            st.send = src.reshape(src.shape[0], -1).contiguous()
            st.work = dist.reduce_scatter_tensor(
                st.buf, st.send, group=groups[k].pg, async_op=True)
            st.tail = lambda out: out.reshape(
                (1,) + tuple(src.shape[1:])).movedim(0, pos)
            return st
        return run
    return [stage(k) for k in order]


def _reduce_scatter_impl(x, fact: TorusFactorization, *, round_order=None,
                         n_chunks: int = 1):
    """d-stage dimension-wise reduce-scatter: ``x`` is ``(p, *block)``,
    block ``i`` this rank's term for torus rank ``i``'s sum; returns
    ``(*block)``, the full sum for this rank.  Stage ``k`` shrinks
    dimension ``k``'s axis from ``D[k]`` to 1.  Chunks are cut on dim 1
    of the ``(p, -1)`` view and pipelined as in :func:`_allgather_impl`.
    The summation order differs from the direct form: exact dtypes agree
    bit for bit, floats to rounding."""
    p = fact.p
    if x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != prod(dims)={p} "
                         f"({fact.dims})")
    _, sizes = _skip_trivial(fact.axis_names, fact.dims)
    d = len(sizes)
    if d == 0:
        return x[0]
    order = _check_order(round_order, d)
    groups = [g for g in fact.dim_groups if g is not None]
    chunks = _split_chunks(x.reshape(p, -1), 1, max(1, n_chunks))
    prefix = tuple(reversed(sizes))
    states = [_Chunk(c.reshape(prefix + (c.shape[1],))) for c in chunks]
    outs = [st.settle().reshape(-1) for st in
            run_pipelined(states,
                          _reduce_scatter_stages(sizes, groups, order))]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(x.shape[1:])


def _direct_reduce_scatter_impl(x, fact: TorusFactorization):
    """Baseline: one reduce-scatter over the product communicator."""
    if fact.group is None:
        return x[0]
    src = to_group_order(x, fact.group.order)
    out = torch.empty((1, x[0].numel()), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src.reshape(fact.p, -1).contiguous(),
                               group=fact.group.pg)
    return out.reshape(x.shape[1:])


# ---------------------------------------------------------------------------
# The gather-family plan objects
# ---------------------------------------------------------------------------


class _DimwisePlan:
    """Shared plumbing of the gather-family plans (identity, describe);
    resolved and cached like every other plan."""

    kind = "dimwise"

    def __init__(self, fact: TorusFactorization, *, requested_backend: str,
                 backend: str, order: tuple[int, ...], n_chunks: int,
                 block_shape, dtype, links, predicted_seconds, tuned_from,
                 parent):
        self.fact = fact
        self.requested_backend = requested_backend
        self.backend = backend
        self.order = order
        self.n_chunks = n_chunks
        self.block_shape = None if block_shape is None \
            else tuple(block_shape)
        self.dtype = dtype
        self.links = links
        self.predicted_seconds = predicted_seconds
        self.tuned_from = tuned_from
        # Axis names of the comm this plan's owner was split from (a
        # sub-communicator lineage marker), or None for top-level comms.
        self.parent = parent
        self._from_cache = False

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
    def block_bytes(self) -> int | None:
        if self.block_shape is None or self.dtype is None:
            return None
        return math.prod(self.block_shape) * itemsize(self.dtype)

    def _executable(self) -> None:
        _require_groups(self.fact)

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the resolved plan."""
        return {
            "kind": self.kind,
            "axes": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "backend": self.backend,
            "requested_backend": self.requested_backend,
            "variant": self.variant,
            "round_order": list(self.order),
            "n_chunks": self.n_chunks,
            "block_shape": None if self.block_shape is None
            else list(self.block_shape),
            "dtype": None if self.dtype is None else dtype_name(self.dtype),
            "block_bytes": self.block_bytes,
            "predicted_seconds": self.predicted_seconds,
            "links": [{"alpha": l.alpha, "bandwidth": l.bandwidth}
                      for l in self.links],
            "tuned_from": self.tuned_from,
            "parent": None if self.parent is None else list(self.parent),
            "cache": "hit" if self._from_cache else "miss",
        }

    def __repr__(self):
        return (f"{type(self).__name__}(dims={self.dims}, "
                f"axes={self.axis_names}, backend={self.backend!r}, "
                f"n_chunks={self.n_chunks})")


class AllGatherPlan(_DimwisePlan):
    """A resolved, reusable dimension-wise all-gather plan.  Construct
    via :meth:`TorusComm.all_gather`; never directly."""

    kind = "allgather"

    def forward(self, x):
        """``x`` is this rank's ``(*block)`` contribution; returns
        ``(p, *block)`` with ``out[i]`` = rank ``i``'s block.  Under
        autograd its backward is the reduce-scatter of the cotangent."""
        self._executable()
        if _trains(x):
            return _planmod._BlockwiseFn.apply(x, self._run, self._adjoint)
        return self._run(x)

    def _run(self, x):
        if self.backend == "direct":
            return _direct_allgather_impl(x, self.fact)
        return _allgather_impl(x, self.fact, round_order=self.order,
                               n_chunks=self.n_chunks)

    def _adjoint(self, g):
        """The reduce-scatter of ``g``, stages in the reverse order."""
        if self.backend == "direct":
            return _direct_reduce_scatter_impl(g, self.fact)
        return _reduce_scatter_impl(g, self.fact,
                                    round_order=self.order[::-1],
                                    n_chunks=self.n_chunks)


class ReduceScatterPlan(_DimwisePlan):
    """A resolved, reusable dimension-wise reduce-scatter plan.  Construct
    via :meth:`TorusComm.reduce_scatter`; never directly."""

    kind = "reduce_scatter"

    def forward(self, x):
        """``x`` is ``(p, *block)``, block ``i`` this rank's term for rank
        ``i``'s reduction; returns ``(*block)`` = the full sum for this
        rank.  Under autograd its backward is the all-gather of the
        cotangent."""
        self._executable()
        if _trains(x):
            return _planmod._BlockwiseFn.apply(x, self._run, self._adjoint)
        return self._run(x)

    def _run(self, x):
        if self.backend == "direct":
            return _direct_reduce_scatter_impl(x, self.fact)
        return _reduce_scatter_impl(x, self.fact, round_order=self.order,
                                    n_chunks=self.n_chunks)

    def _adjoint(self, g):
        """The all-gather of ``g``, stages in the reverse order."""
        if self.backend == "direct":
            return _direct_allgather_impl(g, self.fact)
        return _allgather_impl(g, self.fact, round_order=self.order[::-1],
                               n_chunks=self.n_chunks)


def _build_dimwise_plan(cls, source, axis_names, block_shape, dtype, *,
                        backend, variant, round_order, n_chunks, links,
                        parent):
    """Resolution + registry for the gather-family plans (shares the
    ``core.plan`` LRU, stats, and teardown machinery)."""
    axis_names = _as_tuple(axis_names)
    if isinstance(source, DeviceMesh):
        fact = get_factorization(source, axis_names, variant=variant)
        dims = fact.dims
        dev_key = device_fingerprint(source)
    else:
        dims = tuple(int(s) for s in source)
        fact = TorusFactorization(axis_names, dims, variant)
        dev_key = None
    if backend not in GATHER_BACKENDS:
        raise ValueError(f"unknown {cls.kind} backend {backend!r}; "
                         f"expected one of {GATHER_BACKENDS}")
    link_models = resolve_links(links, dims, axis_names)
    _, active = _skip_trivial(axis_names, dims)
    order = _check_order(round_order, len(active))

    p = math.prod(dims)
    block_bytes = None
    if block_shape is not None and dtype is not None:
        block_bytes = math.prod(tuple(block_shape)) * itemsize(dtype)

    links_key = None if links is None else link_models
    key = (cls.kind, dev_key, dims, axis_names,
           None if block_shape is None else tuple(block_shape),
           None if dtype is None else dtype_name(dtype),
           backend, variant,
           None if round_order is None else tuple(round_order),
           int(n_chunks), links_key, parent)
    cached = _planmod._registry_fetch(key)
    if cached is not None:
        return cached

    tuned_from = None
    predicted = None
    if backend == "tuned":
        if block_bytes is None:
            raise ValueError(f'backend="tuned" needs block_shape and dtype '
                             f"for the {cls.kind} cost model")
        sched = choose_dimwise_algorithm(cls.kind, dims, link_models,
                                         float(block_bytes),
                                         round_order=round_order)
        resolved, tuned_from = sched.kind, "model"
        predicted = sched.predicted_seconds
    else:
        resolved = backend
        if block_bytes is not None:
            if resolved == "direct":
                slowest = slowest_active_link(dims, link_models)
                predicted = predict_direct(p, float(block_bytes), slowest)
            else:
                predict = predict_allgather if cls.kind == "allgather" \
                    else predict_reduce_scatter
                predicted = predict(dims, link_models, float(block_bytes),
                                    p, round_order=round_order)
    plan = cls(fact, requested_backend=backend, backend=resolved,
               order=order, n_chunks=max(1, int(n_chunks)),
               block_shape=block_shape, dtype=dtype, links=link_models,
               predicted_seconds=predicted, tuned_from=tuned_from,
               parent=parent)
    return _planmod._registry_store(key, plan)


# ---------------------------------------------------------------------------
# The communicator
# ---------------------------------------------------------------------------

_COMMS: LRUCache = LRUCache(capacity=64)


class TorusComm:
    """A cached Cartesian communicator over a torus factorization.

    Construct via :func:`torus_comm`; never directly.  The comm owns the
    factorization descriptor (``fact``, with its process groups when
    mesh-backed), the mesh, the rank fingerprint key, and the registry
    keys of every plan resolved through it — its slice of the plan LRU,
    released by :meth:`free`.
    """

    def __init__(self, fact: TorusFactorization, *,
                 mesh: DeviceMesh | None, dev_key,
                 parent: "TorusComm | None" = None, db=None):
        self.fact = fact
        self.mesh = mesh
        self.dev_key = dev_key
        self.parent = parent
        self._db = db
        self._source = mesh if mesh is not None else fact.dims
        self._plan_keys: set = set()
        self._subs: dict[tuple, TorusComm] = {}
        self._parts: dict[tuple, tuple] = {}
        # elastic lineage: the dead comm this one was rebuilt from, and
        # how many tuning records migrated onto it
        self.rebuilt_from: dict | None = None
        self.tuning_migrated = 0
        # registry slot (cleared on free) and immutable identity (never
        # cleared — children key their lineage on it)
        self._comm_key = None
        self._identity = None
        self._freed = False

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
    def rank(self) -> int | None:
        """This process's torus rank (mesh-backed comms only)."""
        return self.fact.rank

    def __repr__(self):
        par = f", parent={self.parent.axis_names}" if self.parent else ""
        return (f"TorusComm(dims={self.dims}, axes={self.axis_names}, "
                f"variant={self.variant!r}{par})")

    # -- the dimension-wise split (user-visible, recursive) ----------------

    def sub(self, axes) -> "TorusComm":
        """The paper's dimension-wise communicator split: a child comm
        over a subset of this comm's axes (any order; recursive).  Its
        all-to-all plans are the identical cached objects a top-level
        ``torus_comm(mesh, axes).all_to_all(...)`` returns; its gather
        plans key on the lineage too, so ``describe()["parent"]`` is
        stable."""
        axes = _as_tuple(axes)
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axes in {axes}")
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} not in communicator axes "
                             f"{self.axis_names}")
        if axes in self._subs and not self._subs[axes]._freed:
            return self._subs[axes]
        if self.mesh is not None:
            source = self.mesh
        else:
            source = tuple(self.dims[self.axis_names.index(a)]
                           for a in axes)
        child = torus_comm(source, axes, variant=self.variant,
                           db=self._db, _parent=self)
        self._subs[axes] = child
        return child

    def partition(self, n_first: int, *, d: int | None = None,
                  prefixes: tuple[str, str] = ("pre", "dec")
                  ) -> "tuple[TorusComm, TorusComm]":
        """The ``MPI_Comm_split`` analogue by rank range: this comm's ``p``
        ranks split into a leading group of ``n_first`` torus ranks and the
        remaining ``p - n_first``, each re-factorized into its own
        balanced torus (``dims_create``), its axes named ``{prefix}0..``.
        Children are cached on this comm and freed with it; ``d`` is each
        child's degree (default: this comm's, capped by the child's size).
        Returns ``(first, rest)``.

        A dims-tuple comm gives dims-tuple children.  On a mesh each rank
        builds the child it belongs to over its members' ranks (only they
        take part, ``core.cache``) and holds the other as a dims-tuple
        comm (resolution only): the rank runs no collective of a torus it
        is not in."""
        from .dims import dims_create
        n_first = int(n_first)
        if not 0 < n_first < self.p:
            raise ValueError(f"n_first {n_first} outside (0, p={self.p}); "
                             "both partitions need at least one rank")
        if len(prefixes) != 2 or prefixes[0] == prefixes[1]:
            raise ValueError(f"need two distinct prefixes, got {prefixes}")
        key = (n_first, d, tuple(prefixes))
        if key in self._parts and not any(c._freed
                                          for c in self._parts[key]):
            return self._parts[key]
        ranks = None if self.mesh is None \
            else self.mesh.mesh.flatten().tolist()
        children = []
        for prefix, lo, hi in ((prefixes[0], 0, n_first),
                               (prefixes[1], n_first, self.p)):
            count = hi - lo
            dk = min(self.d if d is None else int(d), count)
            dims = tuple(reversed(dims_create(count, dk)))
            names = tuple(f"{prefix}{i}" for i in range(len(dims)))
            source = dims
            if ranks is not None and dist.get_rank() in ranks[lo:hi]:
                source = cart_create(ranks[lo:hi], dims, names,
                                     device_type=self.mesh.device_type)
            children.append(torus_comm(source, names, variant=self.variant,
                                       db=self._db, _parent=self))
        pair = (children[0], children[1])
        self._parts[key] = pair
        return pair

    # -- collective factories ----------------------------------------------

    def _note(self, plan):
        key = getattr(plan, "_registry_key", None)
        if key is not None:
            self._plan_keys.add(key)
            # A long-lived comm resolving many distinct shapes must not
            # outgrow the plan registry it indexes into.
            if len(self._plan_keys) > 2 * _planmod._PLANS.capacity:
                self._plan_keys = {k for k in self._plan_keys
                                   if k in _planmod._PLANS}
        return plan

    def all_to_all(self, block_shape=None, dtype=None, *,
                   backend: str = "tuned", round_order=None,
                   reverse_round_order=None, n_chunks: int = 0,
                   max_chunks: int = 8, links=None,
                   compute_seconds: float = 0.0, db=None):
        """Build (or fetch) the :class:`~repro_torch.core.plan.A2APlan`
        for one per-rank ``(block_shape, dtype)`` block — see
        :func:`~repro_torch.core.plan.plan_all_to_all` for the knobs."""
        return self._note(_planmod._build_dense_plan(
            self._source, self.axis_names, block_shape, dtype,
            backend=backend, variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, n_chunks=n_chunks,
            max_chunks=max_chunks, links=links,
            compute_seconds=compute_seconds,
            db=self._db if db is None else db))

    def ragged_all_to_all(self, row_shape=(), dtype="float32", *,
                          max_count: int, avg_count: float | None = None,
                          backend: str = "tuned", round_order=None,
                          reverse_round_order=None, n_chunks: int = 0,
                          max_chunks: int = 8, links=None,
                          compute_seconds: float = 0.0, db=None):
        """Build (or fetch) the :class:`~repro_torch.core.plan
        .RaggedA2APlan` (Alltoallv semantics) — see
        :func:`~repro_torch.core.plan.plan_ragged_all_to_all` for the
        knobs."""
        return self._note(_planmod._build_ragged_plan(
            self._source, self.axis_names, row_shape, dtype,
            max_count=max_count, avg_count=avg_count, backend=backend,
            variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, n_chunks=n_chunks,
            max_chunks=max_chunks, links=links,
            compute_seconds=compute_seconds,
            db=self._db if db is None else db))

    def sparse_all_to_all(self, row_shape=(), dtype="float32", *,
                          max_count: int, avg_count: float | None = None,
                          density: float | None = None, round_order=None,
                          reverse_round_order=None, links=None):
        """Build (or fetch) the :class:`~repro_torch.core.plan
        .SparseA2APlan` (the message-combining sparse-neighborhood
        Alltoallv): the ragged counts phase plus skippable per-peer lanes
        per round — see :func:`~repro_torch.core.plan
        .plan_sparse_all_to_all` for the knobs (``density`` is the
        expected non-zero fraction of the count matrix)."""
        return self._note(_planmod._build_sparse_plan(
            self._source, self.axis_names, row_shape, dtype,
            max_count=max_count, avg_count=avg_count, density=density,
            variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, links=links))

    def kv_migration(self, row_shape=(), dtype="float32", *,
                     max_count: int, n_prefill: int,
                     avg_count: float | None = None,
                     migrations_per_tick: float = 1.0,
                     backend: str = "tuned", round_order=None,
                     reverse_round_order=None, links=None, db=None):
        """Build (or fetch) the :class:`~repro_torch.core.plan
        .KVMigrationPlan` for the prefill -> decode KV-cache handoff over
        this comm: an Alltoallv whose count matrix is non-zero only in the
        prefill -> decode block — see :func:`~repro_torch.core.plan
        .plan_kv_migration` for the knobs."""
        return self._note(_planmod._build_kv_plan(
            self._source, self.axis_names, row_shape, dtype,
            max_count=max_count, n_prefill=n_prefill, avg_count=avg_count,
            migrations_per_tick=migrations_per_tick, backend=backend,
            variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, links=links,
            db=self._db if db is None else db))

    def transpose(self, local_shape, dtype="float32", *,
                  split_axis: int, concat_axis: int, backend: str = "tuned",
                  round_order=None, reverse_round_order=None,
                  n_chunks: int = 0, max_chunks: int = 8, links=None,
                  db=None):
        """Build (or fetch) a :class:`~repro_torch.core.plan.TransposePlan`:
        the pencil <-> pencil re-shard of a distributed FFT
        (``workloads.fft``) as a tiled all-to-all over this comm's torus.
        The local ``local_shape`` pencil is split into ``p`` chunks along
        ``split_axis`` and the received chunks concatenate source-major
        along ``concat_axis``.  Resolves through any dense backend
        (``autotune`` against this comm's tuning DB); the inverse
        transpose (axes swapped) shares the plan's inner dense plan, so a
        forward / inverse pair costs one resolution."""
        return self._note(_planmod._build_transpose_plan(
            self._source, self.axis_names, local_shape, dtype,
            split_axis=split_axis, concat_axis=concat_axis, backend=backend,
            variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, n_chunks=n_chunks,
            max_chunks=max_chunks, links=links,
            db=self._db if db is None else db,
            parent=self._parent_axes()))

    def all_gather(self, block_shape=None, dtype=None, *,
                   backend: str = "tuned", round_order=None,
                   n_chunks: int = 1, links=None) -> AllGatherPlan:
        """Build (or fetch) an :class:`AllGatherPlan`: each rank
        contributes one ``(block_shape, dtype)`` block, every rank ends
        with all ``p`` in torus-rank order."""
        return self._note(_build_dimwise_plan(
            AllGatherPlan, self._source, self.axis_names, block_shape,
            dtype, backend=backend, variant=self.variant,
            round_order=round_order, n_chunks=n_chunks, links=links,
            parent=self._parent_axes()))

    def reduce_scatter(self, block_shape=None, dtype=None, *,
                       backend: str = "tuned", round_order=None,
                       n_chunks: int = 1, links=None) -> ReduceScatterPlan:
        """Build (or fetch) a :class:`ReduceScatterPlan`: each rank
        contributes ``p`` blocks, rank ``i`` ends with the sum of every
        rank's block ``i``."""
        return self._note(_build_dimwise_plan(
            ReduceScatterPlan, self._source, self.axis_names, block_shape,
            dtype, backend=backend, variant=self.variant,
            round_order=round_order, n_chunks=n_chunks, links=links,
            parent=self._parent_axes()))

    def _parent_axes(self):
        return None if self.parent is None else self.parent.axis_names

    # -- lifecycle ----------------------------------------------------------

    def free(self) -> None:
        """The delete callback (Listing 2's ``torusdel``): recursively
        free sub-comms, drop every plan resolved through this comm from
        the registry, and retire the comm's own registry entry.
        Idempotent; a later ``torus_comm`` call builds a fresh comm (its
        process groups are reused, see ``core.cache``)."""
        for child in list(self._subs.values()):
            child.free()
        self._subs.clear()
        for pair in list(self._parts.values()):
            for child in pair:
                child.free()
        self._parts.clear()
        for key in self._plan_keys:
            _planmod._drop_plan(key)
        self._plan_keys.clear()
        if self._comm_key is not None:
            if _COMMS._data.get(self._comm_key) is self:
                _COMMS.pop(self._comm_key)
            self._comm_key = None
        self._freed = True

    def __enter__(self) -> "TorusComm":
        return self

    def __exit__(self, *exc) -> None:
        self.free()

    def rebuild(self, surviving, *, d: int | None = None,
                migrate_tuning: bool = True) -> "TorusComm":
        """The elastic rebuild step of detect → degrade → rebuild →
        resume: after a device loss, the communicator over the survivors.

        * ``p' = len(surviving)`` is re-factorized into ``d`` balanced
          factors (``dims_create``, fastest digit first) and, on a mesh,
          the survivors' Cartesian mesh is built by ``cart_create`` — by
          the survivors alone, so this call is collective over them and
          a lost rank makes none;
        * exactly this comm's slice of the plan registry is freed
          (``free()``): another comm's cached plans stay the same objects;
        * tuning-DB winners measured on the dead rank set whose per-axis
          extents hold on the new torus migrate to its fingerprint
          (``autotune.migrate_records``, marked ``migrated``); every
          survivor puts the same records, so each counts them alike;
        * returns the fresh comm; its plans resolve lazily on first use.

        ``surviving`` is a list of global ranks (its order is the new
        torus linearization), or an int: the survivor count, keeping the
        first ``p'`` ranks of the old torus (mesh-backed) or staying
        device-agnostic (dims-tuple comms).  Axis names are kept when the
        degree is unchanged, else they become ``t0..``.
        """
        from .autotune import db_fingerprint
        from .dims import dims_create
        d = self.d if d is None else int(d)
        if isinstance(surviving, int):
            survivors = None if self.mesh is None \
                else self.mesh.mesh.flatten().tolist()[:surviving]
            p2 = surviving
        else:
            survivors = [int(r) for r in surviving]
            p2 = len(survivors)
        if p2 <= 0:
            raise ValueError(f"no surviving devices (p'={p2})")
        if self.p == p2 and survivors is None and d == self.d:
            raise ValueError("rebuild needs a changed device set; "
                             f"p'={p2} == p={self.p} with no device list")
        dims2 = tuple(reversed(dims_create(p2, d)))
        names = self.axis_names if len(self.axis_names) == len(dims2) \
            else tuple(f"t{i}" for i in range(len(dims2)))
        with telemetry.get_tracer().span(
                "comm.rebuild", cat="comm", p_old=self.p, p_new=p2, d=d,
                dims_old=str(self.dims), dims_new=str(dims2)) as sp:
            source = dims2 if survivors is None or self.mesh is None \
                else cart_create(survivors, dims2, names,
                                 device_type=self.mesh.device_type)
            old = {"dims": list(self.dims), "axes": list(self.axis_names),
                   "p": self.p}
            old_db_key = None if self.mesh is None \
                else db_fingerprint(self.mesh)
            self.free()
            fresh = torus_comm(source, names, variant=self.variant,
                               db=self._db)
            fresh.rebuilt_from = old
            if migrate_tuning and old_db_key is not None \
                    and fresh.mesh is not None:
                from .autotune import get_default_db, migrate_records
                db = self._db if self._db is not None else get_default_db()
                fresh.tuning_migrated = migrate_records(
                    db, old_db_key, db_fingerprint(fresh.mesh), fresh.dims,
                    fresh.axis_names)
                sp.set(tuning_migrated=fresh.tuning_migrated)
        telemetry.metrics().counter("comm.rebuilds").inc()
        return fresh

    # -- introspection ------------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the communicator (the
        reference's keys)."""
        return {
            "kind": "comm",
            "axes": list(self.axis_names),
            "dims": list(self.dims),
            "p": self.p,
            "d": self.d,
            "variant": self.variant,
            "parent": None if self.parent is None
            else list(self.parent.axis_names),
            "device_backed": self.mesh is not None,
            "plans": len(self._plan_keys),
            "subs": sorted(list(a) for a in self._subs),
            "rebuilt_from": self.rebuilt_from,
            "tuning_migrated": self.tuning_migrated,
        }

    def stats(self) -> dict:
        """One call for the whole cache picture: this comm's identity and
        plan slice, plus the unified registry state."""
        live = sum(1 for k in self._plan_keys if k in _planmod._PLANS)
        out = unified_stats(db=self._db)
        out["comm"] = {**self.describe(), "plans_live": live,
                       "freed": self._freed}
        return out


def unified_stats(db=None) -> dict:
    """Registry-wide cache state in one dict: factorization descriptors
    (``cache_stats``), the plan LRU (``plan_cache_stats``), autotune
    counters (``autotune_stats``), the tuning-DB identity/generation, the
    communicator registry itself, and the merged telemetry view — the
    flat ``MetricsRegistry`` snapshot (every registered stats provider
    under its namespace plus ad-hoc counters), tracer state, and the
    measured-vs-model drift summary."""
    from .autotune import autotune_stats, get_default_db
    db = db if db is not None else get_default_db()
    return {
        "factorization": cache_stats(),
        "plans": _planmod.plan_cache_stats(),
        "autotune": autotune_stats(),
        "tuning_db": {"path": db.path_key, "generation": db.generation()},
        "comms": comm_registry_stats(),
        "telemetry": {
            "metrics": telemetry.metrics_snapshot(),
            "tracer": telemetry.get_tracer().stats(),
            "drift": telemetry.drift_detector().summary(),
        },
    }


def torus_comm(mesh_or_dims, axis_names=None, *, d: int | None = None,
               variant: str = "natural", device_type: str = "cuda",
               db=None, _parent: TorusComm | None = None) -> TorusComm:
    """Build (or fetch from the LRU registry) a :class:`TorusComm`.

    Args:
      mesh_or_dims: a ``DeviceMesh`` (keyed by its rank fingerprint; the
        comm can run collectives), an explicit per-axis size tuple,
        fastest digit first (resolution only), or an int ``p`` with
        ``d=`` (the ``MPI_Dims_create`` + ``MPI_Cart_create`` path: ``p``
        is factorized into ``d`` balanced dims and a Cartesian mesh of
        ``device_type`` is built over ranks ``0..p-1``).
      axis_names: torus dimensions, fastest digit first.  May be omitted
        with ``d=``: the product of the mesh dims (or ``p``) is factorized
        via ``dims_create`` over synthetic ``t0..t{d-1}`` axes.
      d: balanced-factorization degree when ``axis_names`` is omitted.
      variant: per-round formulation, "natural" or "paper".
      db: tuning-DB handle the comm's ``backend="autotune"`` plans
        consult (default: the process-wide default DB).
    """
    if isinstance(mesh_or_dims, DeviceMesh) and axis_names is None:
        if d is None:
            raise ValueError("need either axis_names or d")
        seed = get_factorization(mesh_or_dims, None, d=d, variant=variant)
        mesh_or_dims = cart_create(mesh_or_dims, seed.dims, seed.axis_names)
        axis_names = seed.axis_names
    if isinstance(mesh_or_dims, int):
        if d is None:
            raise ValueError("an int p needs d= (the dims_create path)")
        from .dims import dims_create
        dims = tuple(reversed(dims_create(mesh_or_dims, d)))
        if axis_names is None:
            axis_names = tuple(f"t{i}" for i in range(len(dims)))
        mesh_or_dims = cart_create(mesh_or_dims, dims, _as_tuple(axis_names),
                                   device_type=device_type)
    axis_names = _as_tuple(axis_names)
    if isinstance(mesh_or_dims, DeviceMesh):
        mesh = mesh_or_dims
        fact = get_factorization(mesh, axis_names, variant=variant)
        dev_key = device_fingerprint(mesh)
    else:
        dims = tuple(int(s) for s in mesh_or_dims)
        if len(dims) != len(axis_names):
            raise ValueError(f"{len(dims)} dims for {len(axis_names)} axes")
        fact = TorusFactorization(axis_names, dims, variant)
        mesh, dev_key = None, None
    # A child is keyed by the parent's full identity chain: two parents
    # over different tori may split into same-axes children.  The DB
    # handle is part of the identity too: a comm bound to a custom tuning
    # DB must not be returned to (or shadowed by) callers using the
    # process default.
    parent_key = None if _parent is None else _parent._identity
    db_key = None if db is None else db.path_key
    key = (dev_key, fact.dims, axis_names, variant, parent_key, db_key)
    cached = _COMMS.get(key)
    if cached is not None and not cached._freed:
        return cached
    comm = TorusComm(fact, mesh=mesh, dev_key=dev_key, parent=_parent,
                     db=db)
    comm._comm_key = comm._identity = key
    _COMMS.put(key, comm)
    return comm


def free_comms() -> None:
    """Drop every cached communicator (their plans stay in the plan
    registry — use ``TorusComm.free`` for the full per-comm teardown)."""
    _COMMS.clear()


def comm_registry_stats() -> dict:
    out = dict(_COMMS.stats)
    out["size"] = len(_COMMS)
    out["capacity"] = _COMMS.capacity
    return out


telemetry.register_stats_provider("comms", comm_registry_stats)

__all__ = [
    "AllGatherPlan",
    "GATHER_BACKENDS",
    "ReduceScatterPlan",
    "TorusComm",
    "comm_registry_stats",
    "free_comms",
    "torus_comm",
    "unified_stats",
]
