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
  .A2APlan`; ``comm.all_gather`` / ``comm.reduce_scatter`` the
  dimension-wise gather family: one all-gather / reduce-scatter per
  torus dimension (``"factorized"``), or one over
  the whole torus (``"direct"``).
* ``comm.free()`` (or the context-manager form) is the delete callback;
  ``comm.stats()`` is the unified cache report.

Like every collective here, construction is collective (it may create
process groups) and execution is SPMD: every rank of the torus calls the
same methods in the same order.  ``partition``, ``rebuild`` and the
ragged, sparse, KV-migration and transpose factories wait for their
slices (ROADMAP).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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


def _torus_order(grp, out):
    """Reorder dim 0 of a gather result from group-rank to torus order."""
    if grp.order is None:
        return out
    return out[torch.tensor(grp.order, device=out.device)]


def _allgather_impl(x, fact: TorusFactorization, *, round_order=None):
    """d-stage dimension-wise all-gather: ``x`` is this rank's
    ``(*block)`` contribution; returns ``(p, *block)`` with ``out[i]`` =
    the block contributed by torus rank ``i``.

    The block view has axes ``[dim d-1, ..., dim 0, *block]``; stage
    ``k`` grows dimension ``k``'s axis from 1 to ``D[k]`` with one
    all-gather over that dimension's group."""
    _, sizes = _skip_trivial(fact.axis_names, fact.dims)
    d = len(sizes)
    if d == 0:
        return x[None]
    order = _check_order(round_order, d)
    groups = [g for g in fact.dim_groups if g is not None]
    view = x.reshape((1,) * d + tuple(x.shape))
    for k in order:
        pos = d - 1 - k
        src = view.contiguous()
        out = torch.empty((sizes[k], src.numel()), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, src.reshape(1, -1),
                                    group=groups[k].pg)
        out = _torus_order(groups[k], out).reshape((sizes[k],) + src.shape)
        view = out.squeeze(pos + 1).movedim(0, pos)
    return view.reshape((fact.p,) + tuple(x.shape))


def _direct_allgather_impl(x, fact: TorusFactorization):
    """Baseline: one gather over the product communicator."""
    if fact.group is None:
        return x[None]
    out = torch.empty((fact.p, x.numel()), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(1, -1).contiguous(),
                                group=fact.group.pg)
    return _torus_order(fact.group, out).reshape((fact.p,) + tuple(x.shape))


def _reduce_scatter_impl(x, fact: TorusFactorization, *, round_order=None):
    """d-stage dimension-wise reduce-scatter: ``x`` is ``(p, *block)``,
    block ``i`` this rank's term for torus rank ``i``'s sum; returns
    ``(*block)``, the full sum for this rank.  Stage ``k`` shrinks
    dimension ``k``'s axis from ``D[k]`` to 1.  The summation order
    differs from the direct form: exact dtypes agree bit for bit, floats
    to rounding."""
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
    block = tuple(x.shape[1:])
    view = x.reshape(tuple(reversed(sizes)) + block)
    for k in order:
        pos = d - 1 - k
        src = view.movedim(pos, 0)
        if groups[k].order is not None:       # group-rank order
            src = src[torch.argsort(torch.tensor(groups[k].order,
                                                 device=x.device))]
        out = torch.empty((1, src[0].numel()), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(
            out, src.reshape(src.shape[0], -1).contiguous(),
            group=groups[k].pg)
        view = out.reshape((1,) + tuple(src.shape[1:])).movedim(0, pos)
    return view.reshape(block)


def _direct_reduce_scatter_impl(x, fact: TorusFactorization):
    """Baseline: one reduce-scatter over the product communicator."""
    if fact.group is None:
        return x[0]
    src = x
    if fact.group.order is not None:
        src = x[torch.argsort(torch.tensor(fact.group.order,
                                           device=x.device))]
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
        if self.n_chunks > 1:
            raise _planmod.not_ported("overlap", f"{type(self).__name__} "
                                      f"with n_chunks={self.n_chunks}")
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
        ``(p, *block)`` with ``out[i]`` = rank ``i``'s block."""
        self._executable()
        if self.backend == "direct":
            return _direct_allgather_impl(x, self.fact)
        return _allgather_impl(x, self.fact, round_order=self.order)


class ReduceScatterPlan(_DimwisePlan):
    """A resolved, reusable dimension-wise reduce-scatter plan.  Construct
    via :meth:`TorusComm.reduce_scatter`; never directly."""

    kind = "reduce_scatter"

    def forward(self, x):
        """``x`` is ``(p, *block)``, block ``i`` this rank's term for rank
        ``i``'s reduction; returns ``(*block)`` = the full sum for this
        rank."""
        self._executable()
        if self.backend == "direct":
            return _direct_reduce_scatter_impl(x, self.fact)
        return _reduce_scatter_impl(x, self.fact, round_order=self.order)


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
                 parent: "TorusComm | None" = None):
        self.fact = fact
        self.mesh = mesh
        self.dev_key = dev_key
        self.parent = parent
        self._source = mesh if mesh is not None else fact.dims
        self._plan_keys: set = set()
        self._subs: dict[tuple, TorusComm] = {}
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
                           _parent=self)
        self._subs[axes] = child
        return child

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
                   compute_seconds: float = 0.0):
        """Build (or fetch) the :class:`~repro_torch.core.plan.A2APlan`
        for one per-rank ``(block_shape, dtype)`` block — see
        :func:`~repro_torch.core.plan.plan_all_to_all` for the knobs."""
        return self._note(_planmod._build_dense_plan(
            self._source, self.axis_names, block_shape, dtype,
            backend=backend, variant=self.variant, round_order=round_order,
            reverse_round_order=reverse_round_order, n_chunks=n_chunks,
            max_chunks=max_chunks, links=links,
            compute_seconds=compute_seconds))

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

    # -- introspection ------------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary of the communicator (the
        reference's keys; ``rebuild`` is not ported, so the elastic
        lineage fields keep their defaults)."""
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
            "rebuilt_from": None,
            "tuning_migrated": 0,
        }

    def stats(self) -> dict:
        """One call for the whole cache picture: this comm's identity and
        plan slice, plus the unified registry state."""
        live = sum(1 for k in self._plan_keys if k in _planmod._PLANS)
        out = unified_stats()
        out["comm"] = {**self.describe(), "plans_live": live,
                       "freed": self._freed}
        return out


def unified_stats() -> dict:
    """Registry-wide cache state in one dict: factorization descriptors,
    the plan LRU, the communicator registry, and the telemetry snapshot
    (every registered stats provider plus the counters)."""
    return {
        "factorization": cache_stats(),
        "plans": _planmod.plan_cache_stats(),
        "comms": comm_registry_stats(),
        "telemetry": {"metrics": telemetry.metrics_snapshot()},
    }


def torus_comm(mesh_or_dims, axis_names=None, *, d: int | None = None,
               variant: str = "natural", device_type: str = "cuda",
               _parent: TorusComm | None = None) -> TorusComm:
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
    # over different tori may split into same-axes children.
    parent_key = None if _parent is None else _parent._identity
    key = (dev_key, fact.dims, axis_names, variant, parent_key)
    cached = _COMMS.get(key)
    if cached is not None and not cached._freed:
        return cached
    comm = TorusComm(fact, mesh=mesh, dev_key=dev_key, parent=_parent)
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
