"""Logical-axis sharding rules and the layout of the sharded training
state (port of the part of ``repro.parallel.sharding`` the port needs).

The reference maps logical tensor axes ("batch", "expert", "heads", ...)
to physical mesh axes and lets GSPMD shard arrays by them.  The port runs
SPMD by hand: each rank already holds its shard, so what is needed is the
mapping and the collectives GSPMD would insert:

* :func:`resolve_spec`, the reference's resolver with its divisibility
  fallback, :func:`model_dim`, the dim of a leaf it splits over
  ``model`` for tensor parallelism, and :func:`fsdp_dim`, the dim it
  splits through the FSDP rules (``fsdp``, ``embed_fsdp``: over ``pod``
  / ``data`` by default, over ``model`` where a rule says so), with
  :func:`dp_axes`, the data-parallel dims every gradient is summed
  over;
* the "batch" rule's split (:func:`batch_axes`, :func:`batch_split`,
  :func:`batch_group`): rank order ``P(("pod", "data"))``, row block
  ``pod * |data| + data``, which is also the EP virtual rank;
* the expert-parallel group (:func:`ep_axes`, :func:`ep_geometry`) and
  the tensor-parallel group over ``model`` (:func:`tp_group`);
* :class:`ExpertSharding`, the counterpart of ``param_shardings`` for a
  tree: which leaves a rank holds as its slice of the expert dim (split
  over the EP group), which as its slice of a dim the resolver splits
  over ``model`` (heads, kv heads, the FFN's hidden dim, the vocab),
  which as its FSDP shard (the ``d_model`` dim of the embedding,
  attention and the dense FFN, over the axes its rule kept), and which
  whole leaves get only a partial gradient on each ``model`` rank; and
  the collectives that move between the shards and the global tree
  (:func:`used_columns`: the columns of a leaf gathered whole that a
  rank uses where its consumer is split over ``model``);
* :func:`all_reduce_sum`, an all-reduce autograd differentiates (the
  reference's ``pmean`` inside a differentiated ``shard_map``), and the
  two conjugate tensor-parallel Functions, :func:`tp_copy` (identity
  forward, sum backward: the input of a column-parallel product) and
  :func:`tp_reduce` (sum forward, identity backward: the output of a
  row-parallel product), :func:`tp_sum` (the sum in both passes: a
  row-parallel product of which each rank reads its own part, as the
  recurrent mixers' projections into the cell are), and
  :func:`fsdp_gather` (FSDP's gather before
  use: an all-gather forward, a reduce-scatter in f32 backward, both
  through ``TorusComm``, so factorized over the torus);
* the exchanges of sequence and pipeline parallelism, both autograd
  Functions: :func:`sp_gather` (the sequence gathered over ``model``
  after a Ulysses block; the backward keeps the rank's own slice) and
  :func:`ppermute` (``jax.lax.ppermute``: point to point, the backward
  the inverse permutation).

``constrain`` and ``use_mesh`` have no counterpart.  The port applies
every resolved axis: the expert split, ``model`` and FSDP.  Expert
leaves take no FSDP split: their expert dim is split over the whole EP
group ``(data, pod)``, which holds the same bytes a rank as the
reference's ``expert`` -> ``data`` with ``D`` -> ``pod``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.cache import mesh_shape
from repro_torch.core.comm import _direct_allgather_impl, torus_comm

# Default rules: logical name -> preferred physical axes, in priority order.
# Tuples mean "shard over the product of these axes".
DEFAULT_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("fsdp", ("pod", "data")),      # parameter sharding (ZeRO/FSDP dim)
    ("seq", ()),                    # replicated by default
    ("seq_sp", ("model",)),         # sequence parallelism (Ulysses / decode KV)
    ("embed", ()),                  # activation d_model: replicated
    ("embed_tp", ("model",)),       # param d_model rows under TP
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("vocab", ("model",)),
    ("act_embed", ("model",)),      # activation d_model between layers
    ("expert", ("data",)),          # stored expert dim (owner axis)
    ("expert_virtual", ("pod", "data")),  # virtual expert dim (EP group)
    ("embed_fsdp", ("pod", "data")),      # param row dim: FSDP sharding
    ("conv", ()),
    ("state", ()),
)


def ep_axes(mesh) -> tuple[str, ...]:
    """EP all-to-all axes, fastest digit first (owner axis, then replicas;
    ``mesh`` a ``DeviceMesh`` or ``{dim: size}``).

    The virtual-expert rank is ``data_coord + |data| * pod_coord``: experts
    are owned along "data" and replicated across "pod", so the multi-pod
    dispatch is a d=2 factorized all-to-all (the "data" round, then the
    "pod" round)."""
    names = mesh if isinstance(mesh, dict) else (mesh.mesh_dim_names or ())
    return tuple(a for a in ("data", "pod") if a in names)


@dataclass(frozen=True)
class ShardingRules:
    rules: tuple[tuple[str, tuple[str, ...]], ...] = DEFAULT_RULES

    def lookup(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        for name, axes in self.rules:
            if name == logical:
                return tuple(axes)
        raise KeyError(f"no rule for logical axis {logical!r}")

    def override(self, **kw) -> "ShardingRules":
        new = []
        seen = set()
        for name, axes in self.rules:
            if name in kw:
                new.append((name, tuple(kw[name]) if kw[name] else ()))
                seen.add(name)
            else:
                new.append((name, axes))
        for name in kw:
            if name not in seen:
                new.append((name, tuple(kw[name]) if kw[name] else ()))
        return ShardingRules(tuple(new))


def resolve_spec(shape, logical, mesh, rules: ShardingRules | None = None
                 ) -> tuple:
    """The reference's ``resolve_spec`` without jax: the physical axes
    (None, a name or a tuple of names) each dim of ``shape`` is split
    over on ``mesh`` (a ``DeviceMesh`` or ``{dim: size}``).  Fallback, in
    order: drop axes the mesh lacks; drop axes an earlier dim used; keep
    the longest prefix of the rule's axes whose size product divides the
    dim."""
    rules = rules or ShardingRules()
    shape_of = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
    if len(logical) != len(shape):
        raise ValueError(f"logical {logical} does not match shape {shape}")
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, logical):
        want = [a for a in rules.lookup(name)
                if a in shape_of and a not in used]
        best: tuple[str, ...] = ()
        acc = 1
        for a in want:
            if dim % (acc * shape_of[a]) == 0:
                acc *= shape_of[a]
                best = best + (a,)
            else:
                break
        used.update(best)
        parts.append(None if not best else best[0] if len(best) == 1
                     else best)
    return tuple(parts)


FSDP_RULES = ("fsdp", "embed_fsdp")


def model_dim(shape, logical, mesh, rules: ShardingRules | None = None
              ) -> int | None:
    """The dim of a leaf of ``shape`` with ``logical`` axes that the
    resolver splits over ``model`` through a rule other than an FSDP
    rule (a tensor-parallel split), or None (no mesh, ``model`` absent or
    1, or no such dim divides; ``mesh`` a ``DeviceMesh`` or ``{dim:
    size}``).  A dim an FSDP rule gives ``model`` (``embed_fsdp=
    ("model",)``) is :func:`fsdp_dim`'s: the leaf is gathered whole
    before use."""
    if mesh is None or (mesh if isinstance(mesh, dict) else mesh_shape(
            mesh)).get("model", 1) <= 1:
        return None
    for i, (name, part) in enumerate(zip(
            logical, resolve_spec(shape, logical, mesh, rules))):
        if name in FSDP_RULES:
            continue
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return i
    return None


def fsdp_dim(shape, logical, mesh, rules: ShardingRules | None = None
             ) -> tuple[int, tuple[str, ...]] | None:
    """``(dim, axes)``: the dim of a leaf of ``shape`` with ``logical``
    axes that the resolver splits on ``mesh`` (a ``DeviceMesh`` or
    ``{dim: size}``) through an FSDP rule (``fsdp``,
    ``embed_fsdp``), and the mesh axes it kept there after the
    divisibility fallback, most significant first (``("pod", "data")``
    under the default rules, ``("model",)`` under ``embed_fsdp=
    ("model",)``); None where no such dim is split over more than one
    rank (no mesh, the axes absent, of size 1 or not dividing)."""
    if mesh is None:
        return None
    shape_of = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
    for i, (name, part) in enumerate(zip(
            logical, resolve_spec(shape, logical, mesh, rules))):
        if name not in FSDP_RULES or part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        if math.prod(shape_of[a] for a in axes) > 1:
            return i, axes
    return None


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel dims of ``mesh`` (a ``DeviceMesh`` or ``{dim:
    size}``), most significant first: ``pod`` and ``data``, the EP
    group's.  Every leaf's gradient ends summed over them (through the
    EP dispatch, an FSDP reduce-scatter or an all-reduce); the ranks
    that differ only on one the "batch" rule leaves out hold the same
    rows."""
    names = mesh if isinstance(mesh, dict) else (mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# The expert-parallel group and the batch split
# ---------------------------------------------------------------------------


def ep_geometry(n_experts: int, mesh):
    """(axes, G, E_loc, R): the EP axes, the group size, experts per rank
    and replicas per expert (R > 1 when ``n_experts`` < G)."""
    if mesh is None:
        return (), 1, n_experts, 1
    axes = ep_axes(mesh)
    shape = mesh_shape(mesh)
    G = math.prod(shape[a] for a in axes)
    E = n_experts
    if E >= G:
        if E % G:
            raise ValueError(f"n_experts={E} not divisible by EP group {G}")
        return axes, G, E // G, 1
    if G % E:
        raise ValueError(f"EP group {G} not divisible by n_experts={E}")
    return axes, G, 1, G // E


def ep_comm(mesh):
    """The EP group's communicator (``core.comm.torus_comm`` over
    :func:`ep_axes`), or None without EP axes."""
    axes = ep_axes(mesh)
    if not axes:
        return None
    return torus_comm(mesh, axes)


def expert_range(n_experts: int, mesh) -> tuple[int, int]:
    """``(lo, E_loc)``: this rank holds experts ``lo .. lo + E_loc - 1``
    (with replicas, virtual rank ``v`` holds expert ``v % n_experts``)."""
    _, G, E_loc, _ = ep_geometry(n_experts, mesh)
    comm = None if mesh is None else ep_comm(mesh)
    v = 0 if comm is None else comm.rank
    return (v * E_loc if n_experts >= G else v % n_experts), E_loc


def batch_axes(mesh, rules: ShardingRules | None = None) -> tuple[str, ...]:
    """The mesh dims the "batch" rule splits a batch over, most
    significant first (the reference's ``P(("pod", "data"))``)."""
    shape = mesh_shape(mesh)
    return tuple(a for a in (rules or ShardingRules()).lookup("batch")
                 if a in shape)


def batch_split(mesh, rules: ShardingRules | None = None) -> tuple[int, int]:
    """``(n, i)``: the batch is cut into ``n`` row blocks and this rank
    holds block ``i`` (row-major over :func:`batch_axes`, so ``pod *
    |data| + data`` under the default rules); ``(1, 0)`` without a
    mesh."""
    if mesh is None:
        return 1, 0
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, i = 1, 0
    for a in batch_axes(mesh, rules):
        n, i = n * shape[a], i * shape[a] + coord[a]
    return n, i


def batch_group(mesh, rules: ShardingRules | None = None):
    """The ``core.cache.PeerGroup`` over the batch axes (what the batch
    is averaged over), or None when the batch is not split."""
    axes = batch_axes(mesh, rules)
    if not axes:
        return None
    return torus_comm(mesh, axes[::-1]).fact.group


def mesh_group(mesh):
    """The ``PeerGroup`` over every dim of ``mesh`` (its ``members[0]``,
    the rank at coordinate 0, is where a global array is written), or
    None on a one-rank mesh."""
    return torus_comm(mesh, tuple(reversed(mesh.mesh_dim_names))) \
        .fact.group


def collective_device(pg) -> torch.device:
    """Where a tensor sent over ``pg`` lives: the current card under
    NCCL, else the host (gloo's point-to-point takes host tensors)."""
    if dist.get_backend(pg) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = x.contiguous().clone()
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ``PeerGroup`` ``group``, differentiable:
    the backward sums the cotangents over the group (each rank's copy of
    the result feeds that rank's loss).  Collective in both passes."""
    return _AllReduceSum.apply(x, group.pg)


def tp_comm(mesh):
    """The communicator over the ``model`` dim (``core.comm.torus_comm``),
    or None when ``mesh`` has no ``model`` dim over 1."""
    if mesh is None or mesh_shape(mesh).get("model", 1) <= 1:
        return None
    return torus_comm(mesh, ("model",))


def tp_group(mesh):
    """The ``PeerGroup`` over the ``model`` dim (members in ``model``
    order), or None (see :func:`tp_comm`)."""
    comm = tp_comm(mesh)
    return None if comm is None else comm.fact.group


def tp_rank(group) -> int:
    """This rank's ``model`` coordinate in the ``PeerGroup`` ``group``."""
    return group.members.index(dist.get_rank())


# the profiler span of every tensor-parallel collective (host time; the
# span prefix ``repro_torch.`` is what profile readers filter on)
TP_SPAN = "repro_torch.tp.all_reduce"


def _summed(x, pg):
    """The sum of ``x`` over ``pg``, formed in f32 and cast back to
    ``x``'s dtype: one rounding, the same bits on every rank."""
    with torch.profiler.record_function(TP_SPAN):
        out = x.float().contiguous().clone()
        dist.all_reduce(out, group=pg)
        return out.to(x.dtype)


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.pg), None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _summed(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x, group):
    """Megatron's f: ``x`` as it is, whose cotangent is summed over the
    ``PeerGroup`` ``group`` in the backward.  It goes at the input of a
    column-parallel product, whose rank holds a slice of the output
    features, so that the input's gradient collects every slice's part.
    ``group=None``: ``x``."""
    return x if group is None else _TPCopy.apply(x, group.pg)


def tp_reduce(x, group):
    """Megatron's g: the sum of ``x`` over ``group`` (in f32, cast back),
    whose backward passes the cotangent as it is.  It goes at the output
    of a row-parallel product, whose rank holds a partial sum.
    (:func:`all_reduce_sum` would also sum the backward, |model| times
    the gradient here: every rank's copy of this sum feeds the same
    loss.)  ``group=None``: ``x``."""
    return x if group is None else _TPReduce.apply(x, group.pg)


def tp_sum(x, group):
    """The sum of ``x`` over ``group`` (in f32, cast back) where the ranks
    go on to read different parts of it (a row-parallel product feeding
    per-rank channels or heads): :func:`tp_copy` of :func:`tp_reduce`,
    whose backward sums the cotangent over ``group`` too, since every
    rank's part of the loss reaches the sum.  ``group=None``: ``x``."""
    return tp_copy(tp_reduce(x, group), group)


def split_group(spec, mesh, rules: ShardingRules | None = None):
    """The ``model`` group a leaf of ``spec`` (a ``ParamSpec``) is split
    over by the resolver on ``mesh``, or None where it is whole."""
    if model_dim(spec.shape, spec.logical, mesh, rules) is None:
        return None
    return tp_group(mesh)


def used_columns(w, spec, group, mesh, rules: ShardingRules | None = None):
    """The columns (last dim) of the leaf ``w`` of ``spec`` that this rank
    uses where its consumer is split over the ``model`` group ``group``:
    ``w`` as it is where the resolver splits it over ``model`` too (it is
    held as those columns) or ``group`` is None, else, ``w`` whole on
    the rank (gathered by FSDP over ``model``), the rank's slice of each
    of its ``spec.column_groups`` column groups (:func:`model_block`),
    side by side: the columns it would hold."""
    if group is None or model_dim(spec.shape, spec.logical, mesh,
                                  rules) is not None:
        return w
    return model_block(w, w.dim() - 1, spec.column_groups, tp_rank(group),
                       group.size).flatten(-2, -1)


# the profiler span of FSDP's gather and of its gradient's reduce-scatter
FSDP_SPAN = "repro_torch.fsdp"


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        with torch.profiler.record_function(FSDP_SPAN):
            parts = comm.all_gather(tuple(x.shape), x.dtype).forward(
                x.contiguous())
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.comm, ctx.dim
        with torch.profiler.record_function(FSDP_SPAN):
            parts = g.unflatten(dim, (comm.p, -1)).movedim(dim, 0)
            # one f32 copy, in the group's block order
            blocks = torch.empty(parts.shape, dtype=torch.float32,
                                 device=g.device).copy_(parts)
            out = comm.reduce_scatter(tuple(blocks.shape[1:]),
                                      torch.float32).forward(blocks)
        return out.to(g.dtype), None, None


def fsdp_gather(x, comm, dim: int):
    """FSDP's gather before use: every rank's shard ``x`` of the
    ``TorusComm`` ``comm`` concatenated along ``dim`` in its torus rank
    order (``comm.all_gather``, the ``tuned`` backend, in ``x``'s dtype).
    The backward cuts the cotangent into the group's blocks and sums
    each over the group in f32 (``comm.reduce_scatter``), cast back
    once: this rank's shard of the gradient, summed over the group.
    Collective in both passes; ``comm=None``: ``x``."""
    return x if comm is None else _FSDPGather.apply(x, comm, dim)


def tp_gather(x, group, dim: int = -1):
    """The concatenation over ``group``, in ``model`` order, of every
    rank's ``x`` along ``dim`` (no autograd; ``group=None``: ``x``)."""
    if group is None:
        return x
    parts = torch.empty((group.size,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    with torch.profiler.record_function(TP_SPAN):
        dist.all_gather_into_tensor(parts, x.detach().contiguous()[None],
                                    group=group.pg)
    if group.order is not None:
        parts = parts[list(group.order)]
    return torch.cat(list(parts.unbind(0)), dim=dim)


class _SPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.n = tp_rank(group), dim, x.shape[dim]
        return tp_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def sp_gather(x, group, dim: int):
    """The sequence gathered over ``model`` after a sequence-parallel
    block: every rank's ``x`` concatenated along ``dim`` in ``model``
    order (:func:`tp_gather`).  The backward passes this rank's own slice
    of the cotangent, summed with nothing: every ``model`` rank computes
    the same replica of the rest of the step, so each one's cotangent is
    already the whole gradient of the gathered tensor.  ``group=None``:
    ``x``."""
    return x if group is None else _SPGather.apply(x, group, dim)


# the profiler span of every point-to-point permutation
PPERMUTE_SPAN = "repro_torch.ppermute"


def _permuted(x, group, perm):
    """This rank's part of the permutation ``perm`` over ``group``: send
    ``x`` to the member ``perm`` maps it to and return what the member
    mapped to it sent (zeros where none is).  NCCL sends from the card in
    one ``batch_isend_irecv``; gloo's point-to-point takes host tensors,
    so there the tensors are staged through host memory."""
    me = tp_rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if dst == me:
        return x.clone()
    dev = collective_device(group.pg)
    with torch.profiler.record_function(PPERMUTE_SPAN):
        ops, recv = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x.detach().to(dev).contiguous(),
                                  group.members[dst], group.pg))
        if src is not None:
            recv = torch.empty(x.shape, dtype=x.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, recv, group.members[src],
                                  group.pg))
        if dev.type == "cuda":
            works = dist.batch_isend_irecv(ops) if ops else []
        else:
            works = [op.op(op.tensor, op.peer, group=op.group) for op in ops]
        for w in works:
            w.wait()
    if recv is None:
        return torch.zeros_like(x)
    return recv.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permuted(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permuted(g, ctx.group, inverse), None, None


def ppermute(x, group, perm):
    """``jax.lax.ppermute`` over the ``PeerGroup`` ``group``: ``perm`` is
    a sequence of ``(source, destination)`` pairs of member indices (the
    group's coordinate, as :func:`tp_rank` gives it); each source sends
    its ``x`` to its destination, and a member no pair names as a
    destination gets zeros.  Differentiable: the backward sends each
    cotangent back along the inverse permutation.  Collective in both
    passes: every member must reach each call's backward too, so a
    caller keeps every result in the graph of its loss (as a masked
    ``torch.where`` does, whose zero branch still reaches the call).
    ``group=None``: ``x``."""
    if group is None:
        return x
    return _PPermute.apply(x, group, tuple(perm))


# ---------------------------------------------------------------------------
# The layout of a sharded tree
# ---------------------------------------------------------------------------


def model_block(t, dim: int, k: int, m: int, n: int):
    """Rank ``m`` of ``n``'s block of ``dim`` of the global ``t`` whose
    ``dim`` holds ``k`` equal column groups side by side: a view with
    ``dim`` unflattened to ``(k, c)``, the m-th ``c`` columns of each
    group (``k`` = 1: the contiguous m-th block)."""
    g = t.unflatten(dim, (k, -1))
    c = g.shape[dim + 1] // n
    return g.narrow(dim + 1, m * c, c)


def model_join(t, dim: int, k: int, n: int):
    """The global leaf from ``t``, the ``n`` ranks' blocks (each
    :func:`model_block` flattened) concatenated along ``dim`` in
    ``model`` order: ``(rank, group, c)`` regrouped as ``(group, rank,
    c)``."""
    if k == 1:
        return t
    return t.unflatten(dim, (n, k, -1)).transpose(dim, dim + 1) \
        .flatten(dim, dim + 2)


class ExpertSharding:
    """How this rank holds a tree on ``mesh`` (the layout of the sharded
    training state).  ``axes`` maps the path of each leaf split over the
    EP group to the index of its expert dim (``n_experts`` long globally,
    ``E_loc`` here); ``model_axes`` maps the path of each leaf split over
    ``model`` to that dim (``|model|`` times this rank's length
    globally); ``fsdp_axes`` maps the path of each leaf split by FSDP to
    that dim and ``fsdp_kept`` to the mesh axes it is split over (most
    significant first: shard ``i`` is block ``pod * |data| + data`` under
    the default rules, the torus rank of :meth:`fsdp_comm`, the
    communicator over them; leaves may keep different axes, as the
    embedding keeps ``pod`` alone under ``vocab=("data",)``).
    A leaf may be in two: an expert ``w1`` ``(E, D, F)`` holds its EP
    rank's experts and its ``model`` rank's slice of F, a ``wq`` ``(L, D,
    H, hd)`` its FSDP shard of D and its ``model`` rank's heads.
    ``partial`` names leaves whose gradient on each ``model`` rank is
    that rank's part only (a kv projection kept whole over ``model``
    while the query heads are split), which :meth:`sum_partial` sums
    over ``model``.  An FSDP leaf split over ``model`` (``embed_fsdp=
    ("model",)``) is gathered whole and each ``model`` rank uses the
    heads or columns of its split consumer, so the reduce-scatter sums
    parts; ``fsdp_whole`` names those every ``model`` rank uses whole
    instead, whose summed gradient holds ``|model|`` full copies
    (:meth:`repeats`).  ``model_groups`` maps a leaf split over ``model``
    whose dim holds k > 1 equal column groups (a fused ``[xs | z]``
    product) to k: its rank ``m`` holds the m-th slice of each group
    (:func:`model_block`), and the global leaf keeps the groups side by
    side as they are.  Every other leaf is whole on every rank.  Built by
    ``models.common.param_shardings``; :meth:`prefixed` and
    :meth:`merged` carry it to trees that hold the parameters' shapes
    (the AdamW moments, a trainer's state)."""

    def __init__(self, axes: dict, n_experts: int, mesh,
                 model_axes: dict | None = None, partial=(),
                 fsdp_axes: dict | None = None, fsdp_kept: dict | None = None,
                 rules: ShardingRules | None = None,
                 model_groups: dict | None = None, fsdp_whole=()):
        self.axes = dict(axes)
        self.model_axes = dict(model_axes or {})
        self.model_groups = dict(model_groups or {})
        self.fsdp_axes = dict(fsdp_axes or {})
        self.fsdp_kept = {p: tuple((fsdp_kept or {})[p])
                          for p in self.fsdp_axes}
        self.fsdp_whole = frozenset(fsdp_whole)
        self.partial = frozenset(partial)
        self.n_experts = n_experts
        self.mesh = mesh
        self.rules = rules
        _, self.G, self.E_loc, self.R = ep_geometry(n_experts, mesh)
        self.comm = ep_comm(mesh) if self.axes else None
        self.tp = tp_group(mesh) if self.model_axes or self.partial \
            else None
        # one communicator per distinct kept-axes tuple, and the group of
        # the data-parallel axes it leaves out (an FSDP leaf's gradient is
        # summed over them after the reduce-scatter), built in the same
        # order on every rank
        self.dp = dp_axes(mesh)
        self._fsdp, self._rest = {}, {}
        for kept in sorted(set(self.fsdp_kept.values())):
            self._fsdp[kept] = torus_comm(mesh, kept[::-1])
            rest = tuple(a for a in self.dp if a not in kept)
            self._rest[kept] = torus_comm(mesh, rest[::-1]).fact.group \
                if rest else None
        self.dp_group = torus_comm(mesh, self.dp[::-1]).fact.group \
            if self.dp else None
        self.group = mesh_group(mesh)

    @property
    def writer(self) -> bool:
        """Whether this rank writes what holds global arrays (the rank at
        mesh coordinate 0)."""
        return self.group is None or dist.get_rank() == self.group.members[0]

    def fsdp_comm(self, path: str):
        """The ``TorusComm`` over the axes the FSDP leaf at ``path`` is
        split over (its torus rank is this rank's shard)."""
        return self._fsdp[self.fsdp_kept[path]]

    def _with(self, axes, model_axes, partial, fsdp_axes, model_groups,
              fsdp_kept, fsdp_whole) -> "ExpertSharding":
        return ExpertSharding(axes, self.n_experts, self.mesh, model_axes,
                              partial, fsdp_axes, fsdp_kept, self.rules,
                              model_groups, fsdp_whole)

    def prefixed(self, prefix: str) -> "ExpertSharding":
        pre = lambda d: {f"{prefix}/{p}": a for p, a in d.items()}
        add = lambda s: {f"{prefix}/{p}" for p in s}
        return self._with(pre(self.axes), pre(self.model_axes),
                          add(self.partial), pre(self.fsdp_axes),
                          pre(self.model_groups), pre(self.fsdp_kept),
                          add(self.fsdp_whole))

    def merged(self, *others) -> "ExpertSharding":
        axes, model_axes = dict(self.axes), dict(self.model_axes)
        fsdp_axes, partial = dict(self.fsdp_axes), set(self.partial)
        groups, kept = dict(self.model_groups), dict(self.fsdp_kept)
        whole = set(self.fsdp_whole)
        for o in others:
            axes.update(o.axes)
            model_axes.update(o.model_axes)
            fsdp_axes.update(o.fsdp_axes)
            groups.update(o.model_groups)
            kept.update(o.fsdp_kept)
            partial |= o.partial
            whole |= o.fsdp_whole
        return self._with(axes, model_axes, partial, fsdp_axes, groups,
                          kept, whole)

    def split(self, path: str) -> bool:
        """Whether this rank holds a slice of the leaf at ``path``."""
        return (path in self.axes or path in self.model_axes
                or path in self.fsdp_axes)

    def repeats(self, path: str) -> int:
        """How many full copies of each row block's contribution the
        gradient of the leaf at ``path`` holds once it is summed over its
        group (the EP group for an expert leaf, the FSDP axes and the
        data-parallel axes they leave out for an FSDP leaf, the
        data-parallel axes for any other): the size of the axes of that
        group the "batch" rule does not split, whose ranks hold the same
        rows.  ``model`` counts only for an FSDP leaf every ``model`` rank
        uses whole (``fsdp_whole``): where each uses its heads or
        columns, the sum adds parts, not copies."""
        shape = mesh_shape(self.mesh)
        over = set(self.dp)
        if path in self.fsdp_axes and (path in self.fsdp_whole
                                       or "model" not in
                                       self.fsdp_kept[path]):
            over |= set(self.fsdp_kept[path])
        batch = set(batch_axes(self.mesh, self.rules))
        return math.prod(shape[a] for a in over if a not in batch)

    def gather_params(self, tree, prefix: str = "", drop: int = 0):
        """``tree``, the subtree at ``prefix`` of the parameters with
        ``drop`` leading dims indexed away (a superblock's slice of the
        stacked leaves: 1), with every FSDP leaf gathered whole over its
        FSDP group (:func:`fsdp_gather`: differentiable, collective, in
        path order)."""
        from repro_torch.models.common import tree_leaves, tree_with_leaves
        out = {}
        for p, t in tree_leaves(tree):
            path = f"{prefix}/{p}" if prefix else p
            dim = self.fsdp_axes.get(path)
            out[p] = t if dim is None else fsdp_gather(
                t, self.fsdp_comm(path), dim - drop)
        return tree_with_leaves(tree, out)

    # -- trees and leaves ---------------------------------------------------

    def shard_tree(self, tree):
        """This rank's tree from the global one (:meth:`local` per leaf)."""
        from repro_torch.models.common import tree_leaves, tree_with_leaves
        return tree_with_leaves(tree, {p: self.local(p, t)
                                       for p, t in tree_leaves(tree)})

    def gather_tree(self, tree):
        """The global tree from every rank's (:meth:`gather` per leaf, in
        path order on every rank: collective)."""
        from repro_torch.models.common import tree_leaves, tree_with_leaves
        return tree_with_leaves(tree, {p: self.gather(p, t)
                                       for p, t in tree_leaves(tree)})

    def gather_tree_to_writer(self, tree):
        """The global tree as host tensors on the writer rank, None on
        every other rank (:meth:`gather_to_writer` per leaf, in path
        order on every rank: collective)."""
        from repro_torch.models.common import tree_leaves, tree_with_leaves
        out = {p: self.gather_to_writer(p, t) for p, t in tree_leaves(tree)}
        return tree_with_leaves(tree, out) if self.writer else None

    def _slices(self, path: str) -> list[tuple]:
        """``(v, m, f, rank)`` for each distinct slice of a split leaf, in
        the global leaf's order: the EP virtual rank ``v`` whose experts
        it holds (None: not split over EP; with replicas only ``0 ..
        n_experts - 1``), its ``model`` coordinate ``m`` (None: not split
        over ``model``), its FSDP shard ``f`` (None: not split by FSDP;
        block ``f`` of the leaf's own kept axes, row-major), and the
        global rank that holds it (every other mesh coordinate 0, the
        writer's)."""
        shape = mesh_shape(self.mesh)
        ep = ep_axes(self.mesh) if path in self.axes and self.comm else ()
        vs = range(self.G if self.R == 1 else self.n_experts) if ep \
            else [None]
        ms = range(self.tp.size) if path in self.model_axes and self.tp \
            else [None]
        kept = self.fsdp_kept.get(path, ())
        fs = range(self.fsdp_comm(path).p) if kept else [None]
        out = []
        for v in vs:
            coord, rest = {}, v
            for a in ep:                   # fastest digit first
                coord[a], rest = rest % shape[a], rest // shape[a]
            for m in ms:
                if m is not None:
                    coord["model"] = m
                for f in fs:
                    rest = f
                    for a in reversed(kept if f is not None else ()):
                        coord[a], rest = rest % shape[a], rest // shape[a]
                    rank = int(self.mesh.mesh[tuple(
                        coord.get(a, 0) for a in self.mesh.mesh_dim_names)])
                    out.append((v, m, f, rank))
        return out

    def gather_to_writer(self, path: str, t):
        """The global leaf on the writer rank's host, None elsewhere.  A
        split leaf's slices travel one at a time (point to point over the
        mesh, from the rank that holds each distinct slice: see
        :meth:`_slices`) and each is copied into the host array as it
        arrives, so no rank holds the global leaf on its device; the
        other ranks keep nothing.  gloo sends from host memory, NCCL from
        the card."""
        if self.group is None or not self.split(path):
            return t.detach().to("cpu", copy=True).contiguous() \
                if self.writer else None
        slices = self._slices(path)
        dev = collective_device(self.group.pg)
        me = dist.get_rank()
        if not self.writer:
            if me in {rank for *_, rank in slices}:
                dist.send(t.detach().to(dev).contiguous(),
                          dst=self.group.members[0], group=self.group.pg)
            return None
        out = torch.empty(self.global_shape(path, t.shape), dtype=t.dtype)
        for v, m, f, rank in slices:
            piece, src = out, t.detach()
            if v is not None:
                piece = piece.narrow(self.axes[path], v * self.E_loc,
                                     self.E_loc)
            if f is not None:
                dim = self.fsdp_axes[path]
                piece = piece.narrow(dim, f * t.shape[dim], t.shape[dim])
            if rank != me:
                src = torch.empty(t.shape, dtype=t.dtype, device=dev)
                dist.recv(src, src=rank, group=self.group.pg)
            if m is not None:
                dim = self.model_axes[path]
                k = self.model_groups.get(path, 1)
                piece = model_block(piece, dim, k, m, self.tp.size)
                src = src.unflatten(dim, (k, -1))
            piece.copy_(src)
        return out

    def local(self, path: str, t):
        """This rank's slice of the global leaf ``t`` (a copy that owns
        its storage); a whole leaf as it is."""
        if not self.split(path):
            return t
        t = t.detach()
        axis = self.axes.get(path)
        if axis is not None:
            lo, n = expert_range(self.n_experts, self.mesh)
            t = t.narrow(axis, lo, n)
        dim = self.fsdp_axes.get(path)
        if dim is not None:
            comm = self.fsdp_comm(path)
            n = t.shape[dim] // comm.p
            t = t.narrow(dim, comm.rank * n, n)
        dim = self.model_axes.get(path)
        if dim is not None:
            t = model_block(t, dim, self.model_groups.get(path, 1),
                            tp_rank(self.tp), self.tp.size) \
                .flatten(dim, dim + 1)
        return t.clone()

    def global_shape(self, path: str, shape) -> tuple[int, ...]:
        shape = list(shape)
        axis = self.axes.get(path)
        if axis is not None:
            shape[axis] = self.n_experts
        dim = self.model_axes.get(path)
        if dim is not None:
            shape[dim] *= self.tp.size
        dim = self.fsdp_axes.get(path)
        if dim is not None:
            shape[dim] *= self.fsdp_comm(path).p
        return tuple(shape)

    def gather(self, path: str, t):
        """The global leaf from every rank's slice (collective over the
        leaf's FSDP group, the EP group, then ``model``; a whole leaf is
        returned as it is)."""
        dim = self.fsdp_axes.get(path)
        if dim is not None:
            t = fsdp_gather(t.detach(), self.fsdp_comm(path), dim)
        axis = self.axes.get(path)
        if axis is not None and self.comm is not None:
            parts = _direct_allgather_impl(t.detach().contiguous(),
                                           self.comm.fact)
            if self.R > 1:                 # virtual rank v < E holds v
                parts = parts[:self.n_experts]
            t = torch.cat(list(parts.unbind(0)), dim=axis)
        dim = self.model_axes.get(path)
        if dim is not None:
            t = model_join(tp_gather(t, self.tp, dim), dim,
                           self.model_groups.get(path, 1), self.tp.size)
        return t

    def sum_replicas(self, path: str, g):
        """With replicas (R > 1), each copy of an expert's leaf summed
        over the ranks that hold one (collective over the EP group): the
        pullback of the reference's ``jnp.tile``, which keeps the copies
        equal.  Without replicas ``g`` as it is."""
        if self.R == 1 or path not in self.axes:
            return g
        e = self.comm.rank % self.n_experts
        slots = torch.zeros((self.n_experts,) + tuple(g.shape),
                            dtype=g.dtype, device=g.device)
        slots[e] = g
        dist.all_reduce(slots, group=self.comm.fact.group.pg)
        return slots[e]

    def sum_partial(self, path: str, g):
        """A ``partial`` leaf's gradient summed over ``model`` (collective
        over the ``model`` group); any other leaf's as it is."""
        if path not in self.partial or self.tp is None:
            return g
        g = g.clone()
        dist.all_reduce(g, group=self.tp.pg)
        return g

    def sum_dp(self, path: str, g):
        """A leaf's gradient summed over the data-parallel axes it is not
        summed over yet (collective over them): an FSDP leaf's over those
        its kept axes leave out (the reduce-scatter of
        :func:`fsdp_gather`'s backward summed it over the kept ones), any
        other non-expert leaf's over every data-parallel axis; an expert
        leaf's (the dispatch's backward summed it over the EP group), or
        where nothing is left, as it is."""
        if path in self.axes and self.comm is not None:
            return g
        group = self._rest[self.fsdp_kept[path]] \
            if path in self.fsdp_axes else self.dp_group
        if group is None:
            return g
        g = g.clone()
        dist.all_reduce(g, group=group.pg)
        return g

    def leaf_sq_sum(self, path: str, sq):
        """The global leaf's sum of squares from this rank's ``sq`` (any
        shape, summed elementwise): over the leaf's FSDP group, the EP
        group (each global expert once, ``/ R``) and over ``model`` where
        the leaf is split (collective over those groups)."""
        if path in self.fsdp_axes:
            sq = sq.clone()
            dist.all_reduce(sq, group=self.fsdp_comm(path).fact.group.pg)
        if path in self.axes and self.comm is not None:
            sq = sq.clone()
            dist.all_reduce(sq, group=self.comm.fact.group.pg)
            sq = sq / self.R
        if path in self.model_axes and self.tp is not None:
            sq = sq.clone()
            dist.all_reduce(sq, group=self.tp.pg)
        return sq

    def tree_sq_sum(self, sqs: list):
        """The global tree's sum of squares from ``(path, this rank's
        square sum)`` pairs, each global element counted once: at most
        one all-reduce per FSDP group (its FSDP leaves), one over the EP
        group (the expert leaves, ``/ R``) and one over ``model`` (the
        split leaves), the same value on every rank."""
        zero = sqs[0][1].new_zeros(())
        whole, expert, tp_only, both = zero, zero, zero, zero
        fsdp = {kept: [zero, zero] for kept in self._fsdp}
        for path, sq in sqs:
            e, m = path in self.axes, path in self.model_axes
            if path in self.fsdp_axes:
                pair = fsdp[self.fsdp_kept[path]]
                pair[int(m)] = pair[int(m)] + sq
            elif e and m:
                both = both + sq
            elif e:
                expert = expert + sq
            elif m:
                tp_only = tp_only + sq
            else:
                whole = whole + sq
        for kept, (only, split) in fsdp.items():
            pair = torch.stack([only, split])
            dist.all_reduce(pair, group=self._fsdp[kept].fact.group.pg)
            whole, tp_only = whole + pair[0], tp_only + pair[1]
        if self.comm is not None:
            pair = torch.stack([expert, both])
            dist.all_reduce(pair, group=self.comm.fact.group.pg)
            expert, both = (pair / self.R).unbind(0)
        if self.tp is not None:
            pair = torch.stack([tp_only, both])
            dist.all_reduce(pair, group=self.tp.pg)
            tp_only, both = pair.unbind(0)
        return whole + expert + tp_only + both
