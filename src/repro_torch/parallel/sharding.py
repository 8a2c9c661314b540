"""Logical-axis sharding rules and the layout of the sharded training
state (port of the part of ``repro.parallel.sharding`` the port needs).

The reference maps logical tensor axes ("batch", "expert", ...) to
physical mesh axes and lets GSPMD shard arrays by them.  The port runs
SPMD by hand: each rank already holds its shard, so what is needed is the
mapping and the few collectives GSPMD would insert:

* the "batch" rule's split (:func:`batch_axes`, :func:`batch_split`,
  :func:`batch_group`): rank order ``P(("pod", "data"))``, row block
  ``pod * |data| + data``, which is also the EP virtual rank;
* the expert-parallel group (:func:`ep_axes`, :func:`ep_geometry`);
* :class:`ExpertSharding`, the counterpart of ``param_shardings`` for a
  tree: which leaves a rank holds as its slice of the expert dim
  (logical ``"expert"``, split over the EP group), every other leaf
  whole, and the collectives that move between the two;
* :func:`all_reduce_sum`, an all-reduce autograd differentiates (the
  reference's ``pmean`` inside a differentiated ``shard_map``).

``resolve_spec``, ``constrain`` and ``use_mesh`` have no counterpart;
the FSDP rules (``fsdp``, ``embed_fsdp``) and the ``model`` axis are
not applied (ROADMAP.md).
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
    """EP all-to-all axes, fastest digit first (owner axis, then replicas).

    The virtual-expert rank is ``data_coord + |data| * pod_coord``: experts
    are owned along "data" and replicated across "pod", so the multi-pod
    dispatch is a d=2 factorized all-to-all (the "data" round, then the
    "pod" round)."""
    names = mesh.mesh_dim_names or ()
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


def check_ep_within_batch(mesh, rules: ShardingRules | None = None) -> None:
    """Training needs every EP axis to split the batch: over an axis that
    did not, each expert would see one token from several ranks and count
    its gradient more than once."""
    shape = mesh_shape(mesh)
    extra = [a for a in ep_axes(mesh)
             if shape[a] > 1 and a not in batch_axes(mesh, rules)]
    if extra:
        raise NotImplementedError(
            f"training with the EP axes {extra} outside the batch rule "
            f"{batch_axes(mesh, rules)} is not supported: every EP axis "
            f"must split the batch")


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


# ---------------------------------------------------------------------------
# The layout of a sharded tree
# ---------------------------------------------------------------------------


class ExpertSharding:
    """How this rank holds a tree on ``mesh``: ``axes`` maps the path of
    each leaf split over the EP group to the index of its expert dim
    (``n_experts`` long globally, ``E_loc`` here); every other leaf is
    whole on every rank.  Built by ``models.common.param_shardings``;
    :meth:`prefixed` and :meth:`merged` carry it to trees that hold the
    parameters' shapes (the AdamW moments, a trainer's state)."""

    def __init__(self, axes: dict, n_experts: int, mesh):
        self.axes = dict(axes)
        self.n_experts = n_experts
        self.mesh = mesh
        _, self.G, self.E_loc, self.R = ep_geometry(n_experts, mesh)
        self.comm = ep_comm(mesh) if self.axes else None
        self.group = mesh_group(mesh)

    @property
    def writer(self) -> bool:
        """Whether this rank writes what holds global arrays (the rank at
        mesh coordinate 0)."""
        return self.group is None or dist.get_rank() == self.group.members[0]

    def prefixed(self, prefix: str) -> "ExpertSharding":
        return ExpertSharding({f"{prefix}/{p}": a
                               for p, a in self.axes.items()},
                              self.n_experts, self.mesh)

    def merged(self, *others) -> "ExpertSharding":
        axes = dict(self.axes)
        for o in others:
            axes.update(o.axes)
        return ExpertSharding(axes, self.n_experts, self.mesh)

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

    def gather_to_writer(self, path: str, t):
        """The global leaf on the writer rank's host, None elsewhere.  An
        expert leaf's slices travel one at a time (point to point, from
        the ranks of the writer's EP group that hold a distinct expert
        slice: with replicas, virtual ranks ``0 .. n_experts - 1``) and
        each is copied into the host array as it arrives, so no rank
        holds the global leaf on its device; the other ranks keep
        nothing.  gloo sends from host memory, NCCL from the card."""
        ep = None if self.comm is None else self.comm.fact.group
        if not self.writer:
            if path in self.axes and ep is not None:
                self._send_slice(t)
            return None
        axis = self.axes.get(path)
        if axis is None or ep is None:
            return t.detach().to("cpu", copy=True).contiguous()
        out = torch.empty(self.global_shape(path, t.shape), dtype=t.dtype)
        dev = collective_device(ep.pg)
        for v in range(self.G if self.R == 1 else self.n_experts):
            piece = out.narrow(axis, v * self.E_loc, self.E_loc)
            if ep.members[v] == dist.get_rank():
                piece.copy_(t.detach())
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, device=dev)
            dist.recv(buf, src=ep.members[v], group=ep.pg)
            piece.copy_(buf)
        return out

    def _send_slice(self, t) -> None:
        """A non-writer's part in :meth:`gather_to_writer`: its slice to
        the writer, if the writer's EP group is its own and no lower
        virtual rank holds the same expert."""
        group = self.comm.fact.group
        writer = self.group.members[0]
        if writer not in group.members or self.comm.rank >= (
                self.G if self.R == 1 else self.n_experts):
            return
        dev = collective_device(group.pg)
        dist.send(t.detach().to(dev).contiguous(), dst=writer, group=group.pg)

    def local(self, path: str, t):
        """This rank's slice of the global leaf ``t`` (a copy that owns
        its storage); a whole leaf as it is."""
        axis = self.axes.get(path)
        if axis is None:
            return t
        lo, n = expert_range(self.n_experts, self.mesh)
        return t.detach().narrow(axis, lo, n).clone()

    def global_shape(self, path: str, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        axis = self.axes.get(path)
        if axis is None:
            return shape
        return shape[:axis] + (self.n_experts,) + shape[axis + 1:]

    def gather(self, path: str, t):
        """The global leaf from every rank's slice (collective over the EP
        group; a whole leaf is returned as it is, without one)."""
        axis = self.axes.get(path)
        if axis is None or self.comm is None:
            return t
        parts = _direct_allgather_impl(t.detach().contiguous(),
                                       self.comm.fact)
        if self.R > 1:                     # virtual rank v < E holds v
            parts = parts[:self.n_experts]
        return torch.cat(list(parts.unbind(0)), dim=axis)

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

    def expert_sq_sum(self, sq):
        """The sum over the EP group of this rank's sum of squares of its
        expert leaves, each global expert counted once (``/ R``)."""
        if self.comm is None or self.comm.fact.group is None:
            return sq
        sq = sq.clone()
        dist.all_reduce(sq, group=self.comm.fact.group.pg)
        return sq / self.R
