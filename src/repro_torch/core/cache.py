"""Communicator factorization and caching on ``torch.distributed`` — the
paper's ``MPI_Cart_create`` + ``MPI_Cart_sub`` (Listings 1–2) over a
``DeviceMesh`` (port of ``repro.core.cache``).

* ``cart_create(ranks, dims, names)`` builds the Cartesian ``DeviceMesh``.
  ``dims[0]`` is the fastest digit, and ``DeviceMesh`` is row-major (its
  last dim fastest), so the mesh is built with ``reversed(dims)`` and
  ``reversed(names)``: the torus rank ``sum_i coords[names[i]] *
  sigma(i)`` is then the rank's position in the rank list.
* ``TorusFactorization`` is the cached descriptor (the paper's
  ``torusattr``).  Built from a mesh it also holds the communicators the
  collectives run on: one ``PeerGroup`` per torus dimension (this rank's
  coset along that dimension — ``MPI_Cart_sub``) and one over the whole
  torus (the direct algorithm's product communicator).  They are made
  once, when the descriptor is first looked up, so no all-to-all ever
  splits a communicator.
* Descriptors are cached in a bounded LRU keyed by (device fingerprint,
  dims, names, variant); the process groups under them in a second,
  unbounded cache keyed by the coset partition, so a descriptor rebuilt
  after ``free`` reuses its groups instead of creating new ones.

Group creation over a mesh that spans the world is collective: every rank
of the world must look up the same descriptors in the same order (SPMD
code does), including ranks that end up outside a group.  Cache keys are
computed alike on every rank, so a lookup hits or misses everywhere at
once.

A mesh over a strict subset of the world (the survivors of a device loss,
``TorusComm.rebuild``; a ``TorusComm.partition`` child) is built by its
members alone, so a rank that left makes no call: each member creates only
the groups it belongs to, with ``dist.new_group(ranks,
use_local_synchronization=True)`` (only the members enter it), and the
mesh is ``DeviceMesh.from_group`` over them (no group of its own); both
were checked on torch 2.13 (the gloo tests) and 2.11 (a card's gloo
world).  The members create their groups in the same
order (the mesh dims, then the multi-axis cosets as the descriptors ask),
each step a partition of the members, so no two ranks wait on each other
crosswise.  These groups are cached by their member set: a rebuilt mesh
never reuses a group that holds a rank outside it (a lost one), and a set
is never created twice (its store prefix is a hash of the members).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import telemetry
from .dims import dims_create
from .simulator import strides


class LRUCache:
    """Minimal bounded LRU mapping with hit/miss/eviction accounting.

    Shared by the factorization registry below and the ``A2APlan`` registry
    in ``core.plan``; eviction may run a callback (the paper's delete
    callback, Listing 2).
    """

    def __init__(self, capacity: int = 128,
                 on_evict: Callable | None = None):
        self.capacity = int(capacity)
        self.on_evict = on_evict
        self._data: OrderedDict = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return list(self._data.keys())

    def values(self):
        return list(self._data.values())

    def get(self, key):
        """Return the cached value (refreshing recency) or None; counts a
        hit or miss."""
        if key in self._data:
            self.stats["hits"] += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.stats["misses"] += 1
        return None

    def put(self, key, value):
        self._data[key] = value
        self._data.move_to_end(key)
        self._shrink()
        return value

    def pop(self, key):
        return self._data.pop(key, None)

    def clear(self):
        self._data.clear()

    def set_capacity(self, capacity: int):
        self.capacity = int(capacity)
        self._shrink()

    def _shrink(self):
        while len(self._data) > max(1, self.capacity):
            _, evicted = self._data.popitem(last=False)
            self.stats["evictions"] += 1
            if self.on_evict is not None:
                self.on_evict(evicted)


@dataclass(frozen=True)
class PeerGroup:
    """One communicator of the torus: the process group over this rank's
    coset, its members' global ranks in torus order, and — where the
    group's own rank order (ascending global rank) differs from the torus
    order — ``order[t]``, the group rank of torus member ``t``."""

    pg: object
    members: tuple[int, ...]
    order: tuple[int, ...] | None

    @property
    def size(self) -> int:
        return len(self.members)


@dataclass(frozen=True)
class TorusFactorization:
    """Cached factorization descriptor (the paper's ``torusattr``).

    Equality is the reference's (names, dims, variant, round order); the
    communicators of a mesh-backed descriptor ride along without taking
    part in it.
    """

    axis_names: tuple[str, ...]          # fastest digit first
    dims: tuple[int, ...]
    variant: str = "natural"
    round_order: tuple[int, ...] | None = None
    dim_groups: tuple = field(default=(), compare=False, repr=False)
    group: PeerGroup | None = field(default=None, compare=False, repr=False)
    coords: tuple[int, ...] | None = field(default=None, compare=False,
                                           repr=False)

    @property
    def d(self) -> int:
        return len(self.dims)

    @property
    def p(self) -> int:
        return math.prod(self.dims)

    @property
    def sigma(self) -> tuple[int, ...]:
        return strides(self.dims)

    @property
    def rank(self) -> int | None:
        """This process's torus rank (mesh-backed descriptors only)."""
        if self.coords is None:
            return None
        return sum(c * s for c, s in zip(self.coords, self.sigma))

    def blocks_sent_per_device(self) -> int:
        """Theorem 1: dp - sum_k p/D[k]."""
        return self.d * self.p - sum(self.p // Dk for Dk in self.dims)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{dim name: size}`` of a named ``DeviceMesh`` (JAX's
    ``Mesh.shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the torus needs a DeviceMesh with mesh_dim_names")
    return dict(zip(names, mesh.mesh.shape))


_MESHES: dict = {}


def cart_create(ranks, dims: tuple[int, ...],
                names: tuple[str, ...] | None = None, *,
                device_type: str | None = None) -> DeviceMesh:
    """``MPI_Cart_create``: a Cartesian ``DeviceMesh`` over the given ranks.

    ``ranks`` may be a sequence of global ranks, an existing
    ``DeviceMesh`` (its ranks are reused in flat order — the no-reorder
    case of Listing 1), or an int ``p`` (ranks ``0..p-1`` of the world).
    ``dims[0]`` is the fastest digit, so the mesh is built with ``dims``
    and ``names`` reversed.  ``device_type`` defaults to the mesh's, else
    ``"cuda"``.  Collective, like every ``DeviceMesh``: over the whole
    world every rank calls it, over a strict subset only the members do
    (the module docstring); meshes are cached, so calling it again with
    the same arguments creates no new groups.
    """
    if isinstance(ranks, DeviceMesh):
        device_type = device_type or ranks.device_type
        ranks = ranks.mesh.flatten().tolist()
    elif isinstance(ranks, int):
        ranks = list(range(ranks))
    else:
        ranks = [int(r) for r in ranks]
    device_type = device_type or "cuda"
    dims = tuple(int(s) for s in dims)
    p = math.prod(dims)
    if len(ranks) != p:
        raise ValueError(f"{len(ranks)} ranks != prod(dims) = {p}")
    if names is None:
        names = tuple(f"t{i}" for i in range(len(dims)))
    names = tuple(names)
    if len(names) != len(dims):
        raise ValueError("names/dims length mismatch")
    key = (tuple(ranks), dims, names, device_type)
    mesh = _MESHES.get(key)
    if mesh is None:
        arr = torch.tensor(ranks, dtype=torch.int).reshape(
            tuple(reversed(dims)))
        if _spans_world(ranks):
            mesh = DeviceMesh(device_type, arr,
                              mesh_dim_names=tuple(reversed(names)))
        else:
            mesh = _subset_mesh(arr, tuple(reversed(names)), device_type)
        _MESHES[key] = mesh
    return mesh


def _spans_world(ranks) -> bool:
    return not dist.is_initialized() \
        or len(set(ranks)) == dist.get_world_size()


def _subset_mesh(arr, dim_names, device_type) -> DeviceMesh:
    """A ``DeviceMesh`` over a strict subset of the world, built by its
    members alone (one group per mesh dim: this rank's coset)."""
    me = dist.get_rank()
    where = (arr == me).nonzero()
    if len(where) != 1:
        raise ValueError(f"rank {me} is not among the mesh's ranks "
                         f"{arr.flatten().tolist()}: a mesh over a subset "
                         "of the world is built by its members only")
    coord = where[0].tolist()
    groups = []
    for i in range(arr.dim()):
        line = arr[tuple(slice(None) if j == i else c
                         for j, c in enumerate(coord))]
        groups.append(_local_group(line.tolist()))
    return DeviceMesh.from_group(groups, device_type, mesh=arr,
                                 mesh_dim_names=dim_names)


# member set -> process group, for groups created by their members alone
_LOCAL_GROUPS: dict = {}


def _local_group(members):
    """The process group over ``members`` (this rank among them), created
    by the members only, once per member set."""
    key = tuple(sorted(int(r) for r in members))
    pg = _LOCAL_GROUPS.get(key)
    if pg is None:
        pg = _LOCAL_GROUPS[key] = dist.new_group(
            ranks=list(key), use_local_synchronization=True)
        _SPLIT_COUNTER["groups_created"] += 1
    return pg


_REGISTRY: LRUCache = LRUCache(capacity=128)
_SPLIT_COUNTER = {"cart_creates": 0, "lookups": 0, "groups_created": 0}
# coset partition -> this rank's PeerGroup in it (None when outside)
_GROUPS: dict = {}


def device_fingerprint(mesh: DeviceMesh) -> tuple:
    """Stable identity of the mesh's rank set: its global ranks in flat
    order, with the device type (the reference's ``(device.id,
    platform)`` pairs)."""
    return tuple((int(r), mesh.device_type)
                 for r in mesh.mesh.flatten().tolist())


def _cosets(mesh: DeviceMesh, axes: tuple[str, ...]) -> tuple:
    """The partition of the mesh's ranks into the groups that span
    ``axes``: each coset lists its global ranks in torus order
    (``axes[0]`` fastest)."""
    names = mesh.mesh_dim_names
    inner = [names.index(a) for a in reversed(axes)]
    outer = [i for i in range(len(names)) if i not in inner]
    arr = mesh.mesh.permute(outer + inner)
    arr = arr.reshape(-1, math.prod(arr.shape[len(outer):]))
    return tuple(tuple(int(r) for r in row) for row in arr.tolist())


def _peer_group(mesh: DeviceMesh, axes: tuple[str, ...]) -> PeerGroup:
    """This rank's communicator over ``axes`` (created collectively on
    first use; a single mesh dim reuses the ``DeviceMesh``'s own group)."""
    cosets = _cosets(mesh, axes)
    if cosets in _GROUPS:
        return _GROUPS[cosets]
    me = dist.get_rank()
    mine = next((c for c in cosets if me in c), None)
    if len(axes) == 1:
        pg = mesh.get_group(axes[0])
    elif not _spans_world(mesh.mesh.flatten().tolist()):
        pg = None if mine is None else _local_group(mine)
    else:
        pg = None
        for c in cosets:        # every rank creates every group, in order
            g = dist.new_group(ranks=list(c))
            if c is mine:
                pg = g
        _SPLIT_COUNTER["groups_created"] += len(cosets)
    grp = None
    if mine is not None:
        group_ranks = dist.get_process_group_ranks(pg)
        order = tuple(group_ranks.index(r) for r in mine)
        grp = PeerGroup(pg, mine,
                        None if order == tuple(range(len(mine))) else order)
    _GROUPS[cosets] = grp
    return grp


def _key(devices_fingerprint, dims, names, variant):
    return (devices_fingerprint, tuple(dims), tuple(names or ()), variant)


def _mesh_factorization(mesh, axis_names, dims, variant):
    """The descriptor with its communicators (collective)."""
    shape = mesh_shape(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    by_name = dict(zip(mesh.mesh_dim_names, coord))
    dim_groups = tuple(_peer_group(mesh, (a,)) if shape[a] > 1 else None
                       for a in axis_names)
    active = tuple(a for a in axis_names if shape[a] > 1)
    if len(active) == 1:
        group = dim_groups[axis_names.index(active[0])]
    else:
        group = _peer_group(mesh, active) if active else None
    return TorusFactorization(axis_names, dims, variant,
                              dim_groups=dim_groups, group=group,
                              coords=tuple(by_name[a] for a in axis_names))


def get_factorization(mesh: DeviceMesh, axis_names=None, *,
                      d: int | None = None,
                      variant: str = "natural") -> TorusFactorization:
    """Look up (or create and cache) the factorization descriptor.

    If ``axis_names`` is given, the mesh's existing dims are the torus
    dimensions (fastest digit first) and the descriptor holds their
    communicators.  Otherwise the *product* of all mesh dims is factorized
    into ``d`` balanced factors via ``dims_create`` — the caller should
    then build the Cartesian mesh with ``cart_create``.
    """
    bound = axis_names is not None
    if bound:
        axis_names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        shape = mesh_shape(mesh)
        missing = [a for a in axis_names if a not in shape]
        if missing:
            raise ValueError(f"axes {missing} not in mesh dims "
                             f"{tuple(shape)}")
        dims = tuple(shape[n] for n in axis_names)
    else:
        p = mesh.mesh.numel()
        if d is None:
            raise ValueError("need either axis_names or d")
        dims = tuple(reversed(dims_create(p, d)))  # fastest digit smallest
        axis_names = tuple(f"t{i}" for i in range(d))
    key = _key(device_fingerprint(mesh), dims, axis_names, variant)
    _SPLIT_COUNTER["lookups"] += 1
    hit = _REGISTRY.get(key)
    if hit is None:
        _SPLIT_COUNTER["cart_creates"] += 1
        fact = _mesh_factorization(mesh, axis_names, dims, variant) \
            if bound else TorusFactorization(axis_names, dims, variant)
        hit = _REGISTRY.put(key, fact)
    return hit


def free(descriptor: TorusFactorization) -> None:
    """The delete-callback analogue: evict all cache entries using it.
    (Its process groups stay, cached for the next descriptor over the
    same cosets.)"""
    dead = [k for k in _REGISTRY.keys() if _REGISTRY._data[k] == descriptor]
    for k in dead:
        _REGISTRY.pop(k)


def free_all() -> None:
    """Evict every cached factorization descriptor."""
    _REGISTRY.clear()


def set_cache_capacity(capacity: int) -> None:
    """Bound the factorization registry (evicting LRU entries if needed)."""
    _REGISTRY.set_capacity(capacity)


def cache_stats() -> dict[str, int]:
    out = dict(_SPLIT_COUNTER)
    out.update(_REGISTRY.stats)
    out["size"] = len(_REGISTRY)
    out["capacity"] = _REGISTRY.capacity
    return out


telemetry.register_stats_provider("factorization", cache_stats)
