"""Mesh factories (port of ``repro.launch.mesh``): the reference's
production and debug meshes as ``DeviceMesh`` es of the world's ranks.

The shapes are the reference's, most significant dim first: production
``(pod=2, data=16, model=16)`` (``(data=16, model=16)`` on one pod), debug
``(pod=2, data=2, model=4)`` (``(data=2, model=4)``).  Building one is
collective and needs a process group of exactly that many ranks;
importing this module touches no device.  The port trains and serves on
each of them: experts and the batch over ``pod`` / ``data``, tensor
parallelism or, with ``use_ulysses``, sequence parallelism over
``model``.  :func:`check_trainable` refuses a configuration whose query
heads or sequences Ulysses cannot share out over ``model``, or whose
mLSTM heads tensor parallelism cannot (xlstm-1.3b's 4 heads on ``model``
= 8).
:func:`survivor_mesh` is the elastic trainer's mesh after a device loss:
every non-EP dim kept, the EP torus rebuilt over the EP coordinates whose
whole group survives (the rank arithmetic in :func:`survivor_layout`),
built by the survivors alone.
"""

from __future__ import annotations

import itertools
import math

from repro_torch.core.cache import cart_create, mesh_shape
from repro_torch.core.dims import dims_create
from repro_torch.parallel.sharding import ep_axes, ep_comm
from repro_torch.parallel.ulysses import check_lengths


def production_shape(*, multi_pod: bool = False) -> dict[str, int]:
    return {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}


def debug_shape(*, multi_pod: bool = False) -> dict[str, int]:
    return {"pod": 2, "data": 2, "model": 4} if multi_pod \
        else {"data": 2, "model": 4}


def make_mesh(shape: dict[str, int], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` over ranks ``0 .. prod(shape) - 1`` with the dims
    of ``shape`` in its order, most significant first (``jax.make_mesh``'s
    convention)."""
    names = tuple(shape)
    return cart_create(math.prod(shape.values()),
                       tuple(shape[a] for a in reversed(names)),
                       tuple(reversed(names)), device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(production_shape(multi_pod=multi_pod),
                     device_type=device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Reduced mesh of the same axis structure (8 or 16 ranks)."""
    return make_mesh(debug_shape(multi_pod=multi_pod),
                     device_type=device_type)


def check_trainable(mesh_or_shape, cfg=None, seq: int | None = None) -> None:
    """Raise before anything is built unless the port trains ``cfg`` on
    this mesh (or ``{dim: size}``) at ``seq`` text tokens a row (None:
    the checks that need no length): Ulysses sequence parallelism
    (``cfg.use_ulysses``) gives each ``model`` rank ``n_heads / |model|``
    query heads over the whole sequence and ``1 / |model|`` of its
    positions, so the query heads must divide ``model`` (the reference's
    ``ulysses_attention`` raises the same at its first call), and so
    must each sequence it splits: the text, after a frontend's F tokens
    (F + S), and the encoder-decoder's frames and decoder tokens apart.
    The mLSTM's heads must divide ``model`` too."""
    shape = mesh_or_shape if isinstance(mesh_or_shape, dict) \
        else mesh_shape(mesh_or_shape)
    if cfg is None:
        return
    F = cfg.n_frontend_tokens if cfg.frontend is not None else 0
    lengths = {}
    if cfg.encoder_layers:
        lengths["the frame count"] = F
        if seq is not None:
            lengths["the decoder tokens S"] = seq
    elif seq is not None:
        lengths[f"F + S = {F} + {seq}" if F else "the sequence S"] = F + seq
    check_lengths(cfg, shape, lengths)
    if any(m == "mlstm" for m, _ in cfg.superblock):
        from repro_torch.models.xlstm import check_mlstm_heads
        check_mlstm_heads(cfg, shape)


def survivor_layout(shape: dict[str, int], ranks, lost,
                    n_experts: int | None = None):
    """The rank arithmetic of :func:`survivor_mesh`, on no world.
    ``shape`` is the mesh's ``{dim: size}``, most significant first (a
    ``DeviceMesh``'s order), ``ranks`` its ranks in that row-major order
    (flat), ``lost`` the ranks a device loss took.  An EP coordinate (a
    value of the ``data`` / ``pod`` dims) survives where every rank that
    shares it does: its whole group over the other dims.  Returns
    ``(survivors, dims, leaving)``: the survivors' ranks in the new
    mesh's row-major order, its ``{dim: size}`` (every non-EP dim at its
    size, the EP dims a ``dims_create`` factorization of the surviving
    EP coordinates, the largest factor on the fastest EP dim), and the
    ranks that leave: the lost ones and their partners in a broken group.
    With ``n_experts``, an EP extent the experts cannot be spread over
    (neither divides the other) is a ``ValueError`` naming it."""
    names = tuple(shape)
    ep = ep_axes(shape)                                # fastest first
    rest = tuple(a for a in names if a not in ep)
    ranks = [int(r) for r in ranks]
    lost = {int(r) for r in lost}
    strides, acc = {}, 1
    for a in reversed(names):
        strides[a], acc = acc, acc * shape[a]
    at = lambda coord: ranks[sum(coord[a] * strides[a] for a in names)]
    rest_coords = [dict(zip(rest, c)) for c in itertools.product(
        *(range(shape[a]) for a in rest))]
    # EP coordinates in the old torus order (its fastest dim first)
    whole = []
    for c in itertools.product(*(range(shape[a]) for a in reversed(ep))):
        coord = dict(zip(reversed(ep), c))
        group = [at({**coord, **r}) for r in rest_coords]
        if not lost & set(group):
            whole.append(coord)
    if not whole:
        raise ValueError(f"no EP coordinate of the mesh {shape} keeps its "
                         f"whole group after losing {sorted(lost)}")
    k = len(whole)
    if n_experts is not None and n_experts % k and k % n_experts:
        raise ValueError(
            f"the surviving EP extent {k} (of the mesh {shape} after "
            f"losing {sorted(lost)}) cannot hold {n_experts} experts: "
            f"neither divides the other")
    dims = dict(zip(ep, dims_create(k, len(ep)))) if ep else {}
    new = {a: dims.get(a, shape[a]) for a in names}
    survivors = []
    for c in itertools.product(*(range(new[a]) for a in names)):
        coord = dict(zip(names, c))
        v, scale = 0, 1
        for a in ep:                                   # fastest digit first
            v, scale = v + coord[a] * scale, scale * new[a]
        survivors.append(at({**{a: coord[a] for a in rest}, **whole[v]}))
    leaving = sorted(set(ranks) - set(survivors))
    return survivors, new, leaving


def survivor_mesh(mesh, lost, n_experts: int | None = None):
    """The training mesh over the ranks of ``mesh`` that survive the loss
    of ``lost`` (:func:`survivor_layout`): every non-EP dim kept at its
    size and the EP torus rebuilt over the EP coordinates whose whole
    group survives; a survivor whose group a loss broke leaves with the
    lost ranks (the trainer's ``run`` returns ``"lost"`` on it).  The EP
    communicator of this rank's group is rebuilt over its survivors
    (``TorusComm.rebuild``: its plans freed, its tuning migrated), then
    the mesh is built by the survivors alone: collective over them, a
    rank that leaves makes no call.  With ``n_experts``, an EP extent
    the experts cannot be spread over is refused first."""
    survivors, new, _ = survivor_layout(
        mesh_shape(mesh), mesh.mesh.flatten().tolist(), lost, n_experts)
    comm = ep_comm(mesh)
    if comm is not None:
        group = set(comm.fact.group.members)
        comm.rebuild([r for r in survivors if r in group])
    names = tuple(reversed(mesh.mesh_dim_names))      # fastest digit first
    return cart_create(survivors, tuple(new[a] for a in names), names,
                       device_type=mesh.device_type)
