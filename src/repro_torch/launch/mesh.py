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
the EP torus rebuilt over the survivors (``TorusComm.rebuild``), built by
the survivors alone.
"""

from __future__ import annotations

import math

from repro_torch.core.cache import cart_create, mesh_shape
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


def survivor_mesh(mesh, lost):
    """The training mesh over the ranks of ``mesh`` not in ``lost``: its
    EP torus (``pod`` / ``data``) rebuilt by ``TorusComm.rebuild``
    (``dims_create`` over the survivors, in ``mesh``'s torus order) with
    the other dims kept at 1.  Collective over the survivors only; a lost
    rank makes no call."""
    shape = mesh_shape(mesh)
    axes = ep_axes(mesh)
    if any(n > 1 for a, n in shape.items() if a not in axes):
        raise NotImplementedError(
            f"rebuilding the mesh {shape} after a device loss keeps only "
            f"its EP dims {axes}; every other dim must be 1")
    survivors = [r for r in mesh.mesh.flatten().tolist() if r not in lost]
    fresh = ep_comm(mesh).rebuild(survivors)
    size = dict(zip(fresh.axis_names, fresh.dims))
    names = tuple(reversed(mesh.mesh_dim_names))      # fastest digit first
    return cart_create(survivors, tuple(size.get(a, 1) for a in names),
                       names, device_type=mesh.device_type)
