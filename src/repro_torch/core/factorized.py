"""Factorized (torus) all-to-all — Algorithm 1 of the paper, on
``torch.distributed`` (port of ``repro.core.factorized``).

The kernels here (``_direct_impl``, ``_factorized_impl`` and their tiled
forms) run through ``core.plan.A2APlan``.  Each rank calls them on its own
``(p, *block)`` buffer; block ``i`` is destined for the rank with *torus
rank* ``i``, where

    rank = sum_i coords[axis_names[i]] * sigma(i),   sigma(i) = prod(D[:i])

i.e. ``axis_names[0]`` is the fastest-varying digit (Algorithm 1's
dimension 0).  The communicators come from the factorization descriptor
(``core.cache``): one process group per torus dimension and one over the
whole torus.

Where the reference lets ``lax.all_to_all`` split and concatenate any axis
of a block view in place, ``all_to_all_single`` takes one contiguous
buffer split along dim 0 (it refuses a strided view).  So round ``k`` is
pack → exchange over dimension ``k``'s group → unpack, the pack and unpack
being the derived-datatype kernel (``kernels.ops.pack_round`` /
``unpack_round``, CUDA on a card).  The two variants differ only in the
order of the upper digits inside a message:

* ``"natural"`` — the order ``movedim(pos(k), 0)`` gives on the
  ``reversed(dims)`` block view, which the reference exchanges in place;
* ``"paper"`` — the literal datatype order of Algorithm 1 (column-major
  over the unprocessed dimensions).

Inside a message any enumeration order cancels between the identical send
and receive traversals, so both variants are bit-identical to the direct
algorithm (the reference's argument, ``repro.core.factorized``).

Theorem 1 cost: round ``k`` moves ``(D[k]-1)/D[k]`` of the ``p`` blocks, so
the factorized algorithm sends ``d*p - sum_k p/D[k]`` blocks per rank vs.
``p - 1`` for the direct algorithm, in exchange for ``D[k]``-fold message
aggregation per round and dimension-local traffic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops

from .cache import PeerGroup, TorusFactorization

Variant = str  # "natural" | "paper"


def _as_tuple(axis_names) -> tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _skip_trivial(axis_names, dims):
    """Size-1 torus dimensions are no-op rounds; drop them."""
    kept = [(n, s) for n, s in zip(axis_names, dims) if s > 1]
    if not kept:
        return (), ()
    names, sizes = zip(*kept)
    return tuple(names), tuple(sizes)


def _check_order(order, d):
    order = tuple(order) if order is not None else tuple(range(d))
    if sorted(order) != list(range(d)):
        raise ValueError(f"round_order {order} is not a permutation of "
                         f"0..{d-1}")
    return order


def _require_groups(fact: TorusFactorization) -> None:
    if fact.coords is None:
        raise ValueError(
            f"the torus {fact.dims} over {fact.axis_names} has no process "
            "groups: build the plan or comm from a DeviceMesh to run it")


def exchange(x, grp: PeerGroup):
    """``all_to_all_single`` over ``grp``: chunk ``t`` of ``x``'s dim 0
    goes to torus member ``t``; chunk ``t`` of the result came from it.
    ``x`` must be contiguous; the result is a fresh buffer."""
    n = grp.size
    if grp.order is not None:          # group ranks != torus order
        order = torch.tensor(grp.order, device=x.device)
        x = x.reshape(n, -1)[torch.argsort(order)].reshape(x.shape)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=grp.pg)
    if grp.order is not None:
        out = out.reshape(n, -1)[order].reshape(x.shape)
    return out


def _direct_impl(x, fact: TorusFactorization):
    """Baseline: one collective over the full (product) communicator."""
    _require_groups(fact)
    if fact.group is None:             # every dimension has size 1
        return x
    return exchange(x.contiguous(), fact.group)


def _factorized_round_impl(x, fact: TorusFactorization, k: int, *,
                           variant: Variant = "natural"):
    """Exactly one dimension-wise round (active round index ``k``): pack,
    exchange over that dimension's group, unpack.  Every round returns
    the buffer to the canonical ``(p, *block)`` layout, so composing
    rounds in any order is bit-identical to the fused d-round call."""
    _require_groups(fact)
    p = fact.p
    if x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != prod(dims)={p} "
                         f"({fact.dims})")
    active = [i for i, s in enumerate(fact.dims) if s > 1]
    if not 0 <= k < len(active):
        raise ValueError(f"round index {k} outside 0..{len(active) - 1}")
    sizes = tuple(fact.dims[i] for i in active)
    flat = x.reshape(p, -1)
    packed = kops.pack_round(flat.contiguous(), sizes, k, variant=variant)
    recv = exchange(packed, fact.dim_groups[active[k]])
    return kops.unpack_round(recv, sizes, k, variant=variant) \
        .reshape(x.shape)


def _factorized_impl(x, fact: TorusFactorization, *,
                     variant: Variant = "natural", round_order=None):
    """d-round torus all-to-all of ``p`` blocks (Algorithm 1).

    Args:
      x: local ``(p, *block)`` tensor; ``p`` = product of the torus dims.
      fact: the mesh-backed factorization (dims and communicators).
      variant: "natural" or "paper" (the order of the upper digits in
        each round's pack; both bit-identical).
      round_order: permutation of the active rounds; rounds commute, so
        any order is correct.
    Returns:
      ``(p, *block)``: ``out[i]`` = block received from torus rank ``i``.
    """
    if variant not in ("natural", "paper"):
        raise ValueError(f"unknown variant {variant!r}")
    _, sizes = _skip_trivial(fact.axis_names, fact.dims)
    order = _check_order(round_order, len(sizes))
    for k in order:
        x = _factorized_round_impl(x, fact, k, variant=variant)
    return x


def _tiled(x, fact, split_axis, concat_axis, run):
    """Tiled semantics around a blockwise all-to-all ``run``: split
    ``split_axis`` into ``p`` chunks (chunk ``t`` -> torus rank ``t``) and
    concatenate the received chunks source-major along ``concat_axis``."""
    p = fact.p
    if p == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    S = x.shape[split_axis]
    if S % p:
        raise ValueError(f"split axis size {S} not divisible by p={p}")
    shape = x.shape
    xb = x.reshape(shape[:split_axis] + (p, S // p) + shape[split_axis + 1:])
    out = run(xb.movedim(split_axis, 0).contiguous())
    out = out.movedim(0, concat_axis)
    sh = out.shape
    return out.reshape(sh[:concat_axis]
                       + (sh[concat_axis] * sh[concat_axis + 1],)
                       + sh[concat_axis + 2:])


def _factorized_tiled_impl(x, fact: TorusFactorization, split_axis: int,
                           concat_axis: int, *, variant: Variant = "natural",
                           round_order=None):
    """Tiled-semantics factorized all-to-all (the MoE-dispatch and
    Ulysses re-shard form), decomposed into the d per-dimension rounds.
    ``x.shape[split_axis]`` must be divisible by p."""
    return _tiled(x, fact, split_axis, concat_axis,
                  lambda xb: _factorized_impl(xb, fact, variant=variant,
                                              round_order=round_order))


def _direct_tiled_impl(x, fact: TorusFactorization, split_axis: int,
                       concat_axis: int):
    """Direct tiled collective over the product communicator."""
    return _tiled(x, fact, split_axis, concat_axis,
                  lambda xb: _direct_impl(xb, fact))
