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
buffer split along dim 0 (it refuses a strided view).  So the buffer is
reordered at the round boundaries: round ``k``'s exchange needs its
messages packed, and what it receives is unpacked.  A d-round call makes
the passes :func:`round_schedule` lists: the pack of the first round, one
fused unpack-then-pack between two rounds, the unpack of the last, and
none whose row map is the identity (the last torus dimension's pack and
unpack always are), so d or d+1 passes instead of 2d.  They are the
derived-datatype kernel (``kernels.ops.pack_round`` / ``repack_round`` /
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

import contextlib
import functools

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.kernels.block_reorder import (is_identity, row_map,
                                               to_group_order,
                                               to_torus_order)

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


def _all_to_all(x, grp: PeerGroup):
    """``all_to_all_single`` over ``grp`` in its own rank order."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=grp.pg)
    return out


def exchange(x, grp: PeerGroup):
    """``all_to_all_single`` over ``grp``: chunk ``t`` of ``x``'s dim 0
    goes to torus member ``t``; chunk ``t`` of the result came from it.
    ``x`` must be contiguous; the result is a fresh buffer."""
    return to_torus_order(_all_to_all(to_group_order(x, grp.order), grp),
                          grp.order)


@functools.lru_cache(maxsize=256)
def round_schedule(dims: tuple[int, ...], order=None,
                   variant: Variant = "natural") -> tuple:
    """The reorder passes of one d-round call on the torus ``dims`` (its
    active dimensions, all of size > 1) with rounds in ``order``, as
    ``(k_unpack, k_pack)`` pairs in the order they run: the pack of
    ``order[0]`` (``(None, order[0])``), the fused unpack of ``order[i]``
    and pack of ``order[i + 1]``, the unpack of ``order[-1]``
    (``(order[-1], None)``), without every pass whose row map is the
    identity.  The last dimension's pack and unpack are, so a call makes
    d or d+1 passes (none on a one-dimensional torus)."""
    dims = tuple(dims)
    if any(s < 2 for s in dims):
        raise ValueError(f"round_schedule takes the active dims (size > 1), "
                         f"got {dims}")
    order = _check_order(order, len(dims))
    bounds = list(zip((None,) + order, order + (None,)))
    return tuple((ku, kp) for ku, kp in bounds
                 if not is_identity(row_map(dims, ku, kp, variant)))


def _reorder(buf, sizes, variant, ku, kp, groups, fused: bool):
    """The round boundary between the exchanges of round ``ku`` and round
    ``kp`` (``None``: the call's start or end).  A ``fused`` boundary is
    one pass of the kernel, with the groups' rank orders folded into its
    map; any other only puts the chunks into the next group's order."""
    recv = groups[ku] if ku is not None else None
    send = groups[kp] if kp is not None else None
    if not fused:
        if recv is not None:
            buf = to_torus_order(buf, recv.order)
        return buf if send is None else to_group_order(buf, send.order)
    kw = dict(variant=variant)
    if recv is not None:
        kw["recv_order"] = recv.order
    if send is not None:
        kw["send_order"] = send.order
    if ku is None:
        return kops.pack_round(buf, sizes, kp, **kw)
    if kp is None:
        return kops.unpack_round(buf, sizes, ku, **kw)
    return kops.repack_round(buf, sizes, ku, kp, **kw)


def _direct_impl(x, fact: TorusFactorization):
    """Baseline: one collective over the full (product) communicator."""
    _require_groups(fact)
    if fact.group is None:             # every dimension has size 1
        return x
    return exchange(x.contiguous(), fact.group)


def _active(fact: TorusFactorization, x):
    """The active dims' sizes and groups, after the argument checks."""
    _require_groups(fact)
    if x.shape[0] != fact.p:
        raise ValueError(f"leading dim {x.shape[0]} != prod(dims)={fact.p} "
                         f"({fact.dims})")
    _, sizes = _skip_trivial(fact.axis_names, fact.dims)
    return sizes, [g for g in fact.dim_groups if g is not None]


def _factorized_round_impl(x, fact: TorusFactorization, k: int, *,
                           variant: Variant = "natural"):
    """Exactly one dimension-wise round (active round index ``k``): pack,
    exchange over that dimension's group, unpack, each reorder skipped
    where its map is the identity.  Every round returns the buffer to the
    canonical ``(p, *block)`` layout, so composing rounds in any order is
    bit-identical to the fused d-round call."""
    sizes, groups = _active(fact, x)
    if not 0 <= k < len(sizes):
        raise ValueError(f"round index {k} outside 0..{len(sizes) - 1}")
    buf = x.reshape(fact.p, -1).contiguous()
    for ku, kp in ((None, k), (k, None)):
        fused = not is_identity(row_map(sizes, ku, kp, variant))
        buf = _reorder(buf, sizes, variant, ku, kp, groups, fused)
        if kp is not None:
            buf = _all_to_all(buf, groups[kp])
    return buf.reshape(x.shape)


def _factorized_impl(x, fact: TorusFactorization, *,
                     variant: Variant = "natural", round_order=None,
                     round_span=None):
    """d-round torus all-to-all of ``p`` blocks (Algorithm 1), with the
    reorder passes of :func:`round_schedule`.

    Args:
      x: local ``(p, *block)`` tensor; ``p`` = product of the torus dims.
      fact: the mesh-backed factorization (dims and communicators).
      variant: "natural" or "paper" (the order of the upper digits in
        each round's pack; both bit-identical).
      round_order: permutation of the active rounds; rounds commute, so
        any order is correct.
      round_span: optional ``(i, k) -> context manager`` around round
        ``i`` of the call (active round ``k``): its exchange, the reorder
        pass after it and, for round 0, the first pack.  The traced plan
        call (``core.plan``) times each round in it; the passes and
        exchanges are the same either way.
    Returns:
      ``(p, *block)``: ``out[i]`` = block received from torus rank ``i``.
    """
    if variant not in ("natural", "paper"):
        raise ValueError(f"unknown variant {variant!r}")
    sizes, groups = _active(fact, x)
    order = _check_order(round_order, len(sizes))
    passes = round_schedule(sizes, order, variant)
    bounds = list(zip((None,) + order, order + (None,)))

    def boundary(buf, j):
        ku, kp = bounds[j]
        return _reorder(buf, sizes, variant, ku, kp, groups,
                        (ku, kp) in passes)

    span = round_span or _no_span
    buf = x.reshape(fact.p, -1).contiguous()
    for i, k in enumerate(order):
        with span(i, k):
            if i == 0:
                buf = boundary(buf, 0)
            buf = _all_to_all(buf, groups[k])
            buf = boundary(buf, i + 1)
    return buf.reshape(x.shape)


_NO_SPAN = contextlib.nullcontext()


def _no_span(i, k):
    return _NO_SPAN


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
