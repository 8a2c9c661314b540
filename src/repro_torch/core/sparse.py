"""Sparse neighborhood Alltoallv on the factorized torus (port of
``repro.core.sparse``).

``core.ragged`` runs every dimension-wise round densely: each rank
exchanges a padded bucket window with all ``D[k] - 1`` group peers even
when the count matrix is mostly empty.  Since the rounds move fixed slot
sets, the per-round neighborhood of non-empty exchanges follows from the
initial ``p x p`` count matrix, which every rank holds after the counts
phase (Träff et al.'s message-combining sparse collectives):

* **message masks** (:func:`round_message_masks`) — plan-time slot
  tracking: for each round and peer offset ``delta``, the ``(p, p)`` mask
  of original count-matrix cells that some rank's message on that lane
  carries.  A lane is empty, and skipped by every rank, iff no masked
  cell is non-zero.

* **bucketed sparse rounds** (``_sparse_rounds_impl``) — each round is
  the dense round's pack (the block-reorder kernel, ``round_schedule``'s
  passes), then its ``D[k] - 1`` peer lanes, then the unpack.  Lane
  ``delta`` sends the packed message of the ``+delta`` group peer and
  receives the ``-delta`` peer's, as one ``all_to_all_single`` over the
  round's group whose split sizes are non-zero for those two peers only
  (gloo's point-to-point calls take CPU tensors alone).  The lane's
  predicate is read from the *replicated* matrix, so every rank of the
  group takes the same branch (a rank that skipped alone would leave its
  peers waiting in the collective).  All predicates of a call are read to
  the host at once, the one host sync of a sparse call.  A skipped lane
  leaves zeros (the output is zeroed per round), which is exact because
  it carries only zero-count pairs' padding.

* **exact sparse** (:func:`sparse_exact_alltoallv`) — the host path at
  per-(sender, peer) message granularity; an all-empty message is elided
  and counted as skipped.

Under autograd the bucketed rounds are one :class:`_SparseRoundsFn`:
its backward runs the same sparse rounds on the cotangent in the other
direction, with the lanes of the transposed count matrix (what a reverse
call with this call's receive counts would read), so every counted
row's gradient travels back; the counts are integers and have none.

Contract: receivers may rely only on ``recv[i, :recv_counts[i]]``; rows
beyond the count are unspecified (zeros where the carrying exchange was
skipped, the sender's padding otherwise).  Under non-zero counts nothing
is skipped and the result is the dense ragged path's, padding included.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .factorized import _active, _reorder, round_schedule
from .ragged import (_counts_matrix_impl, _pad_to_bucket,
                     _recv_counts_from_matrix, torus_rank)
from .simulator import (SparseVolumeCount, rank_to_coords, round_datatype,
                        simulate_sparse_alltoallv)


# ---------------------------------------------------------------------------
# Plan-time neighborhood analysis
# ---------------------------------------------------------------------------


def round_message_masks(dims, round_order=None):
    """Symbolic slot tracking -> per-(round, delta) count-matrix masks.

    Args:
      dims: *active* torus factors (all > 1), fastest digit first.
      round_order: executed permutation of ``range(d)``.

    Returns a list aligned with the executed order; entry ``e`` is a
    boolean ``(dims[order[e]] - 1, p, p)`` array whose ``[delta - 1]``
    slice marks every original ``(src, dst)`` cell carried by some rank's
    message to its ``+delta`` group peer in that round.
    ``matrix[mask[delta - 1]].sum() == 0`` iff every such message is
    empty — the skip predicate of that lane.
    """
    dims = tuple(int(s) for s in dims)
    if any(s < 2 for s in dims):
        raise ValueError(f"dims must be active factors (all > 1), "
                         f"got {dims} — drop trivial axes first")
    d = len(dims)
    p = math.prod(dims)
    order = tuple(round_order) if round_order is not None \
        else tuple(range(d))
    if sorted(order) != list(range(d)):
        raise ValueError(f"round_order {order} is not a permutation "
                         f"of 0..{d - 1}")

    # owner[r][b] = the original (src, dst) pair whose payload sits in
    # slot b of rank r's buffer; movement mirrors the simulator.
    owner = {r: [(r, b) for b in range(p)] for r in range(p)}
    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    out = []
    for k in order:
        positions, extent = round_datatype(dims, k)
        Dk = dims[k]
        masks = np.zeros((Dk - 1, p, p), dtype=bool)
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(c for i, c in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        staged = {}
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])
            for g_r, r in enumerate(members):
                newbuf = [None] * p
                for g_s, s in enumerate(members):
                    if g_s != g_r:
                        delta = (g_r - g_s) % Dk
                        for pos in positions:
                            src, dst = owner[s][pos + g_r * extent]
                            masks[delta - 1, src, dst] = True
                    for pos in positions:
                        newbuf[pos + g_s * extent] = \
                            owner[s][pos + g_r * extent]
                staged[r] = newbuf
        for r, newbuf in staged.items():
            owner[r] = newbuf
        out.append(masks)
    return out


def sparse_traffic_stats(dims, counts, round_order=None) -> dict:
    """Host-side traffic analysis of a concrete count matrix through the
    simulator's sparse oracle: density (non-zero fraction of the count
    matrix), per-message skip accounting, and the number of whole rounds
    whose every exchange was empty."""
    counts = np.asarray(counts, dtype=np.int64)
    p = math.prod(tuple(int(s) for s in dims))
    _, vol = simulate_sparse_alltoallv(tuple(dims), counts.tolist(),
                                       round_order)
    nnz = int(np.count_nonzero(counts))
    return {
        "density": nnz / float(p * p),
        "total_exchanges": vol.total_exchanges,
        "skipped_exchanges": vol.skipped_exchanges,
        "combined_messages": vol.combined_messages,
        "skipped_rounds": vol.skipped_rounds,
        "skip_fraction": vol.skip_fraction,
        "elements_sent": vol.total_elements_sent,
    }


# ---------------------------------------------------------------------------
# Bucketed execution mode
# ---------------------------------------------------------------------------


def _lane(packed, out, grp, me: int, delta: int) -> None:
    """One peer lane of a round: this rank's packed message for the group
    member ``delta`` places ahead goes there, the one from ``delta``
    places behind lands in ``out``.  ``packed`` / ``out`` hold one
    message per group rank (the packs fold the group's rank order in)."""
    n = grp.size
    m = packed.shape[0] // n
    rank_of = grp.order or range(n)
    dst, src = rank_of[(me + delta) % n], rank_of[(me - delta) % n]
    dist.all_to_all_single(
        out[src * m:(src + 1) * m], packed[dst * m:(dst + 1) * m],
        output_split_sizes=[m if g == src else 0 for g in range(n)],
        input_split_sizes=[m if g == dst else 0 for g in range(n)],
        group=grp.pg)


def _sparse_rounds_impl(x, lanes, *, fact, order, variant):
    """The sparse rounds on bucket-padded windows.

    Each round's boundary reorders are the dense round's
    (``round_schedule``, the block-reorder kernel on a card); between
    them the round's ``D[k] - 1`` lanes run where ``lanes`` (a flat list
    of booleans, round by round in ``order``, delta by delta) says a lane
    carries something, and the rank's own message is copied.
    """
    sizes, groups = _active(fact, x)
    if not sizes:
        return x
    passes = round_schedule(sizes, order, variant)
    me = dist.get_rank()
    buf = x.reshape(fact.p, -1).contiguous()
    flags = iter(lanes)
    for ku, kp in zip((None,) + order, order + (None,)):
        buf = _reorder(buf, sizes, variant, ku, kp, groups,
                       (ku, kp) in passes)
        if kp is None:
            break
        grp = groups[kp]
        digit = grp.members.index(me)
        m = fact.p // grp.size
        g = (grp.order or range(grp.size))[digit]
        out = torch.zeros_like(buf)
        out[g * m:(g + 1) * m] = buf[g * m:(g + 1) * m]
        for delta in range(1, grp.size):
            if next(flags):
                _lane(buf, out, grp, digit, delta)
        buf = out
    return buf.reshape(x.shape)


def _lanes(matrix, masks):
    """The lane flags of one call: a lane runs iff a pair it carries has
    a non-zero count (one host read of the replicated matrix)."""
    return ((matrix > 0) & masks).flatten(1).any(1).tolist()


class _SparseRoundsFn(torch.autograd.Function):
    """The sparse rounds of one call under autograd: the backward is the
    same rounds in the other direction on the cotangent, with the lanes
    of the transposed count matrix."""

    @staticmethod
    def forward(ctx, x, lanes, adjoint_lanes, plan, order, adjoint_order):
        ctx.args = (adjoint_lanes, plan, adjoint_order)
        return _sparse_rounds_impl(x, lanes, fact=plan.fact, order=order,
                                   variant=plan.variant)

    @staticmethod
    def backward(ctx, g):
        lanes, plan, order = ctx.args
        return (_sparse_rounds_impl(g.contiguous(), lanes, fact=plan.fact,
                                    order=order, variant=plan.variant),
                None, None, None, None, None)


def _sparse_bucketed_impl(x, send_counts, *, plan, reverse: bool = False):
    """Fixed-shape sparse all-to-all: counts phase + skippable rounds.
    ``ragged._bucketed_impl``'s signature and result (``(recv,
    recv_counts)``), with rows beyond ``recv_counts[i]`` unspecified."""
    from repro_torch.kernels.ops import _trains
    p = plan.p
    if x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != p={p}")
    counts = torch.as_tensor(send_counts, dtype=torch.int32,
                             device=x.device)
    matrix = _counts_matrix_impl(counts, plan.counts_plan)
    recv_counts = _recv_counts_from_matrix(matrix, torus_rank(plan.fact))
    padded = _pad_to_bucket(x, plan.bucket)
    # one host read per call: every rank reads the same replicated matrix
    lanes = _lanes(matrix, plan.lane_masks(reverse, matrix.device))
    order = plan.reverse_round_order if reverse else plan.round_order
    if _trains(padded):
        adjoint = plan.round_order if reverse else plan.reverse_round_order
        adjoint_lanes = _lanes(matrix.t(),
                               plan.lane_masks(not reverse, matrix.device))
        out = _SparseRoundsFn.apply(padded, lanes, adjoint_lanes, plan,
                                    order, adjoint)
    else:
        out = _sparse_rounds_impl(padded, lanes, fact=plan.fact,
                                  order=order, variant=plan.variant)
    return out, recv_counts


# ---------------------------------------------------------------------------
# Exact sparse mode (host path)
# ---------------------------------------------------------------------------


def sparse_exact_alltoallv(rows, dims, round_order=None):
    """Exact sparse Alltoallv over the torus — host path.

    The payloads of ``ragged.exact_alltoallv`` (``recv[r][s]`` is what
    ``s`` addressed to ``r``), but each round's send schedule holds only
    the non-empty composite messages: a message whose slots all carry
    zero rows is elided and counted, per (sender, peer).  Its slots reach
    the receiver as the zero-length payloads the count matrix promised.

    Returns ``(recv, counts, vol)`` with ``vol`` a
    :class:`~repro_torch.core.simulator.SparseVolumeCount`.
    """
    dims = tuple(int(s) for s in dims)
    d = len(dims)
    p = math.prod(dims)
    if len(rows) != p or any(len(per_dst) != p for per_dst in rows):
        raise ValueError(f"rows must be a {p}x{p} nested list")
    order = tuple(round_order) if round_order is not None \
        else tuple(range(d))
    if sorted(order) != list(range(d)):
        raise ValueError(f"round_order {order} is not a permutation "
                         f"of 0..{d - 1}")

    counts = [[int(np.shape(rows[s][t])[0]) for t in range(p)]
              for s in range(p)]

    buf = {r: [np.asarray(rows[r][t]) for t in range(p)] for r in range(p)}
    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    vol = SparseVolumeCount(dims)
    for k in order:
        positions, extent = round_datatype(dims, k)
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(c for i, c in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        exchanges = skipped = elems = 0
        staged = {}
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])
            for g_r, r in enumerate(members):
                newbuf = [None] * p
                for g_s, s in enumerate(members):
                    slots = [buf[s][pos + g_r * extent]
                             for pos in positions]
                    if g_s != g_r:
                        exchanges += 1
                        payload = sum(int(np.shape(sl)[0]) for sl in slots)
                        if payload == 0:
                            # the elided message: its empty slots from the
                            # sender's metadata (shape, dtype)
                            skipped += 1
                            slots = [sl[:0] for sl in slots]
                        else:
                            elems += payload
                    for pos, sl in zip(positions, slots):
                        newbuf[pos + g_s * extent] = sl
                staged[r] = newbuf
        for r, newbuf in staged.items():
            buf[r] = newbuf
        vol.exchanges_per_round.append(exchanges)
        vol.skipped_per_round.append(skipped)
        vol.elements_sent_per_round.append(elems)

    recv = [[buf[r][s] for s in range(p)] for r in range(p)]
    for r in range(p):
        for s in range(p):
            if np.shape(recv[r][s])[0] != counts[s][r]:
                raise AssertionError(
                    f"sparse alltoallv postcondition violated at "
                    f"recv[{r}][{s}]")
    return recv, counts, vol


__all__ = [
    "round_message_masks",
    "sparse_exact_alltoallv",
    "sparse_traffic_stats",
]
