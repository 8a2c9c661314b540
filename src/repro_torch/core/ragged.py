"""Ragged (``MPI_Alltoallv``) all-to-all on the factorized torus (port of
``repro.core.ragged``).

Algorithm 1 moves block *slots* without reading them, so the
dimension-wise decomposition carries over unchanged to non-uniform
per-pair volumes.  Execution modes (through ``core.plan.RaggedA2APlan``):

* **counts phase** — every rank learns the full ``p x p`` count matrix
  from one tiny dense int32 all-to-all through the layer's ``A2APlan``:
  each rank contributes its send-count row as every one of its ``p``
  blocks, so block ``i`` of the result is rank ``i``'s row.  Each
  exchange is a ``torch.profiler`` span, ``COUNTS_SPAN``.

* **bucketed** (``_bucketed_impl``) — every block is rounded up to a
  shared power-of-two ``bucket`` of rows, so each dimension-wise
  exchange is the dense plan's fixed-shape round (its reorder kernels
  included).  The bucket comes from ``max_count`` at plan time, never
  from the counts, so a call reads nothing back to the host.  The price
  is padding, reported as an *occupancy* (useful rows / bucketed rows).

* **exact** (``exact_alltoallv``) — the two-phase host path: the count
  matrix, then the d rounds with true ragged composite messages; no
  padding.  Checked slot for slot against the ``core.simulator`` oracle.

Data layout of the bucketed mode: each destination's rows sit at the
front of its bucket window (``x[i, :send_counts[i]]``); the rounds move
whole windows bit for bit, so callers may use any layout inside a window
(the MoE keeps expert-strided slots).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .simulator import rank_to_coords, round_datatype


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1) — the shared bucket size."""
    n = int(n)
    if n < 1:
        raise ValueError(f"bucket bound must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def torus_rank(fact) -> int:
    """This process's torus rank on the mesh-backed factorization
    ``fact``, fastest digit first."""
    if fact.rank is None:
        raise ValueError(
            f"the torus {fact.dims} over {fact.axis_names} has no process "
            "groups: build the plan or comm from a DeviceMesh to run it")
    return fact.rank


# ---------------------------------------------------------------------------
# Counts phase
# ---------------------------------------------------------------------------

# the profiler span of one counts exchange
COUNTS_SPAN = "repro_torch.ragged.counts_phase"


def _counts_matrix_impl(send_counts, counts_plan):
    """One tiny dense all-to-all -> the full ``(p, p)`` count matrix.

    ``send_counts``: this rank's ``(p,)`` int32 row.  Every one of the
    ``p`` blocks sent is that row, so after the exchange block ``i`` is
    rank ``i``'s row and ``M[i, j]`` = rows rank ``i`` sends rank ``j``,
    identical on every rank.
    """
    p = counts_plan.p
    row = torch.as_tensor(send_counts, dtype=torch.int32)
    if tuple(row.shape) != (p,):
        raise ValueError(f"send_counts shape {tuple(row.shape)} != ({p},)")
    with torch.profiler.record_function(COUNTS_SPAN):
        # untraced under the tracer too: the callers' spans cover it
        return counts_plan._execute(row.expand(p, p).contiguous(),
                                    counts_plan.order)


def _recv_counts_from_matrix(matrix, rank: int):
    """Column ``rank`` of the count matrix: ``M[i, rank]`` = rows rank
    ``i`` sends here = rows received from rank ``i``."""
    return matrix[:, rank].contiguous()


# ---------------------------------------------------------------------------
# Bucketed execution mode
# ---------------------------------------------------------------------------


def _pad_to_bucket(x, bucket: int):
    """Zero-pad the per-block row axis (axis 1) up to the bucket size."""
    m = x.shape[1]
    if m > bucket:
        raise ValueError(f"{m} rows per block exceed the plan bucket "
                         f"{bucket}; rebuild the plan with max_count>={m}")
    if m == bucket:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, bucket - m]
    return F.pad(x, pad)


def _bucketed_impl(x, send_counts, *, data_plan, counts_plan,
                   reverse: bool = False):
    """Fixed-shape ragged all-to-all: counts phase + bucket-padded rounds.

    Args:
      x: ``(p, m, *row)`` send blocks, ``m <= bucket``; block ``i`` holds
        the rows destined for torus rank ``i``.
      send_counts: ``(p,)`` int32 (a tensor on ``x``'s device, or a list).
      data_plan / counts_plan: the resolved dense plans (blocks
        ``(bucket, *row)`` and ``(p,)`` int32).
      reverse: run the data rounds in the drain order (combine).

    Returns ``(recv, recv_counts)``: ``recv[i]`` is the ``(bucket, *row)``
    window received from rank ``i`` (rows beyond ``recv_counts[i]`` are
    the sender's padding), ``recv_counts`` the matching ``(p,)`` int32.
    """
    recv_counts = _recv_counts_phase(x, send_counts, data_plan.p,
                                     counts_plan)
    padded = _pad_to_bucket(x, data_plan.block_shape[0])
    run = data_plan.reverse if reverse else data_plan.forward
    return run(padded), recv_counts


def _recv_counts_phase(x, send_counts, p: int, counts_plan):
    """The counts phase of a bucketed call on ``x`` (``(p, m, *row)``):
    this rank's ``(p,)`` int32 receive counts."""
    if x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != p={p}")
    counts = torch.as_tensor(send_counts, dtype=torch.int32,
                             device=x.device)
    matrix = _counts_matrix_impl(counts, counts_plan)
    return _recv_counts_from_matrix(matrix, torus_rank(counts_plan.fact))


def bucket_occupancy(counts, bucket: int):
    """Useful fraction of the bucketed exchange's traffic: total ragged
    rows over total padded rows (a float tensor)."""
    counts = torch.as_tensor(counts)
    return counts.sum() / (counts.numel() * bucket)


# ---------------------------------------------------------------------------
# Exact two-phase mode (host path)
# ---------------------------------------------------------------------------


def exact_alltoallv(rows, dims, round_order=None):
    """Exact global Alltoallv over the torus — host path, no padding.

    Args:
      rows: nested list, ``rows[s][d]`` = array-like of shape
        ``(counts[s][d], *row)`` — rank ``s``'s payload for rank ``d``
        (zero-length arrays allowed).
      dims: torus factor per dimension, fastest digit first.
      round_order: optional permutation of ``range(d)``.

    Phase one derives the count matrix; phase two runs Algorithm 1's d
    rounds with true ragged messages: in round ``k`` each rank sends peer
    ``j`` the concatenation of the variable-length slots at
    round-datatype positions ``positions + j * extent`` (an
    ``MPI_Alltoallv`` per dimension).  Returns ``(recv, counts)``:
    ``recv[r][s]`` = the rows rank ``r`` received from rank ``s``, and the
    count matrix.
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

    # buf[r][b] is the payload in slot b of rank r's flat buffer; a round
    # moves slots between group members as the dense algorithm does.
    buf = {r: [np.asarray(rows[r][t]) for t in range(p)] for r in range(p)}
    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    for k in order:
        positions, extent = round_datatype(dims, k)
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
                    for pos in positions:
                        newbuf[pos + g_s * extent] = \
                            buf[s][pos + g_r * extent]
                staged[r] = newbuf
        for r, newbuf in staged.items():
            buf[r] = newbuf

    recv = [[buf[r][s] for s in range(p)] for r in range(p)]
    # the MPI contract: slot s of rank r's recvbuf is what s sent r
    for r in range(p):
        for s in range(p):
            if np.shape(recv[r][s])[0] != counts[s][r]:
                raise AssertionError(
                    f"exact alltoallv postcondition violated at "
                    f"recv[{r}][{s}]")
    return recv, counts


def exact_round_message_elements(dims, counts, k: int):
    """Elements of the round-``k`` composite message rank 0 sends each
    peer, from the initial count matrix (the first round's per-peer
    send counts)."""
    positions, extent = round_datatype(tuple(dims), k)
    return [sum(counts[0][pos + j * extent] for pos in positions)
            for j in range(dims[k])]


__all__ = [
    "bucket_occupancy",
    "exact_alltoallv",
    "exact_round_message_elements",
    "next_pow2",
    "torus_rank",
]
