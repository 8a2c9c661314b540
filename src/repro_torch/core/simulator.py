"""Pure-Python/numpy oracle of the paper's Algorithm 1 with *MPI semantics*.

This module models the MPI implementation (Listing 3) faithfully:

* a flat per-rank buffer of ``p`` blocks,
* the per-round *derived datatype* as an explicit list of block offsets plus
  a tiled extent (``MPI_Type_contiguous`` + ``MPI_Type_create_resized``),
* ``MPI_Alltoall`` with identical send/recv datatypes on the dimension-wise
  sub-communicators (groups of ranks differing only in torus coordinate k),
* the double-buffering parity scheme of Listing 3 (``sendbuf`` read in the
  first round, ``recvbuf`` written in the last round; one temporary buffer).

Conventions follow Algorithm 1 of the paper: dimension 0 is the
fastest-varying digit, with strides ``sigma(i) = prod(D[:i])`` and rounds
``k = 0, 1, ..., d-1``.  (Listing 1/3 use the mirrored MPI row-major
convention; the two are identical up to relabeling of the dimensions.)

The simulator is the correctness oracle for the JAX implementation and for
the paper's three worked examples (5x4, 2x3x4, 4x3x3x4) and Theorem 1's
communication-volume formula.

This is the dense part of ``repro.core.simulator`` (stdlib only), copied
into the port: the ragged, sparse, KV-migration and pencil oracles come
with the slices that port those collectives.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field


def strides(dims: tuple[int, ...]) -> tuple[int, ...]:
    """sigma(i) = prod(D[:i]); sigma(0) = 1 (dimension 0 varies fastest)."""
    out, acc = [], 1
    for d in dims:
        out.append(acc)
        acc *= d
    return tuple(out)


def rank_to_coords(rank: int, dims: tuple[int, ...]) -> tuple[int, ...]:
    """Digit decomposition: rank = sum_i O[i] * sigma(i)."""
    out = []
    for d in dims:
        out.append(rank % d)
        rank //= d
    return tuple(out)


def coords_to_rank(coords: tuple[int, ...], dims: tuple[int, ...]) -> int:
    sig = strides(dims)
    return sum(c * s for c, s in zip(coords, sig))


def round_datatype(dims: tuple[int, ...], k: int) -> tuple[list[int], int]:
    """The derived datatype for round ``k`` (one instance = one peer).

    Returns ``(positions, extent)``: block offsets of instance 0, in message
    order, and the tiled extent in blocks.  Instance ``j`` (peer ``j`` in the
    dimension-``k`` communicator) is ``positions`` shifted by ``j * extent``.

    This is the traversal
    ``S'_[sigma(k)][sigma(k+1)]...[sigma(d-1)] [D[k]][D[k+1]]...[D[d-1]]``
    of the paper: column-major over the not-yet-processed dimensions
    (index ``i_{k+1}`` slowest, ``i_{d-1}`` fastest), each innermost item a
    run of ``sigma(k)`` consecutive blocks.
    """
    d = len(dims)
    sig = strides(dims)
    uppers = list(range(k + 1, d))  # i_{k+1} slowest ... i_{d-1} fastest
    positions: list[int] = []
    for idx in itertools.product(*[range(dims[m]) for m in uppers]):
        base = sum(i * sig[m] for i, m in zip(idx, uppers))
        positions.extend(range(base, base + sig[k]))
    return positions, sig[k]


@dataclass
class VolumeCount:
    """Per-rank communication volume bookkeeping (Theorem 1)."""

    dims: tuple[int, ...]
    blocks_sent_per_round: list[int] = field(default_factory=list)

    @property
    def total_blocks_sent(self) -> int:
        return sum(self.blocks_sent_per_round)

    @property
    def theorem1_formula(self) -> int:
        d, p = len(self.dims), math.prod(self.dims)
        return d * p - sum(p // Dk for Dk in self.dims)


def simulate_factorized_alltoall(
    dims: tuple[int, ...],
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], VolumeCount]:
    """Run Algorithm 1 with MPI flat-buffer semantics for every rank.

    Block payloads are ``(source_rank, dest_rank)`` tuples.  Returns the
    final ``recvbuf`` of every rank plus the volume count.  Correct iff
    ``recv[r][i] == (i, r)`` for all ranks r and block indices i.
    """
    d = len(dims)
    p = math.prod(dims)
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))

    send = {r: [(r, b) for b in range(p)] for r in range(p)}
    temp = {r: [None] * p for r in range(p)}
    recv = {r: [None] * p for r in range(p)}
    buffers = {"send": send, "temp": temp, "recv": recv}

    # Listing 3 buffer parity: out starts at sendbuf; in = tempbuf if d is
    # even else recvbuf, so that the final round receives into recvbuf.
    out_name = "send"
    in_name = "temp" if d % 2 == 0 else "recv"

    vol = VolumeCount(dims)
    coords = {r: rank_to_coords(r, dims) for r in range(p)}

    for k in order:
        positions, extent = round_datatype(dims, k)
        Dk = dims[k]
        outb, inb = buffers[out_name], buffers[in_name]
        # Communicator groups: ranks sharing all coords except digit k.
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(c for i, c in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])  # group rank = digit k
            assert len(members) == Dk
            # MPI_Alltoall: receiver g_r instance g_s <- sender g_s instance g_r
            staged = {}
            for g_r, r in enumerate(members):
                newbuf = [None] * p
                for g_s, s in enumerate(members):
                    for m, pos in enumerate(positions):
                        newbuf[pos + g_s * extent] = outb[s][pos + g_r * extent]
                staged[r] = newbuf
            for r, newbuf in staged.items():
                inb[r] = newbuf
        vol.blocks_sent_per_round.append((Dk - 1) * (p // Dk))
        # Buffer switch (Listing 3).
        if out_name == "send":
            if in_name == "recv":
                out_name, in_name = "recv", "temp"
            else:
                out_name, in_name = "temp", "recv"
        else:
            out_name, in_name = in_name, out_name

    final = buffers[out_name]  # after the swap, 'out' holds the last result
    return final, vol


def simulate_direct_alltoall(p: int) -> dict[int, list]:
    """Reference: the trivial direct all-to-all."""
    return {r: [(i, r) for i in range(p)] for r in range(p)}


def check_correct(dims: tuple[int, ...], round_order=None) -> bool:
    final, vol = simulate_factorized_alltoall(dims, round_order)
    p = math.prod(dims)
    ok = all(final[r] == [(i, r) for i in range(p)] for r in range(p))
    ok = ok and vol.total_blocks_sent == vol.theorem1_formula
    return ok


# ----------------------------------------------------------------------------
# The paper's three worked examples (§3).  Values corrected for obvious
# typos in the paper's tables: 5x4 round 1 row 3 prints "28" for 18;
# 2x3x4 round 2 row 2 prints "23" for 13; 4x3x3x4 round 0 rows print a
# duplicated "104" where 105/106 follow by the pattern.
# ----------------------------------------------------------------------------

PAPER_EXAMPLES = {
    (5, 4): {
        0: [[0, 5, 10, 15], [1, 6, 11, 16], [2, 7, 12, 17], [3, 8, 13, 18],
            [4, 9, 14, 19]],
        1: [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13, 14],
            [15, 16, 17, 18, 19]],
    },
    (2, 3, 4): {
        0: [[0, 6, 12, 18, 2, 8, 14, 20, 4, 10, 16, 22],
            [1, 7, 13, 19, 3, 9, 15, 21, 5, 11, 17, 23]],
        1: [[0, 1, 6, 7, 12, 13, 18, 19],
            [2, 3, 8, 9, 14, 15, 20, 21],
            [4, 5, 10, 11, 16, 17, 22, 23]],
        2: [[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11],
            [12, 13, 14, 15, 16, 17], [18, 19, 20, 21, 22, 23]],
    },
}


def example_index_table(dims: tuple[int, ...], k: int) -> list[list[int]]:
    """R'[j] index sequences for round k — the paper's example tables."""
    positions, extent = round_datatype(dims, k)
    return [[pos + j * extent for pos in positions] for j in range(dims[k])]
