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

This is ``repro.core.simulator`` (stdlib only) copied into the port: the
dense oracle, the Alltoallv (ragged and sparse) oracles, the
KV-migration oracle of disaggregated serving, the dimension-wise
gather-family oracles and the pencil transpose oracle of the
distributed FFT.
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
# Alltoallv (ragged) oracles.  Algorithm 1 moves block slots without reading
# them, so with per-pair counts each slot carries a variable-length payload
# and each round's per-peer message is a concatenation of such payloads.
# The oracles below run that slot movement with element-tagged payloads and
# count-weighted volume accounting; they are the correctness reference for
# ``core.ragged`` and ``core.sparse``.
# ----------------------------------------------------------------------------


@dataclass
class RaggedVolumeCount:
    """Per-round *element* volume bookkeeping for the ragged algorithm.

    ``elements_sent_per_round[k]`` sums, over all ranks in round ``k``, the
    payload elements that crossed a link (slots a rank keeps are free).
    Under a bucket of ``b`` elements per slot the same movement ships
    ``slots_sent_per_round[k] * b`` elements; ``occupancy(b)`` is the
    useful fraction.
    """

    dims: tuple[int, ...]
    elements_sent_per_round: list[int] = field(default_factory=list)
    slots_sent_per_round: list[int] = field(default_factory=list)

    @property
    def total_elements_sent(self) -> int:
        return sum(self.elements_sent_per_round)

    @property
    def total_slots_sent(self) -> int:
        return sum(self.slots_sent_per_round)

    def occupancy(self, bucket: int) -> float:
        """Ragged elements over ``slots * bucket`` padded elements (1.0
        when every slot carries exactly ``bucket`` elements)."""
        padded = self.total_slots_sent * bucket
        return self.total_elements_sent / padded if padded else 1.0


def _counts_matrix(counts, p: int):
    counts = [list(row) for row in counts]
    if len(counts) != p or any(len(row) != p for row in counts):
        raise ValueError(f"counts must be a {p}x{p} matrix")
    if any(c < 0 for row in counts for c in row):
        raise ValueError("counts must be non-negative")
    return counts


def _round_groups(coords, dims, k):
    """The dimension-``k`` groups: ranks that differ only in coordinate
    ``k``, each sorted by it."""
    groups: dict[tuple, list[int]] = {}
    for r, c in coords.items():
        key = tuple(x for i, x in enumerate(c) if i != k)
        groups.setdefault(key, []).append(r)
    for members in groups.values():
        members.sort(key=lambda r: coords[r][k])
        assert len(members) == dims[k]
    return groups.values()


def simulate_factorized_alltoallv(
    dims: tuple[int, ...],
    counts,
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], RaggedVolumeCount]:
    """Run Algorithm 1 with MPI_Alltoallv semantics for every rank.

    ``counts[s][d]`` is the number of elements rank ``s`` sends to rank
    ``d``; slot ``(s, d)``'s payload is ``[(s, d, 0), ..., (s, d,
    counts[s][d]-1)]`` (element order within a pair is preserved, the MPI
    contract).  Returns the final per-rank slot lists and the element
    volume.  Correct iff ``recv[r][i] == [(i, r, j) for j in
    range(counts[i][r])]`` for all ranks r and slots i.
    """
    d = len(dims)
    p = math.prod(dims)
    counts = _counts_matrix(counts, p)
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))

    buf = {r: [[(r, b, j) for j in range(counts[r][b])] for b in range(p)]
           for r in range(p)}
    vol = RaggedVolumeCount(dims)
    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    for k in order:
        positions, extent = round_datatype(dims, k)
        elems = slots = 0
        staged = {}
        for members in _round_groups(coords, dims, k):
            for g_r, r in enumerate(members):
                newbuf = [None] * p
                for g_s, s in enumerate(members):
                    for pos in positions:
                        slot = buf[s][pos + g_r * extent]
                        newbuf[pos + g_s * extent] = slot
                        if g_s != g_r:       # self-slots never cross a link
                            elems += len(slot)
                            slots += 1
                staged[r] = newbuf
        buf.update(staged)
        vol.elements_sent_per_round.append(elems)
        vol.slots_sent_per_round.append(slots)
    return buf, vol


def simulate_direct_alltoallv(counts) -> dict[int, list]:
    """Brute-force MPI_Alltoallv reference: a plain pairwise permutation."""
    p = len(counts)
    counts = _counts_matrix(counts, p)
    return {r: [[(i, r, j) for j in range(counts[i][r])] for i in range(p)]
            for r in range(p)}


def simulate_kv_migration(
    dims: tuple[int, ...],
    n_prefill: int,
    lengths,
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], RaggedVolumeCount]:
    """The KV-cache handoff oracle: an Alltoallv whose count matrix is
    non-zero only in the prefill->decode block.

    ``lengths`` maps ``(src, dst) -> rows`` (per-sequence KV lengths
    summed per placement pair); every source must be a prefill rank
    (``src < n_prefill``) and every destination a decode rank
    (``n_prefill <= dst < p``) — the block structure
    ``KVMigrationPlan.pair_counts`` enforces on the live path.  Delegates
    to :func:`simulate_factorized_alltoallv`, so correctness is the same
    MPI contract: ``recv[r][s] == [(s, r, j) for j in range(counts[s][r])]``.
    """
    p = math.prod(dims)
    n_prefill = int(n_prefill)
    if not 0 < n_prefill < p:
        raise ValueError(f"n_prefill {n_prefill} outside (0, p={p})")
    counts = [[0] * p for _ in range(p)]
    for (src, dst), n in lengths.items():
        src, dst, n = int(src), int(dst), int(n)
        if not 0 <= src < n_prefill:
            raise ValueError(f"migration source {src} is not a prefill "
                             f"rank (n_prefill={n_prefill})")
        if not n_prefill <= dst < p:
            raise ValueError(f"migration destination {dst} is not a decode "
                             f"rank (n_prefill={n_prefill}, p={p})")
        if n < 0:
            raise ValueError(f"negative count {n} for pair ({src}, {dst})")
        counts[src][dst] = n
    return simulate_factorized_alltoallv(dims, counts,
                                         round_order=round_order)


@dataclass
class SparseVolumeCount:
    """Per-round *message* bookkeeping for the sparse algorithm.

    Round ``k`` has ``p * (D[k] - 1)`` potential peer exchanges (every rank
    sends one composite message to each of its ``D[k] - 1`` group peers).
    An exchange whose combined payload is empty is *skipped*; the rest are
    the *combined messages* actually sent.
    """

    dims: tuple[int, ...]
    exchanges_per_round: list[int] = field(default_factory=list)
    skipped_per_round: list[int] = field(default_factory=list)
    elements_sent_per_round: list[int] = field(default_factory=list)

    @property
    def total_exchanges(self) -> int:
        return sum(self.exchanges_per_round)

    @property
    def skipped_exchanges(self) -> int:
        return sum(self.skipped_per_round)

    @property
    def combined_messages(self) -> int:
        return self.total_exchanges - self.skipped_exchanges

    @property
    def skipped_rounds(self) -> int:
        """Rounds whose every peer exchange was empty."""
        return sum(1 for e, s in zip(self.exchanges_per_round,
                                     self.skipped_per_round)
                   if e > 0 and s == e)

    @property
    def skip_fraction(self) -> float:
        t = self.total_exchanges
        return self.skipped_exchanges / t if t else 0.0

    @property
    def total_elements_sent(self) -> int:
        return sum(self.elements_sent_per_round)


def simulate_sparse_alltoallv(
    dims: tuple[int, ...],
    counts,
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], SparseVolumeCount]:
    """Run Algorithm 1 with sparse-Alltoallv semantics for every rank: the
    slot movement and payloads of :func:`simulate_factorized_alltoallv`,
    but an empty composite message is skipped (the receiver's slots are
    the zero-length payloads the count matrix implies) and the others are
    counted as combined messages.  Correct iff the final buffers equal
    :func:`simulate_direct_alltoallv`."""
    d = len(dims)
    p = math.prod(dims)
    counts = _counts_matrix(counts, p)
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))

    buf = {r: [[(r, b, j) for j in range(counts[r][b])] for b in range(p)]
           for r in range(p)}
    vol = SparseVolumeCount(dims)
    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    for k in order:
        positions, extent = round_datatype(dims, k)
        exchanges = skipped = elems = 0
        staged = {}
        for members in _round_groups(coords, dims, k):
            for g_r, r in enumerate(members):
                newbuf = [None] * p
                for g_s, s in enumerate(members):
                    slots = [buf[s][pos + g_r * extent]
                             for pos in positions]
                    if g_s != g_r:
                        exchanges += 1
                        payload = sum(len(sl) for sl in slots)
                        if payload == 0:
                            skipped += 1
                            slots = [[] for _ in positions]
                        else:
                            elems += payload
                    for pos, sl in zip(positions, slots):
                        newbuf[pos + g_s * extent] = sl
                staged[r] = newbuf
        buf.update(staged)
        vol.exchanges_per_round.append(exchanges)
        vol.skipped_per_round.append(skipped)
        vol.elements_sent_per_round.append(elems)
    return buf, vol


def check_correct_sparse_alltoallv(dims, counts, round_order=None) -> bool:
    final, _ = simulate_sparse_alltoallv(dims, counts, round_order)
    want = simulate_direct_alltoallv(counts)
    p = math.prod(dims)
    return all(final[r] == want[r] for r in range(p))


def check_correct_alltoallv(dims, counts, round_order=None) -> bool:
    final, _ = simulate_factorized_alltoallv(dims, counts, round_order)
    want = simulate_direct_alltoallv(counts)
    p = math.prod(dims)
    return all(final[r] == want[r] for r in range(p))


# ----------------------------------------------------------------------------
# Dimension-wise gather-collective oracles (the TorusComm family).
#
# Once the per-dimension sub-communicators are explicit, a whole family of
# collectives falls out of the same d-stage machinery (Mortensen et al.'s
# advanced-MPI transposes, Träff et al.'s isomorphic collectives): an
# all-gather is d concatenating stages, a reduce-scatter d reducing/
# scattering stages.  The oracles below model both with MPI group
# semantics — group membership from torus coordinates, per-stage digit
# assignment from group rank, final placement from the package's fixed
# fastest-digit-first linearization — and are the correctness reference
# for ``core.comm``'s chunked and unchunked gather plans and the
# paper's worked tori (5x4, 2x3x4).
# ----------------------------------------------------------------------------


def simulate_factorized_allgather(
    dims: tuple[int, ...],
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], VolumeCount]:
    """Run the d-stage dimension-wise all-gather for every rank.

    Each rank starts with one block (payload = its own rank id); stage
    ``k`` is an MPI_Allgather on the dimension-``k`` communicator — the
    contribution of group member ``j`` lands at digit-``k`` coordinate
    ``j`` of every member's buffer.  The final buffer is linearized by
    torus rank (digit 0 fastest).  Correct iff ``out[r] == list(range(p))``
    for every rank ``r``.

    Volume: stage ``k`` sends the ``prod(D_j, earlier j)`` blocks held so
    far to each of ``D[k]-1`` peers; the total telescopes to ``p - 1``
    blocks for *any* round order — all-gather has no combining win to
    factorize (unlike Theorem 1), the d-stage form wins on message count.
    """
    d = len(dims)
    p = math.prod(dims)
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))

    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    # buf[r]: {partial source coords (digit or None per dim) -> payload}
    buf: dict[int, dict] = {r: {(None,) * d: r} for r in range(p)}
    vol = VolumeCount(dims)

    for k in order:
        Dk = dims[k]
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(c for i, c in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        held = len(buf[0])
        staged = {}
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])
            assert len(members) == Dk
            merged = {}
            for g_s, s in enumerate(members):
                for key, payload in buf[s].items():
                    assert key[k] is None
                    merged[key[:k] + (g_s,) + key[k + 1:]] = payload
            for r in members:
                staged[r] = dict(merged)
        buf = staged
        vol.blocks_sent_per_round.append((Dk - 1) * held)

    out = {}
    for r in range(p):
        slots = [None] * p
        for key, payload in buf[r].items():
            slots[coords_to_rank(key, dims)] = payload
        out[r] = slots
    return out, vol


def simulate_factorized_reduce_scatter(
    dims: tuple[int, ...],
    round_order: tuple[int, ...] | None = None,
) -> tuple[dict[int, list], VolumeCount]:
    """Run the d-stage dimension-wise reduce-scatter for every rank.

    Rank ``s`` contributes one block per destination ``t`` with payload
    term ``(s, t)``; reduction is modeled as term concatenation (sorted at
    the end) so dropped, duplicated, or misrouted contributions are all
    visible.  Stage ``k`` is an MPI_Reduce_scatter on the dimension-``k``
    communicator: each member keeps (and reduces) the destinations whose
    digit ``k`` matches its own coordinate.  Correct iff ``out[r] ==
    [(s, r) for s in range(p)]`` for every rank ``r``.

    Volume: stage ``k`` ships the ``(D[k]-1)/D[k]`` fraction of the
    destination blocks still held (the held set shrinks ``D[k]``-fold per
    stage), so the per-rank total telescopes to ``p - 1`` blocks for any
    round order — the exact dual of the all-gather.  Like it, the d-stage
    form wins on the message count, not the volume.
    """
    d = len(dims)
    p = math.prod(dims)
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))

    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    # buf[r]: {destination rank -> list of (source, dest) payload terms}
    buf = {r: {t: [(r, t)] for t in range(p)} for r in range(p)}
    vol = VolumeCount(dims)

    for k in order:
        Dk = dims[k]
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(c for i, c in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        sent = 0
        staged = {}
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])
            assert len(members) == Dk
            for g_r, r in enumerate(members):
                new = {}
                for g_s, s in enumerate(members):
                    for t, terms in buf[s].items():
                        if coords[t][k] != g_r:
                            continue
                        new.setdefault(t, []).extend(terms)
                        if g_s != g_r:     # kept-by-owner blocks are free
                            sent += 1
                staged[r] = new
        buf = staged
        # `sent` sums over all ranks; VolumeCount is per rank (the stage
        # is symmetric, so the division is exact)
        vol.blocks_sent_per_round.append(sent // p)

    out = {}
    for r in range(p):
        assert set(buf[r]) == {r}, f"rank {r} kept foreign destinations"
        out[r] = sorted(buf[r][r])
    return out, vol


# ----------------------------------------------------------------------------
# Pencil-transpose oracle (distributed-FFT re-shard).
#
# The global transpose of a pencil-decomposed FFT (Dalcin et al., arXiv
# 1804.09536) is exactly an all-to-all of *uniform* blocks: each rank
# splits its local pencil into p chunks along ``split_axis`` (chunk t
# destined for torus rank t) and concatenates the p received chunks
# source-major along ``concat_axis``.  The oracle below runs the paper's
# d dimension-wise rounds on element-tagged chunks, so both the routing
# (block t of rank r must land in slot r of rank t — Algorithm 1) and the
# pencil *index math* (which global elements end up where) are checked.
# ----------------------------------------------------------------------------


def _c_strides(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Row-major (C-order) strides, matching the port's reshape."""
    out = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        out[i] = out[i + 1] * shape[i + 1]
    return tuple(out)


def _pencil_flat(coords, shape) -> int:
    return sum(c * s for c, s in zip(coords, _c_strides(shape)))


def pencil_transpose_reference(p: int, in_pencil: tuple[int, ...],
                               split_axis: int, concat_axis: int,
                               rank: int) -> list[int]:
    """Expected post-transpose local buffer of ``rank``: global flat ids
    (C-order over the global in-shape, ``concat_axis`` scaled by ``p``) in
    local out-pencil C-order.  Rank ``r`` starts with concat-block ``r``
    and ends with split-chunk ``r`` of the full concat axis."""
    in_pencil = tuple(in_pencil)
    sp = in_pencil[split_axis] // p
    global_shape = list(in_pencil)
    global_shape[concat_axis] *= p
    out_pencil = list(in_pencil)
    out_pencil[split_axis] = sp
    out_pencil[concat_axis] *= p
    ids = []
    for q in itertools.product(*[range(n) for n in out_pencil]):
        g = list(q)
        g[split_axis] += rank * sp
        ids.append(_pencil_flat(tuple(g), tuple(global_shape)))
    return ids


def simulate_pencil_transpose(
    dims: tuple[int, ...],
    in_pencil: tuple[int, ...],
    split_axis: int,
    concat_axis: int,
    round_order: tuple[int, ...] | None = None,
    contents: dict[int, list] | None = None,
) -> tuple[dict[int, list], VolumeCount]:
    """Run the d-round pencil transpose for every rank.

    Each rank holds a local pencil of shape ``in_pencil`` (rank ``r`` =
    concat-block ``r`` of the global array); the transpose splits
    ``split_axis`` into ``p`` chunks (chunk ``t`` -> torus rank ``t``) via
    the dimension-wise rounds and concatenates received chunks
    source-major along ``concat_axis`` — the tiled all-to-all semantics of
    ``core.factorized._factorized_tiled_impl``.

    ``contents`` optionally supplies each rank's local buffer (flat
    C-order payload list, e.g. a previous transpose's output, enabling
    round-trip composition); default is the identity labeling — global
    flat ids — for which correctness is ``out[r] ==
    pencil_transpose_reference(p, in_pencil, split_axis, concat_axis, r)``.

    Volume: uniform blocks of ``prod(in_pencil)/p`` elements, so round
    ``k`` sends ``(D[k]-1) * p/D[k]`` blocks per rank and the total obeys
    Theorem 1 exactly (returned as block counts in ``VolumeCount``).
    """
    d = len(dims)
    p = math.prod(dims)
    in_pencil = tuple(int(n) for n in in_pencil)
    if split_axis == concat_axis:
        raise ValueError("split_axis and concat_axis must differ")
    if in_pencil[split_axis] % p:
        raise ValueError(f"split axis size {in_pencil[split_axis]} not "
                         f"divisible by p={p}")
    order = tuple(round_order) if round_order is not None else tuple(range(d))
    assert sorted(order) == list(range(d))
    sp = in_pencil[split_axis] // p
    block_shape = list(in_pencil)
    block_shape[split_axis] = sp
    block_shape = tuple(block_shape)
    global_shape = list(in_pencil)
    global_shape[concat_axis] *= p
    global_shape = tuple(global_shape)
    c = in_pencil[concat_axis]

    def identity_contents(r):
        ids = []
        for q in itertools.product(*[range(n) for n in in_pencil]):
            g = list(q)
            g[concat_axis] += r * c
            ids.append(_pencil_flat(tuple(g), global_shape))
        return ids

    # buf[r]: flat buffer of p chunk slots (slot t = chunk destined for
    # rank t), exactly the (p, *block) form of the tiled kernel.  The
    # rounds below are simulate_factorized_alltoall's slot movement with
    # chunk payloads, so final slot s = the chunk received from source s.
    buf: dict[int, list] = {}
    for r in range(p):
        flat = contents[r] if contents is not None else identity_contents(r)
        if len(flat) != math.prod(in_pencil):
            raise ValueError(f"rank {r} contents length {len(flat)} != "
                             f"prod(in_pencil)={math.prod(in_pencil)}")
        chunks = [[] for _ in range(p)]
        for q, payload in zip(
                itertools.product(*[range(n) for n in in_pencil]), flat):
            chunks[q[split_axis] // sp].append(payload)
        buf[r] = chunks

    coords = {r: rank_to_coords(r, dims) for r in range(p)}
    vol = VolumeCount(dims)
    for k in order:
        positions, extent = round_datatype(dims, k)
        Dk = dims[k]
        groups: dict[tuple, list[int]] = {}
        for r in range(p):
            key = tuple(x for i, x in enumerate(coords[r]) if i != k)
            groups.setdefault(key, []).append(r)
        staged = {}
        for members in groups.values():
            members.sort(key=lambda r: coords[r][k])
            assert len(members) == Dk
            for g_r, r in enumerate(members):
                new = [None] * p
                for g_s, s in enumerate(members):
                    for pos in positions:
                        new[pos + g_s * extent] = buf[s][pos + g_r * extent]
                staged[r] = new
        buf = staged
        vol.blocks_sent_per_round.append((Dk - 1) * (p // Dk))

    # Assemble: the chunk in slot s fills concat positions [s*c, (s+1)*c)
    # of the out pencil (source-major concatenation).
    out_pencil = list(block_shape)
    out_pencil[concat_axis] = c * p
    out = {}
    for r in range(p):
        res = []
        for q in itertools.product(*[range(n) for n in out_pencil]):
            s, j = divmod(q[concat_axis], c)
            b = list(q)
            b[concat_axis] = j
            res.append(buf[r][s][_pencil_flat(tuple(b), block_shape)])
        out[r] = res
    return out, vol


def check_correct_pencil_transpose(dims, in_pencil, split_axis, concat_axis,
                                   round_order=None) -> bool:
    """True iff the d-round pencil transpose delivers exactly the expected
    re-shard on every rank, the round-trip (transpose then inverse
    transpose) is the identity, and the block volume obeys Theorem 1."""
    p = math.prod(dims)
    out, vol = simulate_pencil_transpose(dims, in_pencil, split_axis,
                                         concat_axis, round_order)
    ok = all(out[r] == pencil_transpose_reference(p, in_pencil, split_axis,
                                                  concat_axis, r)
             for r in range(p))
    ok = ok and vol.total_blocks_sent == vol.theorem1_formula
    sp = in_pencil[split_axis] // p
    out_pencil = list(in_pencil)
    out_pencil[split_axis] = sp
    out_pencil[concat_axis] *= p
    back, _ = simulate_pencil_transpose(dims, tuple(out_pencil), concat_axis,
                                        split_axis, round_order,
                                        contents=out)
    c = in_pencil[concat_axis]
    g_shape = list(in_pencil)
    g_shape[concat_axis] *= p
    for r in range(p):
        ids = []
        for q in itertools.product(*[range(n) for n in in_pencil]):
            g = list(q)
            g[concat_axis] += r * c
            ids.append(_pencil_flat(tuple(g), tuple(g_shape)))
        if back[r] != ids:
            return False
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
