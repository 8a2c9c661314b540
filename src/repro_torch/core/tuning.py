"""Algorithm selection / tuning — the paper's §5 conclusion, made a policy.

A copy of ``repro.core.tuning`` (stdlib only), so that the port resolves
every plan exactly as the reference does; ``next_pow2`` comes from the
port's ``core.ragged``, as the reference's does.

The paper finds: the d=2,3 factorized algorithm beats native MPI_Alltoall
by 2x+ for <= ~100 small elements per process (latency/startup regime),
the direct algorithm wins for large blocks (bandwidth regime), and
d = ceil(log2 p) is never competitive on their system.  "By choosing the
factorization of p and selecting appropriate implementations for the
component MPI_Alltoall operations, the presented implementation gives
ample opportunities for algorithm tuning and adaptation."

We encode that as an alpha-beta cost model over a heterogeneous torus
(per-axis latency alpha_k and bandwidth beta_k — ICI vs DCN):

    T_factorized(D) = sum_k [ alpha_k * ceil(log?) ... ]  — we use the
    flat per-round model: alpha_k + (D[k]-1) * msg_k / bw_k, with
    msg_k = p/D[k] * block_bytes the per-peer message in round k
    (composite of p/D[k] blocks), sent to D[k]-1 peers.

    T_direct = alpha_flat + (p-1) * block_bytes / bw_min

``choose_algorithm`` enumerates candidate factorizations (the mesh's own
axes plus dims_create splits) and returns the predicted-optimal schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .dims import dims_create, max_dims, prime_factorization
from .ragged import next_pow2


@dataclass(frozen=True)
class LinkModel:
    """Per-axis link parameters."""
    alpha: float      # startup latency per collective round, seconds
    bandwidth: float  # bytes/second per device along this axis


# TPU v5e-flavoured defaults (per chip): ICI ~50 GB/s/link with ~1us
# collective startup; DCN (inter-pod) ~ 6.4 GB/s with ~25us startup.
ICI = LinkModel(alpha=1e-6, bandwidth=50e9)
DCN = LinkModel(alpha=25e-6, bandwidth=6.4e9)
# Kept as the reference's numbers, so that ``backend="tuned"`` resolves
# and ``describe()`` reads the same in both packages; they price TPU links,
# not NVLink or a GPU host's network.  Per-plan ``links=`` overrides them.


def per_axis_links(links, d: int) -> tuple[LinkModel, ...]:
    """Normalize a link spec to one :class:`LinkModel` per axis.

    Accepts a single ``LinkModel`` (uniform torus — broadcast to every
    axis) or a length-``d`` sequence of per-axis overrides, e.g. the
    measured fits ``core.autotune`` feeds back into this model.  Every
    prediction entry point below accepts either form.
    """
    if isinstance(links, LinkModel):
        return (links,) * d
    links = tuple(links)
    if len(links) != d:
        raise ValueError(f"{len(links)} links for {d} dims")
    return links


# Mesh axes that cross the slow inter-pod network; everything else is
# priced as ICI.  Overridable per plan via ``links=``.
DCN_AXES = ("pod",)


def default_links(axis_names) -> tuple[LinkModel, ...]:
    """Per-axis link models: DCN for inter-pod axes, ICI otherwise."""
    return tuple(DCN if a in DCN_AXES else ICI for a in axis_names)


def resolve_links(links, dims, axis_names=None) -> tuple[LinkModel, ...]:
    """The one merge point for link-model plumbing.

    ``None`` resolves to the axis-name defaults (DCN for ``pod``-like
    axes when names are known, uniform ICI otherwise); a single
    :class:`LinkModel` broadcasts to every axis; a per-axis sequence is
    length-validated.  Every layer that accepts a link override —
    ``core.plan``, ``core.comm``, the ``core.pipelined`` facade — routes
    through here, so the uniform-``link`` and per-axis-``links`` calling
    conventions can never diverge.
    """
    if links is None:
        if axis_names is not None:
            return default_links(axis_names)
        return (ICI,) * len(dims)
    return per_axis_links(links, len(dims))


@dataclass(frozen=True)
class Schedule:
    """A concrete algorithm choice for one all-to-all call."""
    kind: str                      # "direct" | "factorized" | "overlap"
    dims: tuple[int, ...]          # factor per round (fastest digit first)
    links: tuple[LinkModel, ...]   # link model per round
    predicted_seconds: float
    n_chunks: int = 1              # payload chunks (overlap engine)

    @property
    def d(self) -> int:
        return len(self.dims)


def predict_factorized(dims, links, block_bytes: float, p: int) -> float:
    """Alpha-beta prediction for the d-round algorithm.

    Per-message overhead ``alpha`` is charged per peer (the standard
    linear-cost model); message combining means round k sends only
    ``D[k]-1`` messages of ``p/D[k]`` combined blocks each — this is
    exactly why the factorized algorithm wins the small-block regime.
    """
    links = per_axis_links(links, len(dims))
    t = 0.0
    for Dk, link in zip(dims, links):
        if Dk == 1:
            continue
        msg = (p // Dk) * block_bytes          # composite message per peer
        t += (Dk - 1) * (link.alpha + msg / link.bandwidth)
    return t


def per_axis_round_seconds(dims, links, block_bytes: float,
                           p: int | None = None) -> tuple[float, ...]:
    """:func:`predict_factorized`'s per-round terms, unsummed.

    One entry per torus dimension, in axis order (size-1 dimensions are
    no-op rounds and contribute ``0.0``), so the vector sums exactly to
    ``predict_factorized``.  This is the model side of the telemetry
    drift check: each dimension-wise round's *measured* span duration is
    compared against its entry here (``core.telemetry.DriftDetector``),
    and the apportioned round spans of non-stepped backends split the
    measured wall time in these proportions.
    """
    links = per_axis_links(links, len(dims))
    p = math.prod(dims) if p is None else p
    return tuple(
        0.0 if Dk == 1
        else (Dk - 1) * (link.alpha + (p // Dk) * block_bytes
                         / link.bandwidth)
        for Dk, link in zip(dims, links))


def predict_direct(p: int, block_bytes: float, link: LinkModel) -> float:
    """Direct algorithm: p-1 individual messages of one block each."""
    return (p - 1) * (link.alpha + block_bytes / link.bandwidth)


def predict_overlapped(dims, links, block_bytes: float, p: int,
                       n_chunks: int, compute_seconds: float = 0.0) -> float:
    """Alpha-beta prediction for the chunked, software-pipelined schedule
    (``core.overlap``).

    Splitting the block payload into ``n`` chunks and interleaving the
    per-chunk round schedules lets rounds of different chunks run on
    *different dimension links* concurrently: in steady state the
    bandwidth term is divided by the achievable concurrency
    ``min(d, n)``.  The price is the pipeline fill/drain — each round's
    per-peer latency is paid ``(d + n - 1)/d`` times over the schedule —
    so the latency term *grows monotonically* in ``n`` while the
    bandwidth term shrinks, reproducing the small-vs-large payload
    crossover the paper observes for direct-vs-factorized one level up.

    ``compute_seconds`` models an interleaved per-chunk compute stage
    (MoE expert FFN, Ulysses attention): with ``n`` chunks all but the
    fill fraction ``1/n`` of the cheaper of {communication, compute}
    hides behind the other.

    At ``n_chunks=1`` (and ``compute_seconds=0``) this is exactly
    ``predict_factorized``.
    """
    links = per_axis_links(links, len(dims))
    active = [(Dk, l) for Dk, l in zip(dims, links) if Dk > 1]
    d = len(active)
    if d == 0:
        return compute_seconds
    lat = sum((Dk - 1) * l.alpha for Dk, l in active)
    bw = sum((Dk - 1) * (p // Dk) * block_bytes / l.bandwidth
             for Dk, l in active)
    n = max(1, int(n_chunks))
    if n == 1:
        return lat + bw + compute_seconds
    fill = (d + n - 1) / d
    t_comm = fill * lat + bw / min(d, n)
    return max(t_comm, compute_seconds) \
        + min(t_comm, compute_seconds) / n


def predict_ragged(dims, links, row_bytes: float, bucket: int, p: int, *,
                   occupancy: float = 1.0, counts_bytes: int = 4,
                   n_chunks: int = 1, compute_seconds: float = 0.0) -> float:
    """Alpha-beta prediction for the bucketed ragged (Alltoallv) exchange.

    Two phases: the tiny int32 counts all-to-all (each device's block is
    its full ``p``-entry count row — ``p * counts_bytes`` per block), then
    the data rounds at the padded block size ``bucket * row_bytes``.  The
    bucket relates to the *useful* payload through the expected occupancy
    ``avg_count / bucket``: the padded data phase costs the dense schedule
    at the average ragged block divided by the occupancy — i.e. expected
    occupancy x this prediction == the dense cost of the useful bytes, the
    waste the bucketed executor reports and the tuner prices.

    ``n_chunks > 1`` prices the data phase through the chunked/pipelined
    schedule (``predict_overlapped``) instead, matching a plan whose data
    backend resolved to overlap/pipelined.
    """
    links = per_axis_links(links, len(dims))
    if not 0.0 < occupancy <= 1.0:
        raise ValueError(f"occupancy must be in (0, 1], got {occupancy}")
    t_counts = predict_factorized(dims, links, p * float(counts_bytes), p)
    padded = float(bucket) * float(row_bytes)
    if n_chunks > 1:
        t_data = predict_overlapped(dims, links, padded, p, n_chunks,
                                    compute_seconds)
    else:
        t_data = predict_factorized(dims, links, padded, p) + compute_seconds
    return t_counts + t_data


# Per-lane startup multiplier for the sparse rounds: decomposing a dense
# round into D[k]-1 guarded peer lanes (slice + ppermute + predicate per
# lane instead of one fused all-to-all) costs extra per-message overhead,
# which is what keeps dense-bucketed the winner at high occupancy.
SPARSE_LANE_OVERHEAD = 2.0


def predict_sparse(dims, links, row_bytes: float, bucket: int, p: int, *,
                   density: float, counts_bytes: int = 4,
                   compute_seconds: float = 0.0) -> float:
    """Alpha-beta prediction for the sparse-neighborhood Alltoallv.

    Same two phases as :func:`predict_ragged` — the dense int32 counts
    all-to-all, then the data rounds at the padded ``bucket * row_bytes``
    window — but round ``k``'s per-peer lane is *skippable*: under an
    i.i.d. non-zero-pair ``density`` (the non-zero fraction of the
    ``p x p`` count matrix), a composite message combining ``p / D[k]``
    windows is non-empty with probability ``1 - (1 - density)^(p/D[k])``,
    and only non-empty lanes pay the bandwidth term.  Every lane pays the
    (inflated, ``SPARSE_LANE_OVERHEAD``x) startup term — the predicate
    itself is evaluated everywhere — so at ``density -> 1`` sparse is
    strictly dense-ragged plus lane overhead and the tuner keeps the
    dense bucketed path; the win appears once message combining leaves
    most lanes empty.
    """
    links = per_axis_links(links, len(dims))
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    t = predict_factorized(dims, links, p * float(counts_bytes), p)
    padded = float(bucket) * float(row_bytes)
    for Dk, link in zip(dims, links):
        if Dk == 1:
            continue
        m = p // Dk                         # windows combined per message
        p_nonempty = 1.0 - (1.0 - density) ** m
        t += (Dk - 1) * (SPARSE_LANE_OVERHEAD * link.alpha
                         + p_nonempty * m * padded / link.bandwidth)
    return t + compute_seconds


def choose_ragged_algorithm(axis_dims, axis_links, row_bytes: float,
                            bucket: int, *, max_chunks: int = 1,
                            compute_seconds: float = 0.0,
                            density: float | None = None) -> Schedule:
    """Pick the data-phase backend for a bucketed ragged exchange.

    The data rounds are shape-identical to a dense all-to-all of
    ``bucket * row_bytes`` blocks, so the dense policy applies verbatim at
    the padded size; the counts phase is priced by the same policy over
    its ``(p,)`` int32 block (unchunked — pipelining a counts exchange is
    pointless) and added to the winning schedule's prediction, so ragged
    candidates are priced end to end and this function agrees exactly
    with how ``plan_ragged_all_to_all(backend="tuned")`` resolves both
    sub-plans (``backend="autotune"`` resolves the data phase through the
    measured records keyed by the padded block shape instead).

    When a ``density`` estimate is given (the expected non-zero fraction
    of the count matrix — e.g. the dropless-MoE router's occupancy
    proxy), the sparse-neighborhood schedule (:func:`predict_sparse`,
    priced end to end including its counts phase) joins the candidate
    set and the returned schedule may have ``kind == "sparse"`` — the
    dense<->sparse crossover the ROADMAP names.  ``density`` outside
    (0, 1] raises ``ValueError``; ``None`` keeps the dense-only
    candidate set.
    """
    axis_links = per_axis_links(axis_links, len(axis_dims))
    p = math.prod(axis_dims)
    sched = choose_algorithm(axis_dims, axis_links,
                             float(bucket) * float(row_bytes),
                             max_chunks=max_chunks,
                             compute_seconds=compute_seconds)
    t_counts = choose_algorithm(axis_dims, axis_links, p * 4.0,
                                max_chunks=1).predicted_seconds
    best = Schedule(sched.kind, sched.dims, sched.links,
                    sched.predicted_seconds + t_counts,
                    n_chunks=sched.n_chunks)
    if density is not None:
        t_sparse = predict_sparse(axis_dims, axis_links, float(row_bytes),
                                  bucket, p, density=density,
                                  compute_seconds=compute_seconds)
        if t_sparse < best.predicted_seconds:
            best = Schedule("sparse", tuple(axis_dims), axis_links,
                            t_sparse, n_chunks=1)
    return best


def predict_kv_migration(dims, links, row_bytes: float, bucket: int, *,
                         n_prefill: int,
                         migrations_per_tick: float = 1.0) -> Schedule:
    """Alpha-beta prediction for the prefill->decode KV-cache handoff.

    The handoff is an Alltoallv over the *full* serving comm whose count
    matrix is non-zero only in the prefill->decode block: at most
    ``n_prefill * (p - n_prefill)`` of the ``p^2`` pairs can carry a
    sequence, and a scheduler that migrates ``migrations_per_tick``
    sequences per tick fills that many pairs.  That block density is
    exactly the sparse-neighborhood regime knob, so the prediction is
    :func:`choose_ragged_algorithm` at the expected density — the
    returned schedule's ``kind`` may be ``"sparse"`` (few migrations per
    tick: message combining leaves most lanes empty) or a dense data
    backend (many concurrent migrations), the same dense<->sparse
    crossover the MoE router sees.
    """
    p = math.prod(dims)
    links = per_axis_links(links, len(dims))
    n_prefill = int(n_prefill)
    if not 0 < n_prefill < p:
        raise ValueError(f"n_prefill {n_prefill} outside (0, p={p})")
    if migrations_per_tick <= 0:
        raise ValueError(f"migrations_per_tick must be > 0, got "
                         f"{migrations_per_tick}")
    pairs = min(float(migrations_per_tick),
                float(n_prefill * (p - n_prefill)))
    density = max(pairs, 1.0) / float(p * p)
    return choose_ragged_algorithm(dims, links, float(row_bytes),
                                   int(bucket), density=density)


@dataclass(frozen=True)
class ServingSplit:
    """A sized prefill:decode partition of one serving comm."""
    n_prefill: int
    n_decode: int
    predicted_seconds: float       # per-tick bottleneck incl. migration
    prefill_seconds: float
    decode_seconds: float
    migration_seconds: float
    migration_kind: str            # winning KV-migration schedule kind


def choose_serving_split(dims, links, *, row_bytes: float, max_count: int,
                         prefill_tokens: float = 4.0,
                         decode_tokens: float = 1.0,
                         token_seconds: float = 1e-4,
                         migrations_per_tick: float = 1.0) -> ServingSplit:
    """Size the prefill:decode split from the predicted migration cost.

    Per serving tick the prefill domain must ingest ``prefill_tokens``
    prompt tokens and the decode domain must emit ``decode_tokens``
    generated tokens; a domain of ``n`` ranks processes tokens at rate
    ``n / token_seconds`` (each rank one token per step), so the two
    domains cost ``token_seconds * tokens / n`` and the tick is their
    max — plus the KV handoff, priced end to end by
    :func:`predict_kv_migration` over the *full* comm (``row_bytes`` is
    one flattened per-position KV row, ``max_count`` the per-sequence
    row bound — the cache's sequence extent).  Enumerates every
    ``n_prefill in 1..p-1`` and returns the argmin; ties go to the
    smaller prefill pool (decode capacity is the scarce resource once
    the tick time is equal).
    """
    p = math.prod(dims)
    if p < 2:
        raise ValueError(f"need p >= 2 ranks to split, got {p}")
    links = resolve_links(links, dims)
    bucket = next_pow2(max_count)
    best = None
    for n in range(1, p):
        t_pre = token_seconds * float(prefill_tokens) / n
        t_dec = token_seconds * float(decode_tokens) / (p - n)
        sched = predict_kv_migration(
            dims, links, float(row_bytes), bucket, n_prefill=n,
            migrations_per_tick=migrations_per_tick)
        t = max(t_pre, t_dec) + sched.predicted_seconds
        if best is None or t < best.predicted_seconds:
            best = ServingSplit(n, p - n, t, t_pre, t_dec,
                                sched.predicted_seconds, sched.kind)
    return best


def slowest_active_link(dims, links) -> LinkModel:
    """The bandwidth bottleneck among links that carry traffic: a size-1
    axis (a trivial "pod" dim, or an unfitted placeholder link from a
    tuning-DB record) must not masquerade as the bottleneck.  The one
    definition of the direct collective's pricing link, shared by every
    policy (``choose_algorithm``, ``choose_dimwise_algorithm``,
    ``core.plan``, ``core.comm``)."""
    links = per_axis_links(links, len(dims))
    active = [l for Dk, l in zip(dims, links) if Dk > 1] or list(links)
    return min(active, key=lambda l: l.bandwidth)


def _active_stages(dims, links, p: int, round_order):
    """Shared prologue of the gather-family predictors: per-axis links,
    ``p`` consistency, the active (size > 1) stages, and the round order
    *over those active stages* — the same convention the kernels and the
    plan layer validate (``round_order=(1, 0)`` on dims ``(1, 4, 4)``
    permutes the two size-4 stages; the trivial axis has no round)."""
    links = per_axis_links(links, len(dims))
    if p != math.prod(dims):
        raise ValueError(f"p={p} != prod(dims)={math.prod(dims)}")
    active = [(Dk, l) for Dk, l in zip(dims, links) if Dk > 1]
    order = tuple(round_order) if round_order is not None \
        else tuple(range(len(active)))
    if sorted(order) != list(range(len(active))):
        raise ValueError(f"round_order {order} is not a permutation of "
                         f"0..{len(active) - 1}")
    return active, order


def predict_allgather(dims, links, block_bytes: float, p: int,
                      round_order=None) -> float:
    """Alpha-beta prediction for the d-stage dimension-wise all-gather.

    Stage ``k`` (in the given round order) ships the payload gathered so
    far — ``block_bytes * prod(D_j for earlier stages j)`` — to the
    ``D[k]-1`` peers of the dimension-``k`` communicator.  The bandwidth
    term telescopes to exactly ``(p-1) * block_bytes`` for any order
    (all-gather has no volume win to factorize, unlike Theorem 1's
    all-to-all), so the d-stage form wins purely on the latency term:
    ``sum_k (D[k]-1)`` messages instead of ``p-1``.  The order knob
    matters only on heterogeneous links (put the slow axis early, while
    the payload is small).
    """
    active, order = _active_stages(dims, links, p, round_order)
    t, held = 0.0, float(block_bytes)
    for k in order:
        Dk, link = active[k]
        t += (Dk - 1) * (link.alpha + held / link.bandwidth)
        held *= Dk
    return t


def predict_reduce_scatter(dims, links, block_bytes: float, p: int,
                           round_order=None) -> float:
    """Alpha-beta prediction for the d-stage dimension-wise reduce-scatter.

    The mirror of :func:`predict_allgather`: stage ``k`` holds
    ``block_bytes * p / prod(D_j for earlier stages j)`` and ships the
    ``(D[k]-1)/D[k]`` fraction bound for other group members, shrinking
    the payload ``D[k]``-fold.  The bandwidth term telescopes to
    ``(p-1) * block_bytes`` for any order (the dual of the all-gather),
    so here too the d-stage form wins on the latency term; on
    heterogeneous links the slow axis wants to go *late*, once the
    payload has shrunk.
    """
    active, order = _active_stages(dims, links, p, round_order)
    t, held = 0.0, float(block_bytes) * p
    for k in order:
        Dk, link = active[k]
        t += (Dk - 1) * link.alpha + held * (Dk - 1) / (Dk * link.bandwidth)
        held /= Dk
    return t


def choose_dimwise_algorithm(kind: str, axis_dims, axis_links,
                             block_bytes: float, *,
                             round_order=None) -> Schedule:
    """Pick direct vs factorized for a dimension-wise gather collective.

    ``kind`` is ``"allgather"`` or ``"reduce_scatter"``; candidates are
    the single product-communicator collective (priced like
    :func:`predict_direct`: ``p-1`` peer messages of one block, bounded
    by the slowest link that carries traffic) and the d per-axis stages
    (:func:`predict_allgather` / :func:`predict_reduce_scatter`), the
    same policy shape as :func:`choose_algorithm` for the all-to-all.
    """
    if kind not in ("allgather", "reduce_scatter"):
        raise ValueError(f"unknown dimension-wise collective kind {kind!r}")
    axis_links = per_axis_links(axis_links, len(axis_dims))
    p = math.prod(axis_dims)
    slowest = slowest_active_link(axis_dims, axis_links)
    best = Schedule("direct", (p,), (slowest,),
                    predict_direct(p, block_bytes, slowest))
    predict = predict_allgather if kind == "allgather" \
        else predict_reduce_scatter
    t = predict(axis_dims, axis_links, block_bytes, p,
                round_order=round_order)
    if t < best.predicted_seconds:
        best = Schedule("factorized", tuple(axis_dims), axis_links, t)
    return best


def choose_chunks(dims, links, block_bytes: float, *, max_chunks: int = 8,
                  compute_seconds: float = 0.0) -> int:
    """Chunk count minimizing ``predict_overlapped`` (1 = don't pipeline).

    ``links``: one uniform :class:`LinkModel` or a per-axis sequence —
    measured per-axis bandwidths (``core.autotune``) plug in directly.
    """
    links = per_axis_links(links, len(dims))
    p = math.prod(dims)
    best_n, best_t = 1, float("inf")
    for n in range(1, max(1, max_chunks) + 1):
        t = predict_overlapped(dims, links, block_bytes, p, n,
                               compute_seconds)
        if t < best_t:
            best_n, best_t = n, t
    return best_n


def candidate_factorizations(p: int, max_d: int | None = None):
    """dims_create splits for d = 1..ceil(log2 p) (paper's sweep), plus the
    full prime factorization."""
    out = []
    hi = max_d if max_d is not None else max_dims(p)
    for d in range(1, hi + 1):
        f = dims_create(p, d)
        if math.prod(f) == p and f not in out:
            out.append(f)
    pf = tuple(prime_factorization(p))
    if pf not in out and len(pf) <= (max_d or len(pf)):
        out.append(pf)
    return out


def choose_algorithm(axis_dims: tuple[int, ...],
                     axis_links: tuple[LinkModel, ...],
                     block_bytes: float, *, max_chunks: int = 1,
                     compute_seconds: float = 0.0) -> Schedule:
    """Pick direct vs factorized vs overlapped for a mesh-axis product.

    ``axis_dims``/``axis_links`` describe the physical torus axes the
    all-to-all spans (fastest digit first).  Candidates: the direct
    single collective (bounded by the slowest link), the axis-wise
    factorization, and — when ``max_chunks > 1`` — the chunked/pipelined
    schedule (``core.overlap``) with the ``choose_chunks`` chunk count,
    all priced by the same alpha-beta model so backend and chunk count
    come from one consistent policy.  The flat per-round model is
    round-order invariant (each round's cost is independent), so the
    schedule keeps the given axis order; ``round_order`` remains an
    empirical knob on the plan (``plan_all_to_all(round_order=...)``).
    """
    axis_links = per_axis_links(axis_links, len(axis_dims))
    p = math.prod(axis_dims)
    slowest = slowest_active_link(axis_dims, axis_links)
    best = Schedule("direct", (p,), (slowest,),
                    predict_direct(p, block_bytes, slowest) + compute_seconds)
    t = predict_factorized(axis_dims, axis_links, block_bytes, p) \
        + compute_seconds
    if t < best.predicted_seconds:
        best = Schedule("factorized", axis_dims, axis_links, t)
    if max_chunks > 1:
        n = choose_chunks(axis_dims, axis_links, block_bytes,
                          max_chunks=max_chunks,
                          compute_seconds=compute_seconds)
        if n > 1:
            t_n = predict_overlapped(axis_dims, axis_links, block_bytes, p,
                                     n, compute_seconds)
            if t_n < best.predicted_seconds:
                best = Schedule("overlap", axis_dims, axis_links, t_n,
                                n_chunks=n)
    return best


def predict_transpose(dims, links, pencil_bytes: float, p: int,
                      kind: str = "factorized") -> float:
    """Alpha-beta prediction for one pencil-decomposition FFT transpose.

    A transpose moves the rank's whole local pencil (``pencil_bytes``)
    re-sharded as ``p`` *uniform* contiguous chunks of ``pencil_bytes/p``
    each — the opposite traffic shape from MoE's many small ragged rows.
    The per-peer block is therefore large, which shifts the alpha-beta
    tradeoff: the factorized algorithm's per-round volume is
    ``(D[k]-1)/D[k] * pencil_bytes`` so its *total* volume exceeds the
    direct algorithm's ``(p-1)/p * pencil_bytes`` — message combining
    only pays when the ``(p-1)`` per-message alphas dominate, i.e. for
    small pencils or very latency-heavy links (DCN axes).
    """
    links = per_axis_links(links, len(dims))
    block = pencil_bytes / p
    if kind == "direct":
        return predict_direct(p, block, slowest_active_link(dims, links))
    if kind == "factorized":
        return predict_factorized(dims, links, block, p)
    raise ValueError(f"unknown transpose kind {kind!r}")


def choose_transpose_algorithm(axis_dims, axis_links, pencil_bytes: float,
                               *, max_chunks: int = 1) -> Schedule:
    """Pencil-aware :func:`choose_algorithm`: pick the backend for a
    pencil transpose from its *whole-pencil* byte count.

    Identical candidate set and cost model as :func:`choose_algorithm`
    with the per-peer block ``pencil_bytes / p`` — kept as its own entry
    point because the transpose regime sits on the other side of the
    crossover from MoE traffic (few large contiguous blocks, so
    ``direct`` wins once the pencil outgrows
    ``p * crossover_block_bytes``), and because the FFT roofline
    (``benchmarks.roofline``) prices strong scaling through it.
    """
    p = math.prod(axis_dims)
    return choose_algorithm(axis_dims, axis_links, pencil_bytes / p,
                            max_chunks=max_chunks)


def crossover_block_bytes(axis_dims, axis_links, lo=1, hi=1 << 30) -> int:
    """Smallest block size for which direct beats the best factorized —
    the paper's empirical ~100-element crossover, derived from the model."""
    def direct_wins(b):
        return choose_algorithm(axis_dims, axis_links, b).kind == "direct"
    if direct_wins(lo):
        return lo
    if not direct_wins(hi):
        return hi
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if direct_wins(mid):
            hi = mid
        else:
            lo = mid
    return hi
