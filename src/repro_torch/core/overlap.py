"""Overlap engine: chunked round / compute software pipelining on
``torch.distributed`` (port of ``repro.core.overlap``).

The payload is split into chunks, and each chunk runs the stages

    [round k0, ..., round k_{d-1}] (+ [compute]) (+ [rev k'0, ..., k'_{d-1}])

in the order :func:`pipeline_order` emits: stage ``s`` of chunk ``c`` at
step ``t = c + s``, deepest stage first within a step, so chunk ``c``'s
exchange of one round sits next to chunk ``c-1``'s compute and chunk
``c-2``'s reverse round.  Chunks never interact, so the result is bit for
bit that of the factorized all-to-all (+ ``compute_fn`` + the reverse
all-to-all) on the whole payload.

In JAX that program order is all the engine does: XLA's scheduler
overlaps the independent ops.  Eager torch has no scheduler, so here each
round's ``all_to_all_single`` is issued with ``async_op=True``; the chunk
keeps the ``Work`` with its send and receive buffers until the stage that
consumes it calls ``wait()`` (the allocator must not hand the buffers to
another chunk while the exchange reads or writes them), and the other
chunks' stages run on the host meanwhile.  ``compute_fn`` runs on the
current stream.

Per chunk the reorders are the factorized algorithm's
(``core.factorized.round_schedule``): the pack of the first round, one
fused unpack-then-pack at each boundary between rounds, the unpack of the
last, identity passes skipped; a chunk makes them once per direction.
A chunk is a slice of the payload, which the first pack reads as a
contiguous ``(p, B / n)`` buffer: slicing a strided view (every chunk
axis but the leading one) copies it, counted in ``overlap.chunk_copies``
(``core.telemetry``); joining more than one chunk's output into the
result is a second full-buffer copy, counted in ``overlap.concat_copies``.

Under autograd a call is one :class:`OverlapFn` (``overlap_autograd``).
Its forward is the pipeline above, keeping each chunk as it arrives for
the compute stage (the reference's ``checkpoint_name(chunk,
"moe_recv")``).  Its backward runs the same pipeline on the cotangent
(a compute stage under autograd needs the reverse rounds after it):
per chunk the forward-direction rounds (the adjoint of the reverse
rounds: a blockwise all-to-all is its own transpose), then the vjp of
``compute_fn`` on the kept chunk, recomputed under ``enable_grad`` with
the parameters' gradients summed over the chunks, then the reverse
rounds.  So the backward overlaps as the forward does and launches the
same passes.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from . import telemetry
from .factorized import (_active, _check_order, _reorder, _tiled,
                         round_schedule)

# ---------------------------------------------------------------------------
# Generic software-pipeline scheduler
# ---------------------------------------------------------------------------


def pipeline_order(n_chunks: int, n_stages: int):
    """Emission order of the software pipeline: yields ``(chunk, stage)``.

    Stage ``s`` of chunk ``c`` runs at step ``t = c + s``; within a step the
    deepest stage (oldest chunk) is emitted first, so a 2-chunk, 5-stage
    program (2 fwd rounds, compute, 2 rev rounds) reads

        c0.r0 | c0.r1 c1.r0 | c0.comp c1.r1 | c0.rev0 c1.comp | ...
    """
    for t in range(n_chunks + n_stages - 1):
        for c in range(n_chunks):
            s = t - c
            if 0 <= s < n_stages:
                yield c, s


def run_pipelined(states: Sequence, stages: Sequence[Callable]):
    """Run every chunk state through every stage in pipelined program order.

    ``stages[s]`` is called as ``stages[s](state, chunk_index)`` and returns
    the new state.  The result is that of running each chunk's stages back
    to back.
    """
    states = list(states)
    for c, s in pipeline_order(len(states), len(stages)):
        states[c] = stages[s](states[c], c)
    return states


# ---------------------------------------------------------------------------
# Per-round stage construction (the torus round schedule)
# ---------------------------------------------------------------------------


class _Chunk:
    """One chunk in flight: its ``(p, B)`` buffer, the exchange filling it
    (``work``, with the buffer it sends), and ``tail``, the unpack that
    ends a direction whose last exchange is still in flight."""

    __slots__ = ("buf", "send", "work", "tail")

    def __init__(self, buf):
        self.buf, self.send, self.work, self.tail = buf, None, None, None

    def settle(self):
        """The chunk's buffer in torus layout: wait for its exchange and
        run the pending unpack."""
        if self.work is not None:
            self.work.wait()
            self.work = self.send = None
        if self.tail is not None:
            self.buf, self.tail = self.tail(self.buf), None
        return self.buf


def _round_stages(sizes, groups, variant, order):
    """One stage per round of ``order``: the reorder pass at the round's
    start (the pack, or the fused boundary after the previous round) and
    the round's exchange, issued asynchronously.  The last stage leaves
    the direction's unpack as the chunk's ``tail``."""
    d = len(order)
    if not d:
        return []
    passes = round_schedule(sizes, order, variant)

    def unpack(buf):
        ku = order[-1]
        return _reorder(buf, sizes, variant, ku, None, groups,
                        (ku, None) in passes)

    def stage(e):
        ku = order[e - 1] if e else None
        kp = order[e]

        def run(st, _c):
            buf = _reorder(st.settle(), sizes, variant, ku, kp, groups,
                           (ku, kp) in passes)
            st.send, st.buf = buf, torch.empty_like(buf)
            st.work = dist.all_to_all_single(st.buf, buf,
                                             group=groups[kp].pg,
                                             async_op=True)
            if e == d - 1:
                st.tail = unpack
            return st
        return run

    return [stage(e) for e in range(d)]


def _split_chunks(x, axis, n_chunks):
    """Split ``x`` along ``axis`` into the largest feasible number of equal
    chunks <= ``n_chunks`` (shrink until the axis size divides)."""
    size = x.shape[axis]
    n = max(1, min(n_chunks, size))
    while size % n:
        n -= 1
    return [x] if n == 1 else list(torch.split(x, size // n, dim=axis))


# ---------------------------------------------------------------------------
# The overlapped all-to-all
# ---------------------------------------------------------------------------


def _overlapped_impl(x, fact, *, n_chunks: int = 2,
                     variant: str = "natural", round_order=None,
                     compute_fn: Callable | None = None,
                     reverse: bool = False, reverse_round_order=None,
                     chunk_axis: int | None = None):
    """Chunked, software-pipelined factorized all-to-all with an optional
    per-chunk compute stage and reverse (combine) all-to-all.

    Args:
      x: local ``(p, *block)`` tensor; block ``i`` is destined for torus
        rank ``i``.
      fact: the mesh-backed factorization (dims and communicators).
      n_chunks: target chunk count (shrunk to a divisor of the chunked
        extent; 1 runs the whole payload as one chunk).
      variant: "natural" or "paper".
      round_order: forward round permutation (default ``range(d)``).
      compute_fn: optional ``f(chunk, chunk_index) -> chunk`` applied to
        each chunk after its forward rounds, on the ``(p, *chunk_block)``
        layout; it must keep the chunk's shape.
      reverse: a second (combine-direction) all-to-all after the compute
        stage, the MoE dispatch / combine shape.
      reverse_round_order: its rounds (default: the forward order
        reversed).
      chunk_axis: which axis of ``x`` (>= 1) to chunk.  Default: the
        trailing payload, flattened.

    Returns ``(p, *block)``, bit for bit the composition of the
    factorized all-to-all, ``compute_fn`` and the reverse all-to-all on
    the whole payload.
    """
    sizes, groups = _active(fact, x)
    d = len(sizes)
    p = fact.p
    order = _check_order(round_order, d)
    rev_order = (tuple(reversed(order)) if reverse_round_order is None
                 else _check_order(reverse_round_order, d))

    if chunk_axis is None:
        payload = math.prod(x.shape[1:]) if x.dim() > 1 else 1
        chunks = _split_chunks(x.reshape(p, payload), 1,
                               n_chunks if payload else 1)
    else:
        if not 1 <= chunk_axis < x.dim():
            raise ValueError(f"chunk_axis {chunk_axis} out of range for "
                             f"rank-{x.dim()} operand")
        chunks = _split_chunks(x, chunk_axis, n_chunks)

    stages = _round_stages(sizes, groups, variant, order)
    if compute_fn is not None:
        def compute_stage(st, c):
            shape = (p,) + chunks[c].shape[1:]
            out = compute_fn(st.settle().reshape(shape), c)
            if tuple(out.shape) != shape:
                raise ValueError(f"compute_fn changed the chunk's shape "
                                 f"{shape} to {tuple(out.shape)}")
            st.buf = out.reshape(p, -1).contiguous()
            return st
        stages.append(compute_stage)
    if reverse:
        stages.extend(_round_stages(sizes, groups, variant, rev_order))

    copies = sum(not c.is_contiguous() for c in chunks)
    if copies:
        telemetry.metrics().counter("overlap.chunk_copies").inc(copies)
    states = [_Chunk(c.reshape(p, -1).contiguous()) for c in chunks]
    outs = [st.settle().reshape(c.shape)
            for st, c in zip(run_pipelined(states, stages), chunks)]
    if len(outs) == 1:
        return outs[0].reshape(x.shape)
    telemetry.metrics().counter("overlap.concat_copies").inc()
    if chunk_axis is None:
        return torch.cat(outs, dim=1).reshape(x.shape)
    return torch.cat(outs, dim=chunk_axis)


def _overlapped_tiled_impl(x, fact, split_axis, concat_axis, *,
                           n_chunks: int = 2, variant: str = "natural",
                           round_order=None):
    """Tiled-semantics overlapped all-to-all: the MoE-dispatch and
    Ulysses re-shard form, with the payload chunked and the rounds of
    different chunks interleaved."""
    return _tiled(x, fact, split_axis, concat_axis,
                  lambda xb: _overlapped_impl(xb, fact, n_chunks=n_chunks,
                                              variant=variant,
                                              round_order=round_order))


# ---------------------------------------------------------------------------
# The overlapped all-to-all under autograd
# ---------------------------------------------------------------------------


class OverlapFn(torch.autograd.Function):
    """The overlap engine as one autograd node.  ``run(t, fn)`` is the
    plan's pipeline on ``t`` with compute stage ``fn`` (traced or not).
    The kept chunks are saved with ``save_for_backward``, so under
    non-reentrant checkpointing they are recomputed, not held."""

    @staticmethod
    def forward(ctx, x, run, compute_fn, *params):
        kept = {}
        keep = None
        if compute_fn is not None:
            def keep(chunk, c):
                kept[c] = chunk
                return compute_fn(chunk, c)
        y = run(x, keep)
        ctx.run, ctx.compute_fn, ctx.n_kept = run, compute_fn, len(kept)
        ctx.save_for_backward(*(kept[c] for c in range(len(kept))),
                              *params)
        return y

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        kept, params = saved[:ctx.n_kept], saved[ctx.n_kept:]
        fn = ctx.compute_fn
        pgrads = [None] * len(params)

        def vjp(gc, c):
            with torch.enable_grad():
                xc = kept[c].detach().requires_grad_(True)
                out = fn(xc, c)
            got = torch.autograd.grad(out, (xc,) + tuple(params), gc,
                                      allow_unused=True)
            for i, gp in enumerate(got[1:]):
                if gp is not None:
                    pgrads[i] = gp if pgrads[i] is None else pgrads[i] + gp
            return torch.zeros_like(xc) if got[0] is None else got[0]

        # the pipeline's own shape on the cotangent: rounds, vjp, rounds
        gx = ctx.run(g.contiguous(), None if fn is None else vjp)
        return (gx, None, None, *pgrads)


def overlap_autograd(x, run, compute_fn, *, reverse: bool, params=()):
    """``run(x, compute_fn)`` (an overlap plan's pipeline) as one
    :class:`OverlapFn`, whose backward gives ``x`` and ``params`` (the
    tensors ``compute_fn`` reads that need gradients) theirs.  A compute
    stage needs the reverse rounds after it: the backward runs the
    pipeline itself on the cotangent."""
    if compute_fn is not None and not reverse:
        raise NotImplementedError(
            "overlap(compute_fn=..., reverse=False) under autograd: its "
            "backward would run the compute stage before the rounds, "
            "which the pipeline does not; pass reverse=True")
    return OverlapFn.apply(x, run, compute_fn, *params)
