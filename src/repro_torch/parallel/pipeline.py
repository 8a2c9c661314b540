"""Pipeline parallelism: GPipe stages over a mesh axis (port of
``repro.parallel.pipeline``).

Stages live on the ``pod`` axis (or any named axis): stage ``s`` owns
layers ``[s L / S, (s + 1) L / S)``.  Microbatches stream through with
``ppermute`` boundary transfers; the GPipe schedule runs ``S + M - 1``
ticks (bubble fraction ``(S - 1) / (S + M - 1)``).

As in the reference every stage runs the same program (SPMD): at tick
``t`` stage ``s`` computes microbatch ``t - s`` and masks the result
where that is no microbatch.  Under autograd the schedule is
differentiable: each boundary transfer is a ``ppermute`` Function whose
backward sends the cotangent one stage back, and every transfer's result
stays in the graph of every stage's output (stage 0 selects its fresh
microbatch with ``torch.where``, as the reference does, and the stages
before the last write masked zeros into the output), so every stage
reaches every transfer's backward.  The last stage's outputs are
broadcast to every stage; the broadcast's backward keeps the last
stage's own cotangent and gives the others none, since each stage's
copy feeds the same loss (a sum over the stages, the adjoint of the
reference's ``psum``, would count the gradient ``n_stages`` times).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.cache import mesh_shape
from repro_torch.core.comm import torus_comm
from repro_torch.parallel.sharding import collective_device, ppermute


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.last = dist.get_rank() == group.members[-1]
        dev = collective_device(group.pg)
        buf = x.detach().to(dev, copy=True).contiguous()
        dist.broadcast(buf, src=group.members[-1], group=group.pg)
        return buf.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipeline_apply(stage_fn, stage_params, x_microbatches, *, group,
                   n_stages: int):
    """Stage-parallel pipelined application on this rank, a stage of the
    ``PeerGroup`` ``group`` (stage ``i`` = member ``i``).

    Args:
      stage_fn: ``(stage_params, x) -> y``, one stage's computation, with
        ``y.shape == x.shape``.
      stage_params: this stage's parameters (the reference's leading
        stage dim already indexed away).
      x_microbatches: ``(M, mb, ...)`` microbatches, the same on every
        stage; stage 0 consumes them in order.
    Returns:
      ``(M, mb, ...)``, the last stage's outputs, on every stage.
    Collective over ``group`` in both passes."""
    M = x_microbatches.shape[0]
    stage = group.members.index(dist.get_rank())
    dev = x_microbatches.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    carry = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(n_stages + M - 1):
        # stage s works on microbatch t - s where 0 <= t - s < M
        m = t - stage
        x_in = torch.where(first, x_microbatches[min(max(m, 0), M - 1)],
                           carry)
        y = stage_fn(stage_params, x_in)
        y = torch.where(torch.tensor(0 <= m < M, device=dev), y,
                        torch.zeros_like(y))
        if t >= n_stages - 1:
            # the last stage finishes microbatch t - (S - 1); the others
            # write masked zeros, which keep their own schedule in the
            # graph of the output (their backward must reach every
            # transfer)
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < n_stages + M - 2:
            # downstream: stage s -> s + 1 (the wrap-around edge lands on
            # stage 0, which selects its fresh microbatch instead)
            carry = ppermute(y, group, perm)
    return _FromLast.apply(torch.stack(outs), group)


def make_pipelined_forward(stage_fn, mesh, *, axis: str = "pod",
                           n_microbatches: int = 4):
    """``run(stage_params, x)``: the pipelined forward over ``axis`` of
    ``mesh`` on this rank's stage parameters, ``x`` ``(B, ...)`` the same
    on every stage and cut into ``n_microbatches``; returns ``(B, ...)``
    on every stage.  ``stage_fn(stage_params, x) -> y`` with ``y.shape ==
    x.shape`` (a residual block stack)."""
    n_stages = mesh_shape(mesh)[axis]
    group = torus_comm(mesh, (axis,)).fact.group if n_stages > 1 else None

    def run(stage_params, x):
        B = x.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} not divisible into "
                             f"{n_microbatches} microbatches")
        mbs = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
        if group is None:
            out = torch.stack([stage_fn(stage_params, mb) for mb in mbs])
        else:
            out = pipeline_apply(stage_fn, stage_params, mbs, group=group,
                                 n_stages=n_stages)
        return out.reshape(B, *x.shape[1:])

    return run


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
