"""Remat policies of the superblock checkpoint (port of the reference's
``remat_policy_of``: ``nothing``, ``dots``, ``collectives``).

JAX names what a remat keeps by a policy over the traced program
(``dots_with_no_batch_dims_saveable``, ``save_only_these_names`` over the
values ``checkpoint_name`` marks).  Eager torch has no traced program, and
the port's exchanges are autograd Functions over host calls and ctypes
kernels that no selective-checkpoint policy sees as one op.  So the port
marks the kept values at their call sites, as the reference's
``checkpoint_name`` does, and runs each superblock under
``torch.utils.checkpoint`` (non-reentrant) with a context pair over one
:class:`_Tape`:

* in the forward, a marked value whose name the policy keeps is computed
  and kept on the tape (a detached reference, no copy);
* in the backward's recompute, the same call site returns the kept value
  and runs nothing: no product, no exchange, no kernel.

What the skipped call saved for its own backward must still be there:

* ``dot`` (every product the reference writes without batch dims: the
  q/k/v/o projections, the router, the dense FFN, and the ``model``-
  parallel ones) is one :class:`_Dot` Function, which saves its two
  operands.  In the recompute it saves the recomputed operands again
  without multiplying, so the checkpoint's saved-tensor slots fill in the
  same order and the inputs are recomputed, as JAX recomputes them.
* ``saved(name, fn)`` (the MoE's ``moe_recv`` / ``moe_back``) runs ``fn``
  under identity saved-tensor hooks when the policy keeps ``name``: what
  the exchange's Function saves (the overlap engine's kept chunks, the
  reference's per-chunk ``moe_recv``) is held as it is instead of being
  recomputed, so the recompute need not run the exchange at all.

The recompute's other ops see the kept values with the original's
``requires_grad``, so they save the same tensors in the same order; the
values are the forward's bits, so every policy gives the gradients of
``remat=False`` bit for bit.  ``dot`` runs the same two products in every
mode (``remat=False`` included), so the policies differ in what is kept
and recomputed, never in a value.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

POLICIES = ("nothing", "dots", "collectives")
# the names each policy keeps ("dot": the products without batch dims)
_KEPT = {"nothing": frozenset(), "dots": frozenset({"dot"}),
         "collectives": frozenset({"moe_recv", "moe_back"})}

_ACTIVE: list = []          # the tape of the checkpoint being run, if any


class _Tape:
    """The values one checkpointed call keeps, in call order: recorded in
    the forward, replayed (from the start) in each recompute."""

    def __init__(self, names):
        self.names = names
        self.values: list = []
        self.replaying = False
        self.cursor = 0

    def record(self, name, value):
        tensors = value if isinstance(value, tuple) else (value,)
        self.values.append((name, isinstance(value, tuple), [
            (t.detach(), t.requires_grad, t._version) for t in tensors]))

    def replay(self, name):
        got, is_tuple, kept = self.values[self.cursor]
        self.cursor += 1
        if got != name:
            raise RuntimeError(f"remat recompute asked for {name!r} where "
                               f"the forward kept {got!r}")
        out = []
        for t, grad, version in kept:
            if t._version != version:
                raise RuntimeError(f"remat: the kept {name!r} was modified "
                                   "in place after the forward")
            out.append(t.detach().requires_grad_(grad) if grad else t)
        return tuple(out) if is_tuple else out[0]

    @contextlib.contextmanager
    def mode(self, replaying: bool):
        self.replaying, self.cursor = replaying, 0
        _ACTIVE.append(self)
        try:
            yield
        finally:
            _ACTIVE.pop()


def _tape(name):
    """The active tape if it keeps ``name``, else None."""
    if _ACTIVE and name in _ACTIVE[-1].names:
        return _ACTIVE[-1]
    return None


def checkpointed(fn, *args, policy: str = "nothing"):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint`` with
    the remat ``policy``."""
    if policy not in _KEPT:
        raise ValueError(f"unknown remat_policy {policy!r}; expected one of "
                         f"{POLICIES}")
    if not _KEPT[policy]:
        return checkpoint(fn, *args, use_reentrant=False)
    tape = _Tape(_KEPT[policy])
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (tape.mode(False), tape.mode(True)))


def _keep(t):
    return t


def saved(name: str, fn):
    """``fn()`` (a tensor or a tuple of them) under the name the
    reference gives it with ``checkpoint_name``: kept by a policy that
    names it, then not rerun by the recompute."""
    tape = _tape(name)
    if tape is None:
        return fn()
    if tape.replaying:
        return tape.replay(name)
    with torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
        out = fn()
    tape.record(name, out)
    return out


def _product(x, w):
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1],
                                                    w.shape[1])


class _Dot(torch.autograd.Function):
    """``x @ w`` over the last dim of ``x`` (``w`` 2-D), saving both
    operands; with ``out`` (a kept result) it saves them and returns
    ``out`` without multiplying.  The backward is autograd's for ``mm``."""

    @staticmethod
    def forward(ctx, x, w, out):
        ctx.save_for_backward(x, w)
        return _product(x, w) if out is None else out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = (g2 @ w.t()).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, x.shape[-1]).t() @ g2 \
            if ctx.needs_input_grad[1] else None
        return gx, gw, None


def dot(x, w):
    """``x @ w``, ``x`` (..., K), ``w`` (K, N): a product the reference
    writes without batch dims, which the ``dots`` policy keeps."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return _product(x, w)
    tape = _tape("dot")
    if tape is not None and tape.replaying:
        return _Dot.apply(x, w, tape.replay("dot"))
    out = _Dot.apply(x, w, None)
    if tape is not None:
        tape.record("dot", out)
    return out


SCAN_CHUNK = 64            # steps per call of the per-step recurrences


def chunked_scan(fn, carry, xs, consts=(), *, chunk: int = SCAN_CHUNK,
                 remat: bool):
    """``lax.scan`` over dim 1 of every tensor in ``xs``, ``chunk`` steps
    per call of ``fn(carry, *xs_chunk, *consts) -> (carry, ys)``, with
    ``ys`` (B, T, ...) joined over dim 1.  With ``remat`` and under
    autograd each call runs inside ``torch.utils.checkpoint``
    (non-reentrant): backward keeps only the carry between chunks and
    recomputes each chunk's steps, as the reference's per-step
    ``jax.checkpoint`` keeps only the carried state; the recompute
    repeats the forward's arithmetic, so the gradients are those of the
    unrematted scan."""
    remat = remat and torch.is_grad_enabled()
    S = xs[0].shape[1]
    ys = []
    for s in range(0, S, chunk):
        args = (carry, *(x[:, s:s + chunk] for x in xs), *consts)
        carry, y = checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)
        ys.append(y)
    return carry, ys[0] if len(ys) == 1 else torch.cat(ys, 1)
