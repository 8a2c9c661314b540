"""Ulysses-style sequence parallelism through the torus all-to-all (port
of ``repro.parallel.ulysses``).

For long-context prefill and training the activations are
sequence-sharded over the SP axis (``model``).  Attention needs whole
sequences per head, so the tiled all-to-all re-shards seq -> heads before
the kernel and heads -> seq after it (DeepSpeed-Ulysses; the factorized
algorithm of the paper when the SP group spans several mesh axes).  GQA:
where the kv heads cannot absorb the SP degree, k and v are all-gathered
along the sequence instead (small beside q under GQA).

The reference's ``shard_map`` body is the function itself here: each
rank passes its own sequence shards and gets its shard of the output.
Under autograd the re-shards are ``A2APlan`` Functions (the backward is
the tiled all-to-all in the other direction) and the kv gather the
all-gather plan's (the backward its reduce-scatter).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cache import mesh_shape
from repro_torch.core.comm import torus_comm
from repro_torch.core.overlap import run_pipelined
from repro_torch.kernels import ops as kops


def _sp_axes(mesh) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("model",) if shape.get(a, 1) > 1)


def _overlap_chunks(cfg, Hkv: int, sp: int) -> int:
    """Head-group chunk count for the pipelined re-shard.

    Chunks are contiguous kv-head groups (their q heads ride along), so
    each chunk's attention is self-contained; each chunk's kv heads must
    still absorb the SP degree: ``Hkv % (sp * n) == 0``.  Shrinks the
    requested count until it is (1 = no chunking)."""
    if cfg.a2a_backend != "overlap":
        return 1
    n = max(1, cfg.a2a_chunks or 2)
    while n > 1 and Hkv % (sp * n):
        n -= 1
    return n


def check_lengths(cfg, shape: dict, lengths: dict | None = None) -> None:
    """Raise ``ValueError`` before anything runs unless Ulysses over
    ``model`` (``cfg.use_ulysses`` on a mesh of ``shape``, ``{dim:
    size}``, whose ``model`` is over 1) can share out ``cfg``'s query
    heads and each sequence length in ``lengths`` (``{what: n}``) over
    ``model``; the message names the length and ``model``."""
    sp = shape.get("model", 1)
    if not cfg.use_ulysses or sp <= 1:
        return
    for what, n in {"n_heads": cfg.n_heads, **(lengths or {})}.items():
        if n % sp:
            raise ValueError(
                f"{cfg.name}: Ulysses over 'model' needs {what} ({n}) "
                f"divisible by model ({sp}) on the mesh {shape}")


def sp_comm(mesh, cfg, axes=None):
    """The SP group's communicator (``torus_comm`` over ``axes``, by
    default ``model`` where it is over 1, in ``cfg.a2a_variant``), or
    None where the SP degree is 1.  Its torus rank is this rank's
    sequence shard."""
    if mesh is None:
        return None
    axes = axes or _sp_axes(mesh)
    if not axes or math.prod(mesh_shape(mesh)[a] for a in axes) == 1:
        return None
    return torus_comm(mesh, axes, variant=cfg.a2a_variant)


def ulysses_attention(q, k, v, cfg, *, causal=True, mesh=None, rules=None,
                      axes=None):
    """q: (B_loc, Hq, S / sp, hd), k, v: (B_loc, Hkv, S / sp, hd), this
    rank's sequence shard (shard ``i`` = the SP comm's torus rank ``i``);
    returns this rank's (B_loc, Hq, S / sp, hd) shard of the attention
    output.  Inside: this rank's ``Hq / sp`` heads over the whole
    sequence, through ``kernels.ops.attention``.  Without a mesh or at
    SP degree 1, attention of the inputs as they are.  Collective over
    the SP group; ``rules`` is accepted for the reference's signature
    (the port's inputs are already this rank's shards)."""
    comm = sp_comm(mesh, cfg, axes)
    if comm is None:
        return kops.attention(q, k, v, causal=causal, window=cfg.window)
    sp = comm.p
    B, Hq, S_loc, hd = q.shape
    Hkv = k.shape[1]
    if Hq % sp:
        raise ValueError(f"Ulysses needs Hq({Hq}) % sp({sp}) == 0")
    kv_a2a = Hkv % sp == 0
    group = Hq // Hkv
    hq_loc = Hq // sp
    n_chunks = _overlap_chunks(cfg, Hkv, sp) if kv_a2a else 1

    # The SP comm is the construction root: one plan per (mesh, SP axes,
    # block, dtype), fetched from the registry on every later layer and
    # step.  The block keys the registry, the pricing and the tuning DB
    # only; a call exchanges whatever shape it is given (k and v too).
    # The re-shard is the factorized tiled all-to-all; under
    # a2a_backend="autotune" the tuning DB's winner for this block.
    backend = "autotune" if cfg.a2a_backend == "autotune" else "factorized"
    plan = comm.all_to_all(block_shape=(B, hq_loc, S_loc, hd),
                           dtype=q.dtype, backend=backend)

    def attend(qh, kh, vh):
        return kops.attention(qh.contiguous(), kh.contiguous(),
                              vh.contiguous(), causal=causal,
                              window=cfg.window)

    if n_chunks > 1:
        # Chunked seq <-> heads re-shard (core.overlap's program order):
        #   reshard chunk c | attention chunk c-1 | reverse-reshard c-2
        def split(a):
            step = a.shape[1] // n_chunks
            return [a[:, i * step:(i + 1) * step] for i in range(n_chunks)]

        states = list(zip(split(q), split(k), split(v)))
        outs = run_pipelined(states, [
            lambda st, _c: tuple(plan.tiled(t, 1, 2) for t in st),
            lambda st, _c: attend(*st),
            lambda oh, _c: plan.tiled(oh, 2, 1, reverse=True)])
        return torch.cat(outs, dim=1)

    # (B, Hq, S_loc, hd) -> this rank's heads over the whole sequence
    qh = plan.tiled(q, split_axis=1, concat_axis=2)
    if kv_a2a:
        kh = plan.tiled(k, 1, 2)
        vh = plan.tiled(v, 1, 2)
    else:
        # GQA with Hkv < sp: gather every kv head along the sequence (the
        # all-gather plan, in torus-rank order, which is sequence order),
        # then take the global kv head of each of this rank's q heads, so
        # the kernel's h // group map stays right
        gather = comm.all_gather(tuple(k.shape), k.dtype)
        idx = torch.div(comm.rank * hq_loc
                        + torch.arange(hq_loc, device=k.device), group,
                        rounding_mode="floor")

        def whole(t):
            parts = gather.forward(t.contiguous())   # (sp, B, Hkv, S_loc, hd)
            return parts.movedim(0, 2).flatten(2, 3).index_select(1, idx)
        kh, vh = whole(k), whole(v)
    oh = attend(qh, kh, vh)
    # back: every head, this rank's sequence shard
    return plan.tiled(oh, 2, 1, reverse=True)
