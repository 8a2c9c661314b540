"""Ring attention: sequence-sharded exact attention by neighbour exchange
(port of ``repro.parallel.ring_attention``).

The alternative to Ulysses for long-context prefill: q stays put, the kv
shards rotate around the SP axis with ``ppermute`` (neighbour traffic,
the dimension-local discipline the paper's algorithm keeps), and the
partial softmax statistics merge online (flash-style).  Per step one kv
shard goes to one neighbour: p - 1 rounds of nearest-neighbour traffic
instead of one all-to-all, the latency / bandwidth dual of the paper's
trade-off.  Masks use the absolute positions of the rotating shard.  k
and v travel stacked, one exchange a step where the reference makes
two.

The partial products are plain torch with f32 sums, as the reference's
are plain ``einsum`` s outside any Pallas kernel.  The reference's
``shard_map`` body is the function itself: each rank passes its own
sequence shards.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cache import mesh_shape
from repro_torch.core.comm import torus_comm
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import ppermute


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two partial flash-attention states (m, l, unnormalised o)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _partial_attn(q, k, v, q_pos, k_pos, *, scale, causal, window):
    """Unnormalised attention of q against one kv shard, f32 sums.
    q: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd).  Returns (m, l, o)."""
    B, Hq, Sq, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return m, l, o


def ring_attention(q, k, v, cfg=None, *, causal=True, window=None,
                   mesh=None, axis: str = "model", rules=None):
    """q: (B_loc, Hq, S / n, hd), k, v: (B_loc, Hkv, S / n, hd), this
    rank's sequence shard over ``axis`` (shard ``i`` = its coordinate
    ``i``); returns its shard of the attention output, exact (equal to
    whole-sequence attention).  Without a mesh or at ``axis`` size 1,
    ``kernels.ops.attention`` of the inputs.  Collective over ``axis``
    in both passes (the backward rotates the cotangents back); ``rules``
    is accepted for the reference's signature."""
    window = window if window is not None else \
        (cfg.window if cfg is not None else None)
    if mesh is None or mesh_shape(mesh).get(axis, 1) == 1:
        return kops.attention(q, k, v, causal=causal, window=window)
    comm = torus_comm(mesh, (axis,))
    group, n, rank = comm.fact.group, comm.p, comm.rank
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, Hq, Sl, hd = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    ar = torch.arange(Sl, device=q.device)
    q_pos = rank * Sl + ar

    m = torch.full((B, Hkv, g, Sl), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, g, Sl), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hkv, g, Sl, hd), dtype=torch.float32,
                    device=q.device)
    kv_rank = rank
    # k and v rotate as one tensor: one exchange a step, and one order of
    # the backward's exchanges on every rank
    kv = torch.stack((k, v))
    perm = [(i, (i - 1) % n) for i in range(n)]          # rotate left
    for step in range(n):
        m2, l2, o2 = _partial_attn(q, kv[0], kv[1], q_pos,
                                   kv_rank * Sl + ar, scale=scale,
                                   causal=causal, window=window)
        m, l, o = _merge(m, l, o, m2, l2, o2)
        if step < n - 1:
            kv = ppermute(kv, group, perm)
            kv_rank = (kv_rank + 1) % n
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / safe[..., None]).reshape(B, Hq, Sl, hd)
    return out.to(q.dtype)
