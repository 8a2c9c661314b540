"""Gradient transforms (port of ``repro.optim.transforms``): the global
norm (over a sharded tree too) and clipping by it, the int8
block-quantized gradient all-reduce, and replica tying.

``compressed_psum`` is the trick for slow data-parallel links: each
rank quantizes its gradients blockwise to int8, the int8 payloads and
the per-block f32 scales are all-gathered, and every rank sums the
dequantized terms itself, so the only error is each rank's own int8
rounding.  The reference runs it inside ``shard_map``; here it runs on a
``torch.distributed`` group (a ``TorusComm``, a ``PeerGroup`` or a
process group).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_with_leaves


def global_norm(tree, sharding=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor).

    With ``sharding`` (a ``parallel.sharding.ExpertSharding`` for the
    tree on a mesh) the norm is that of the global tree, the same on
    every rank: the squares of the expert leaves are summed over the EP
    group and divided by the replica count R, those of the leaves split
    over ``model`` summed over ``model``, those of the FSDP shards over
    the FSDP group, and each whole leaf counts once
    (``ExpertSharding.tree_sq_sum``: collective)."""
    leaves = tree_leaves(tree)
    sq = [torch.sum(torch.square(x.float())) for _, x in leaves]
    if sharding is None or not (sharding.axes or sharding.model_axes
                                or sharding.fsdp_axes):
        return torch.sqrt(torch.sum(torch.stack(sq)))
    return torch.sqrt(sharding.tree_sq_sum(
        [(p, s) for (p, _), s in zip(leaves, sq)]))


def clip_by_global_norm(tree, max_norm: float, gnorm=None):
    """Each leaf times ``min(1, max_norm / (gnorm + 1e-12))``, computed in
    f32 and cast back to the leaf's dtype."""
    gnorm = global_norm(tree) if gnorm is None else gnorm
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)


# ---------------------------------------------------------------------------
# int8 block-quantized gradient compression
# ---------------------------------------------------------------------------


def _quantize_int8(x, block: int = 256):
    """Blockwise symmetric int8 quantization; returns (q, scales, shape):
    ``q`` int8 ``(n_blocks, block)``, ``scales`` f32 ``(n_blocks, 1)``."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape)


def _dequantize_int8(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_dequantize(tree, block: int = 256):
    """The quantize -> dequantize round trip on every leaf of at least
    ``block`` elements: the compressed all-reduce's noise without the
    collective."""
    def f(x):
        if x.dim() == 0 or x.numel() < block:
            return x
        q, s, sh = _quantize_int8(x, block)
        return _dequantize_int8(q, s, sh).to(x.dtype)
    return tree_map(f, tree)


def _process_group(group):
    """The process group of a ``TorusComm``, a ``PeerGroup`` or a process
    group (None: the world)."""
    fact = getattr(group, "fact", None)
    if fact is not None:
        group = fact.group
    return getattr(group, "pg", group)


def compressed_psum(tree, group=None, block: int = 256):
    """int8-compressed sum of every leaf over ``group`` (collective: every
    rank of it, leaf by leaf in path order).

    A leaf of at least ``block`` elements is quantized here (int8 and a
    f32 scale per block), the payloads and scales are all-gathered (int8
    stays int8 on the wire) and the sum of the dequantized terms is
    formed in group rank order, so every rank gets the same bits; the
    result is the exact sum of the ranks' quantized gradients.  Smaller
    leaves are all-reduced as they are.  Wire bytes: ``n * (size + 4 *
    size / block)`` against about ``4 * size`` for a ring bf16
    all-reduce."""
    pg = _process_group(group)
    n = dist.get_world_size(pg)

    def f(x):
        if x.dim() == 0 or x.numel() < block:
            out = x.clone()
            dist.all_reduce(out, group=pg)
            return out
        q, scale, shape = _quantize_int8(x, block)
        q_all = q.new_empty((n * q.shape[0], block))
        s_all = scale.new_empty((n * scale.shape[0], 1))
        dist.all_gather_into_tensor(q_all, q, group=pg)
        dist.all_gather_into_tensor(s_all, scale, group=pg)
        total = torch.sum((q_all.float() * s_all).reshape(n, *q.shape),
                          dim=0)
        return total.reshape(-1)[:x.numel()].reshape(shape).to(x.dtype)
    return tree_map(f, tree)


def tie_expert_replica_grads(grads_tree, n_replicas: int,
                             keys=("w1", "w3", "w2")):
    """Average the gradients of tiled expert replicas: a leaf named in
    ``keys`` whose leading dim holds ``n_replicas`` copies of ``E``
    experts gets each expert's mean over its copies, tiled back (the
    reference's stored-virtual MoE variant; the port's EP training ties
    replicas through ``ExpertSharding.sum_replicas`` instead)."""
    if n_replicas <= 1:
        return grads_tree

    def f(path, g):
        name = path.rsplit("/", 1)[-1]
        if name not in keys or g.dim() < 1 or g.shape[0] % n_replicas:
            return g
        E = g.shape[0] // n_replicas
        avg = g.reshape(n_replicas, E, *g.shape[1:]).mean(0)
        return avg.repeat((n_replicas,) + (1,) * (g.dim() - 1))
    return tree_with_leaves(grads_tree, {p: f(p, g) for p, g
                                         in tree_leaves(grads_tree)})
