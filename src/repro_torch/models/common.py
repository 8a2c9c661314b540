"""Parameter specs and common layers (port of ``repro.models.common``).

Parameters are plain nested dicts of tensors, built from a ``ParamSpec``
tree with an explicit ``torch.Generator`` and device.  On a mesh,
:func:`param_shardings` reads the ``logical`` axes: each leaf with an
``"expert"`` dim is split over the expert-parallel group, the dim the
rules resolve to ``model`` over the tensor-parallel group, and the dim
an FSDP rule (``embed_fsdp``) resolves to ``pod`` / ``data`` over those
axes, which the model gathers before each use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` on a machine without a
    card: the port's entry points never fall back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Param specs and trees
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # None -> 1/sqrt(fan_in)
    dtype: Any = None             # None -> model param_dtype
    # read by a sequence-parallel block over ``model`` (Ulysses): held
    # whole over ``model``, each rank's gradient its sequence slice's part
    seq_parallel: bool = False
    # the dim ``model`` splits holds this many equal column groups side by
    # side (a fused ``[xs | z]`` product: 2); rank m holds the m-th slice
    # of each group, so that its columns still pair up.  The global leaf
    # is the reference's; only which columns a rank holds changes.
    column_groups: int = 1

    def initializer(self, generator: torch.Generator, device,
                    param_dtype: torch.dtype) -> torch.Tensor:
        dtype = self.dtype or param_dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init in ("normal", "embed"):
            # the reference's rule, kept as it is: fan-in is the leading
            # dim, which for a stacked spec is the layer count
            fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
            scale = self.scale if self.scale is not None \
                else 1.0 / math.sqrt(max(1, fan_in))
            x = torch.randn(self.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return (x * scale).to(dtype)
        raise ValueError(self.init)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf: Callable | None = None):
    """Map over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in sorted-key order (jax's dict order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k)))
        return out
    return [(prefix, tree)]


def tree_with_leaves(like, values: dict, prefix: str = ""):
    """The tree of ``like`` with the leaf at each path replaced by
    ``values[path]`` (paths as :func:`tree_leaves` gives them)."""
    if isinstance(like, dict):
        return {k: tree_with_leaves(v, values, f"{prefix}/{k}" if prefix
                                    else str(k)) for k, v in like.items()}
    return values[prefix]


def param_shardings(specs, mesh, rules=None):
    """The counterpart of the reference's ``param_shardings`` for a tree
    shaped like ``specs`` on ``mesh``: a
    ``parallel.sharding.ExpertSharding`` that splits the expert dim of
    every leaf whose logical axes name ``"expert"`` over the EP group
    (``ep_axes(mesh)``), and the dim the resolver gives ``model`` under
    ``rules`` (``parallel.sharding.model_dim``: heads, kv heads, the
    FFN's hidden dim, the vocab, the recurrent mixers' channels) over
    ``model``, and the dim an FSDP
    rule resolves to ``pod`` / ``data`` (``parallel.sharding.fsdp_dim``:
    the ``d_model`` dim of the embedding, attention and the dense FFN)
    over the axes the resolver kept.  Expert leaves take no FSDP split:
    the EP split already spans both FSDP axes.  A ``"kv_heads"`` leaf
    kept whole beside a sibling ``"heads"`` leaf that is split is
    ``partial``: each ``model`` rank projects only the kv heads its query
    heads read.  A ``seq_parallel`` leaf (Ulysses attention) is held
    whole over ``model`` and is ``partial`` where ``model`` > 1: each
    ``model`` rank projects only its slice of the sequence."""
    from repro_torch.core.cache import mesh_shape
    from repro_torch.parallel.sharding import (ExpertSharding, ep_axes,
                                               fsdp_dim, model_dim)
    axes, model_axes, fsdp_axes, n_experts = {}, {}, {}, None
    groups, kept = {}, set()
    leaves = tree_leaves(specs)
    for path, spec in leaves:
        if ep_axes(mesh) and "expert" in spec.logical:
            axis = spec.logical.index("expert")
            axes[path] = axis
            if n_experts not in (None, spec.shape[axis]):
                raise ValueError(f"{path}: {spec.shape[axis]} experts, "
                                 f"other leaves {n_experts}")
            n_experts = spec.shape[axis]
        dim = None if spec.seq_parallel else model_dim(
            spec.shape, spec.logical, mesh, rules)
        if dim is not None:
            model_axes[path] = dim
            k, t = spec.column_groups, mesh_shape(mesh)["model"]
            if k > 1:
                if spec.shape[dim] % (k * t):
                    raise ValueError(
                        f"{path}: {k} column groups of "
                        f"{spec.shape[dim] // k} do not split over "
                        f"model={t}")
                groups[path] = k
        split = None if path in axes else fsdp_dim(spec.shape, spec.logical,
                                                   mesh, rules)
        if split is not None:
            fsdp_axes[path] = split[0]
            kept.add(split[1])
    if len(kept) > 1:
        raise NotImplementedError(f"FSDP leaves split over different axes "
                                  f"{sorted(kept)}: one FSDP group only")
    parent = lambda path: path.rpartition("/")[0]
    split_heads = {parent(p) for p, spec in leaves
                   if "heads" in spec.logical and p in model_axes}
    partial = {p for p, spec in leaves if "kv_heads" in spec.logical
               and p not in model_axes and parent(p) in split_heads}
    if mesh_shape(mesh).get("model", 1) > 1:
        partial |= {p for p, spec in leaves if spec.seq_parallel}
    return ExpertSharding(axes, n_experts or 1, mesh, model_axes, partial,
                          fsdp_axes, kept.pop() if kept else (), rules,
                          groups)


def init_params(specs, generator: torch.Generator, device,
                param_dtype: torch.dtype = torch.bfloat16):
    """Concrete parameter tree from a spec tree, drawn leaf by leaf in
    sorted-key order from ``generator`` (which lives on ``device``)."""
    return tree_map(lambda s: s.initializer(generator, device, param_dtype),
                    specs)


def stack_specs(specs, n: int, axis_name: str | None = None):
    """Prepend a layer dimension to every spec (stacked layer params)."""
    return tree_map(lambda s: replace(
        s, shape=(n,) + s.shape, logical=(axis_name,) + s.logical), specs)


# ---------------------------------------------------------------------------
# Numerics / layers
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(dtype)


def dense(x, w, b=None, compute_dtype=torch.bfloat16):
    """x @ w (+ b): inputs rounded to ``compute_dtype``, products summed
    in f32, result in ``compute_dtype``."""
    out = torch.matmul(x.to(compute_dtype).float(),
                       w.to(compute_dtype).float())
    if b is not None:
        out = out + b.float()
    return out.to(compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float = 10000.0):
    return 1.0 / (theta ** (np.arange(0, dh, 2) / dh))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, Dh); positions: (..., S) int absolute positions.
    Rotates the pairs ``(x[..., 0::2], x[..., 1::2])``."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., None].float() * freqs     # (..., S, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, device=None):
    """(max_len, d_model) f32 sinusoidal position table: built in float64
    with numpy and cast to f32, as the reference builds it, so both
    packages add the same bits."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, (2 * (i // 2)) / d_model)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.as_tensor(table.astype(np.float32), device=device)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu(x):
    return F.silu(x.float()).to(x.dtype)


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Per-position loss, f32: ``logsumexp(logits) - logits[label]`` plus
    ``z_loss * logsumexp**2``; logits (..., V), labels (...,) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss


class _VocabParallelCE(torch.autograd.Function):
    """``softmax_cross_entropy`` over logits split along the vocab: each
    rank holds the columns ``lo .. lo + V_loc - 1``.  Forward: one
    all-reduce of the rows' max, one of the sum of exp and the target
    logit.  Backward, with no collective: ``(softmax - onehot + 2 z lse
    softmax) * dce`` on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, pg, lo):
        import torch.distributed as dist
        from repro_torch.parallel.sharding import TP_SPAN
        logits = logits.float()
        V = logits.shape[-1]
        gmax = torch.amax(logits, dim=-1)
        with torch.profiler.record_function(TP_SPAN):
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=pg)
        e = torch.exp(logits - gmax[..., None])
        local = labels.long() - lo
        inside = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1)
        target = torch.gather(logits, -1, idx[..., None])[..., 0]
        sums = torch.stack([e.sum(-1), torch.where(
            inside, target, torch.zeros_like(target))])
        with torch.profiler.record_function(TP_SPAN):
            dist.all_reduce(sums, group=pg)
        lse = torch.log(sums[0]) + gmax
        loss = lse - sums[1]
        if z_loss:
            loss = loss + z_loss * lse ** 2
        ctx.save_for_backward(e / sums[0][..., None], idx, inside, lse)
        ctx.z_loss = z_loss
        return loss

    @staticmethod
    def backward(ctx, dce):
        soft, idx, inside, lse = ctx.saved_tensors
        g = soft
        if ctx.z_loss:
            g = g * (1.0 + 2.0 * ctx.z_loss * lse[..., None])
        onehot = torch.zeros_like(soft).scatter_(
            -1, idx[..., None], inside[..., None].to(soft.dtype))
        return (g - onehot) * dce[..., None], None, None, None, None


def vocab_parallel_cross_entropy(logits, labels, z_loss: float, group,
                                 lo: int):
    """Per-position loss, f32, as :func:`softmax_cross_entropy` of the
    logits gathered over the ``PeerGroup`` ``group``, from this rank's
    vocab columns ``logits`` (..., V_loc) starting at ``lo``; the same
    value on every rank of the group (collective)."""
    return _VocabParallelCE.apply(logits, labels, z_loss, group.pg, lo)
