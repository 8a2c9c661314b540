"""GQA attention: full-sequence (prefill) and KV-cache decode (port of
``repro.models.attention``; no Ulysses).

The full-sequence path goes through ``kernels.ops.attention`` (the flash
kernel on a card).  Decode attention stays plain torch, as the reference
leaves it outside Pallas, and writes the new key/value into the cache in
place (the reference returns an updated copy).

On a mesh with ``model`` > 1 the heads are split over ``model``
(Megatron's column- and row-parallel attention, what GSPMD makes of the
reference's ``heads`` / ``kv_heads`` rules; :func:`head_layout`): each
rank projects its query heads and the kv heads they read, with sliced
weights, runs the kernel on them, and the ``wo`` product's partial sums
are summed over ``model`` in f32 (``parallel.sharding.tp_reduce``); the
input goes through ``tp_copy``, whose backward sums its gradient.  The
resolver's three cases: (a) both head counts divide ``model``; (b) the
query heads divide and the kv heads do not: ``wk`` / ``wv`` / ``bk`` /
``bv`` stay whole and each rank uses the kv heads ``h // (Hq / Hkv)`` of
its query heads ``h`` (their gradients are partial: ``ExpertSharding
.partial``); (c) the query heads do not divide: attention runs whole on
every rank.  The KV cache keeps the kv heads the rank uses.  The
reference's ``seq_sp`` decode layout is an XLA lowering of the same math
and is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, apply_rope
from repro_torch.models.remat import dot
from repro_torch.parallel.sharding import (model_dim, tp_copy, tp_group,
                                           tp_rank, tp_reduce)
from .config import ModelConfig


def attn_specs(cfg: ModelConfig) -> dict:
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": ParamSpec((D, Hq, hd), ("embed_fsdp", "heads", None)),
        "wk": ParamSpec((D, Hkv, hd), ("embed_fsdp", "kv_heads", None)),
        "wv": ParamSpec((D, Hkv, hd), ("embed_fsdp", "kv_heads", None)),
        "wo": ParamSpec((Hq, hd, D), ("heads", None, "embed_fsdp")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((Hq, hd), ("heads", None), init="zeros")
        specs["bk"] = ParamSpec((Hkv, hd), ("kv_heads", None), init="zeros")
        specs["bv"] = ParamSpec((Hkv, hd), ("kv_heads", None), init="zeros")
    return specs


@dataclass(frozen=True)
class HeadLayout:
    """This rank's heads under tensor parallelism: ``q`` the query heads
    (a slice of ``range(Hq)``), ``kv`` the kv heads they read (a slice
    of ``range(Hkv)``, or a list with one kv head per query head where
    the query heads' groups are uneven), whether ``wq`` and ``wk`` are
    held as slices (else whole), and ``group`` the ``model`` group to
    sum the ``wo`` product over (None: attention runs whole)."""
    q: slice
    kv: slice | list
    q_split: bool
    kv_split: bool
    group: object = None

    @property
    def n_q(self) -> int:
        return self.q.stop - self.q.start

    @property
    def n_kv(self) -> int:
        return len(self.kv) if isinstance(self.kv, list) \
            else self.kv.stop - self.kv.start


def head_layout(cfg: ModelConfig, mesh=None, rules=None) -> HeadLayout:
    """The resolver's split of ``attn_specs(cfg)`` on ``mesh``: cases (a),
    (b) and (c) of the module docstring."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    whole = HeadLayout(slice(0, Hq), slice(0, Hkv), False, False)
    if mesh is None:
        return whole
    specs = attn_specs(cfg)
    q_split = model_dim(specs["wq"].shape, specs["wq"].logical, mesh,
                        rules) is not None
    kv_split = model_dim(specs["wk"].shape, specs["wk"].logical, mesh,
                         rules) is not None
    if cfg.use_ulysses and (q_split or kv_split):
        raise NotImplementedError(
            "Ulysses sequence parallelism over 'model' (use_ulysses) is "
            "not ported to repro_torch yet (ROADMAP.md)")
    if not q_split:                                       # case (c)
        return whole
    group = tp_group(mesh)
    m, M = tp_rank(group), group.size
    nq, g = Hq // M, Hq // Hkv
    q = slice(m * nq, (m + 1) * nq)
    if kv_split:                                          # case (a)
        return HeadLayout(q, slice(m * Hkv // M, (m + 1) * Hkv // M), True,
                          True, group)
    idx = [h // g for h in range(q.start, q.stop)]        # case (b)
    used = sorted(set(idx))
    if nq % len(used) == 0 and idx == [used[0] + j // (nq // len(used))
                                       for j in range(nq)]:
        kv = slice(used[0], used[-1] + 1)
    else:
        kv = idx
    return HeadLayout(q, kv, True, False, group)


def _local_heads(p, lay: HeadLayout) -> dict:
    """The projections of this rank's heads: ``p`` as it is where a leaf
    is held as its slice, else the slice of the whole leaf (the kv leaves
    in case (b)), so each projection's output is contiguous."""
    if lay.kv_split or not lay.q_split:
        return p
    out = dict(p)
    for k in ("wk", "wv"):
        out[k] = p[k][:, lay.kv]
    for k in ("bk", "bv"):
        if k in p:
            out[k] = p[k][lay.kv]
    return out


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """x: (B, S, D) -> q (B, Hq, S, hd), k, v (B, Hkv, S, hd) for the
    heads of ``p`` (this rank's, under tensor parallelism)."""
    cd = cfg.cdtype
    x = x.to(cd)
    q, k, v = (_heads(dot(x, p[w].to(cd).flatten(1)), p[w].shape[1])
               for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)[None, :, None, :]
        k = k + p["bk"].to(cd)[None, :, None, :]
        v = v + p["bv"].to(cd)[None, :, None, :]
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _heads(y, n: int):
    """(B, S, n * hd) -> (B, n, S, hd)."""
    B, S, _ = y.shape
    return y.reshape(B, S, n, -1).transpose(1, 2)


def attention_block(p, x, cfg: ModelConfig, *, causal=True, positions=None,
                    mesh=None, rules=None):
    """Full self-attention over x: (B, S, D) -> (B, S, D); on a mesh with
    ``model`` > 1 over this rank's heads, the output summed over
    ``model``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    lay = head_layout(cfg, mesh, rules)
    p = _local_heads(p, lay)
    x = tp_copy(x, lay.group)
    q, k, v = _project_qkv(p, x, cfg, positions)        # (B, H, S, hd)
    out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=cfg.window)
    return _out_projection(out, p["wo"], cfg, lay.group)


def _out_projection(out, wo, cfg: ModelConfig, group):
    """``out @ wo`` over this rank's heads: compute-dtype inputs, f32
    sums.  Under tensor parallelism the partial sums stay f32 until they
    are summed over ``model``, so the result is rounded to the compute
    dtype once, as on one device."""
    cd = cfg.cdtype
    B, _, S, _ = out.shape
    out = out.to(cd).transpose(1, 2).reshape(B, S, -1)
    if group is None:
        return dot(out, wo.to(cd).flatten(0, 1))
    y = dot(out.float(), wo.to(cd).float().flatten(0, 1))
    return tp_reduce(y, group).to(cd)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheSpec:
    """Layout of one layer's KV cache."""
    batch: int
    n_kv: int
    max_seq: int
    head_dim: int
    dtype: torch.dtype

    @property
    def shape(self):
        return (self.batch, self.n_kv, self.max_seq, self.head_dim)


def init_cache(cache_spec: CacheSpec, device):
    """k, v: (B, Hkv, W, hd) zeros; slot_pos[b, s] = absolute position
    stored in slot s (-1 = empty), for linear caches (slot == position)
    and ring buffers (sliding window: slot == position % W) alike."""
    def z():
        return torch.zeros(cache_spec.shape, dtype=cache_spec.dtype,
                           device=device)
    pos_map = torch.full((cache_spec.batch, cache_spec.max_seq), -1,
                         dtype=torch.int32, device=device)
    return {"k": z(), "v": z(), "slot_pos": pos_map}


def decode_attention(p, x, cache, position, cfg: ModelConfig, mesh=None,
                     rules=None):
    """One-token decode: x (B, 1, D); cache {k, v}: (B, Hkv, W, hd) (this
    rank's kv heads on a mesh, :func:`head_layout`); position: (B,) int
    current absolute position.  Returns (y, cache).

    The cache is a ring buffer of W slots: the new key/value overwrite
    slot ``position % W`` **in place**, and masking follows the per-slot
    absolute positions.
    """
    B = x.shape[0]
    W = cache["k"].shape[2]
    position = position.long()
    slot = position % W
    lay = head_layout(cfg, mesh, rules)
    p = _local_heads(p, lay)
    q, k_new, v_new = _project_qkv(p, x, cfg, position[:, None])
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, :, slot] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v_new[:, :, 0].to(cache["v"].dtype)
    cache["slot_pos"][rows, slot] = position.to(cache["slot_pos"].dtype)

    Hq, Hkv = lay.n_q, lay.n_kv
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(cfg.hd)
    qf = q.float().reshape(B, Hkv, group, cfg.hd)
    logits = torch.einsum("bhgk,bhsk->bhgs", qf,
                          cache["k"].float()) * scale      # (B, Hkv, g, W)
    slot_pos = cache["slot_pos"].long()                    # (B, W)
    mask = (slot_pos >= 0) & (slot_pos <= position[:, None])
    if cfg.window is not None:
        mask &= slot_pos > position[:, None] - cfg.window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsk->bhgk", probs, cache["v"].float())
    out = out.reshape(B, Hq, 1, cfg.hd).to(cfg.cdtype)
    return _out_projection(out, p["wo"], cfg, lay.group), cache
