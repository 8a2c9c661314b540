"""GQA attention: full-sequence (prefill) and KV-cache decode (port of
``repro.models.attention``), with Ulysses sequence parallelism.

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

With ``cfg.use_ulysses`` and ``model`` > 1 the full-sequence path is
sequence-parallel instead (``parallel.ulysses``): the attention leaves
are whole over ``model`` (``ParamSpec.seq_parallel``; their gradients
partial), each rank projects its slice of the sequence, the tiled
all-to-all re-shards seq <-> heads around the kernel, the ``wo`` product
runs on the rank's rows, and the rows are gathered over ``model``
(``parallel.sharding.sp_gather``) back to the replicated ``(B, S, D)``
that the layers after attention take.  Decode runs whole attention on
every rank with a cache of every kv head, as the reference's decode
ignores ``use_ulysses``.

The encoder-decoder's cross-attention (:func:`cross_attention_block`)
splits as self-attention does: under tensor parallelism over the rank's
heads, its query input and the encoder's memory through ``tp_copy``;
under Ulysses over the rank's query rows against the whole memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, apply_rope
from repro_torch.models.remat import dot
from repro_torch.parallel.sharding import (model_dim, sp_gather, tp_copy,
                                           tp_group, tp_rank, tp_reduce)
from repro_torch.parallel.ulysses import sp_comm, ulysses_attention
from .config import ModelConfig


def attn_specs(cfg: ModelConfig) -> dict:
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    sp = cfg.use_ulysses
    specs = {
        "wq": ParamSpec((D, Hq, hd), ("embed_fsdp", "heads", None),
                        seq_parallel=sp),
        "wk": ParamSpec((D, Hkv, hd), ("embed_fsdp", "kv_heads", None),
                        seq_parallel=sp),
        "wv": ParamSpec((D, Hkv, hd), ("embed_fsdp", "kv_heads", None),
                        seq_parallel=sp),
        "wo": ParamSpec((Hq, hd, D), ("heads", None, "embed_fsdp"),
                        seq_parallel=sp),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((Hq, hd), ("heads", None), init="zeros",
                                seq_parallel=sp)
        specs["bk"] = ParamSpec((Hkv, hd), ("kv_heads", None),
                                init="zeros", seq_parallel=sp)
        specs["bv"] = ParamSpec((Hkv, hd), ("kv_heads", None),
                                init="zeros", seq_parallel=sp)
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
    (b) and (c) of the module docstring; every head where the leaves are
    whole over ``model`` (no mesh, or Ulysses)."""
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    whole = HeadLayout(slice(0, Hq), slice(0, Hkv), False, False)
    if mesh is None or cfg.use_ulysses:
        return whole
    specs = attn_specs(cfg)
    q_split = model_dim(specs["wq"].shape, specs["wq"].logical, mesh,
                        rules) is not None
    kv_split = model_dim(specs["wk"].shape, specs["wk"].logical, mesh,
                         rules) is not None
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
    ``model``, or under ``cfg.use_ulysses`` over this rank's sequence
    slice, the rows gathered over ``model``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    comm = sp_comm(mesh, cfg) if cfg.use_ulysses else None
    if comm is not None:
        return _ulysses_block(p, x, cfg, comm, causal, positions, mesh,
                              rules)
    lay = head_layout(cfg, mesh, rules)
    p = _local_heads(p, lay)
    x = tp_copy(x, lay.group)
    q, k, v = _project_qkv(p, x, cfg, positions)        # (B, H, S, hd)
    out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=cfg.window)
    return _out_projection(out, p["wo"], cfg, lay.group)


def cross_attention_block(p, x, memory, cfg: ModelConfig, mesh=None,
                          rules=None, *, decode: bool = False):
    """Encoder-decoder cross attention: queries from x (B, Sq, D), keys
    and values from memory (B, Skv, D), through the layer's ``wq`` /
    ``wk`` / ``wv`` / ``wo``; non-causal, no RoPE, no window (the
    reference passes neither).  Returns (B, Sq, D).

    On a mesh with ``model`` > 1 over this rank's heads
    (:func:`head_layout`, as :func:`attention_block`): ``x`` and
    ``memory`` through ``tp_copy``, the ``wo`` product summed over
    ``model`` in f32.  Under ``cfg.use_ulysses`` (not in ``decode``,
    whose one query row runs whole, as decode attention does) the leaves
    are whole and each rank attends its ``1 / |model|`` of the query
    rows to the whole memory, the rows gathered over ``model`` after
    ``wo``."""
    comm = sp_comm(mesh, cfg) if cfg.use_ulysses and not decode else None
    if comm is not None:
        group = comm.fact.group
        x = tp_copy(x, group)[:, _sp_rows(comm, x.shape[1])]
        y = _cross(p, x, tp_copy(memory, group), cfg, None)
        return sp_gather(y, group, 1)
    lay = head_layout(cfg, mesh, rules)
    return _cross(_local_heads(p, lay), tp_copy(x, lay.group),
                  tp_copy(memory, lay.group), cfg, lay.group)


def _cross(p, x, memory, cfg: ModelConfig, group):
    """Cross attention over the heads of ``p``; the ``wo`` product summed
    over ``group`` (None: not summed)."""
    cd = cfg.cdtype
    x, memory = x.to(cd), memory.to(cd)
    q = _heads(dot(x, p["wq"].to(cd).flatten(1)), p["wq"].shape[1])
    k, v = (_heads(dot(memory, p[w].to(cd).flatten(1)), p[w].shape[1])
            for w in ("wk", "wv"))
    out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=False)
    return _out_projection(out, p["wo"], cfg, group)


def _ulysses_block(p, x, cfg: ModelConfig, comm, causal, positions, mesh,
                   rules):
    """Sequence-parallel attention over ``comm`` (the ``model`` torus):
    this rank's rows ``[i S / sp, (i + 1) S / sp)`` (``i`` its torus
    rank) projected with the whole weights and rotated at their absolute
    positions, attention through the tiled all-to-all, ``wo`` on the
    rows, and every rank's rows gathered back in sequence order."""
    rows = _sp_rows(comm, x.shape[1])
    x = tp_copy(x, comm.fact.group)
    q, k, v = _project_qkv(p, x[:, rows], cfg, positions[:, rows])
    out = ulysses_attention(q, k, v, cfg, causal=causal, mesh=mesh,
                            rules=rules)
    y = _out_projection(out, p["wo"], cfg, None)       # (B, S / sp, D)
    return sp_gather(y, comm.fact.group, 1)


def _sp_rows(comm, S: int) -> slice:
    """This rank's rows of an S-long sequence split over the SP comm
    ``comm`` (the block of its torus rank)."""
    if S % comm.p:
        raise ValueError(f"Ulysses needs the sequence ({S}) divisible by "
                         f"sp ({comm.p})")
    n = S // comm.p
    return slice(comm.rank * n, (comm.rank + 1) * n)


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
