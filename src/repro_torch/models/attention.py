"""GQA attention: full-sequence (prefill) and KV-cache decode (port of
``repro.models.attention``, one device: no Ulysses, no sharding).

The full-sequence path goes through ``kernels.ops.attention`` (the flash
kernel on a card).  Decode attention stays plain torch, as the reference
leaves it outside Pallas, and writes the new key/value into the cache in
place (the reference returns an updated copy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, apply_rope
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


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """x: (B, S, D) -> q (B, Hq, S, hd), k, v (B, Hkv, S, hd)."""
    cd = cfg.cdtype
    x = x.to(cd)
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)[None, :, None, :]
        k = k + p["bk"].to(cd)[None, :, None, :]
        v = v + p["bv"].to(cd)[None, :, None, :]
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg: ModelConfig, *, causal=True, positions=None):
    """Full self-attention over x: (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)        # (B, H, S, hd)
    out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=cfg.window)
    return torch.einsum("bhsk,hkd->bsd", out.to(cfg.cdtype),
                        p["wo"].to(cfg.cdtype))


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


def decode_attention(p, x, cache, position, cfg: ModelConfig):
    """One-token decode: x (B, 1, D); cache {k, v}: (B, Hkv, W, hd);
    position: (B,) int current absolute position.  Returns (y, cache).

    The cache is a ring buffer of W slots: the new key/value overwrite
    slot ``position % W`` **in place**, and masking follows the per-slot
    absolute positions.
    """
    B = x.shape[0]
    W = cache["k"].shape[2]
    position = position.long()
    slot = position % W
    q, k_new, v_new = _project_qkv(p, x, cfg, position[:, None])
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, :, slot] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v_new[:, :, 0].to(cache["v"].dtype)
    cache["slot_pos"][rows, slot] = position.to(cache["slot_pos"].dtype)

    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
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
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(cfg.cdtype))
    return y, cache
