"""Plain PyTorch oracles of the kernels (port of ``repro.kernels.ref``).

Each function is the mathematical specification its kernel is held to;
the kernel modules' plain versions are built on these.
"""

from __future__ import annotations

import math

import torch


def ref_attention(q, k, v, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None,
                  kv_offset: int = 0):
    """Multi-head attention with GQA, causal and sliding-window masking.

    q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh) with Hq % Hkv == 0.
    ``window``: keys within [r - window + 1, r]; ``kv_offset``: absolute
    position of q[0] relative to k[0].  Logits are exact f32 sums of the
    inputs' products; probabilities are rounded to v's dtype before the
    value product, as in the reference.  Fully masked rows give 0.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, group, Sq, Dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    rows = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)         # fully masked rows
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Hq, Sq, Dh).to(q.dtype)


def ref_gmm(lhs, rhs):
    """Grouped (per-expert) matmul in f32: (E, C, K) x (E, K, N) ->
    (E, C, N) in lhs's dtype."""
    out = torch.einsum("eck,ekn->ecn", lhs.float(), rhs.float())
    return out.to(lhs.dtype)
