"""Mixture-of-Experts, capacity path, on one device (port of
``repro.models.moe``).

The layouts are the reference's: tokens are scattered into
``(G, E_loc, C, D)`` dispatch blocks (G = 1 expert-group rank here), the
expert FFN is three grouped matmuls (``kernels.ops.expert_matmul``, the
Hopper kernel on a card), and the combine gathers back with the gates.
Expert parallelism over a mesh — the paper's factorized all-to-all
between dispatch and FFN — is the collective slice of ROADMAP.md; dropless
(``capacity_factor=None``) dispatch comes with it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, gelu, silu
from .config import ModelConfig


def moe_specs(cfg: ModelConfig) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((D, E), (None, None), dtype=torch.float32),
        "w1": ParamSpec((E, D, F_), ("expert", "embed_fsdp", "mlp")),
        "w3": ParamSpec((E, D, F_), ("expert", "embed_fsdp", "mlp")),
        "w2": ParamSpec((E, F_, D), ("expert", "mlp", "embed_fsdp")),
    }


def _virtual_weights(w, G: int):
    """(E, ...) -> (G, E_loc, ...) virtual-expert view (reshape or tile)."""
    E = w.shape[0]
    if E >= G:
        return w.reshape(G, E // G, *w.shape[1:])
    R = G // E
    return w.repeat((R,) + (1,) * (w.dim() - 1)).reshape(G, 1, *w.shape[1:])


def _capacity(cfg: ModelConfig, n_tokens: int, n_slots: int) -> int:
    # One expert gets at most n_tokens rows from a device (a token's top_k
    # experts are distinct), so the 8-aligned capacity is clamped there.
    hard = max(1, n_tokens)
    if cfg.capacity_factor is None:
        return hard
    c = math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens / n_slots)
    return min(max(8, -(-c // 8) * 8), hard)


def _moe_inner(x, router_w, w1, w3, w2, *, cfg: ModelConfig, G, E_loc, R,
               C):
    """x: (B, S, D); w*: virtual-expert weights (., E_loc, ...) whose
    first slice is this device's experts (the only slice when G = 1).
    Returns (y (B, S, D), aux loss)."""
    B, S, D = x.shape
    N = B * S
    E = cfg.n_experts
    cd = cfg.cdtype
    dev = x.device
    xt = x.reshape(N, D)
    w1, w3, w2 = w1[0], w3[0], w2[0]

    # ---- routing (f32) ----
    logits = xt.float() @ router_w.float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # ---- per-expert positions (order: token-major, k-minor) ----
    flat_e = expert_idx.reshape(-1)                              # (N*k,)
    onehot = F.one_hot(flat_e, E)
    pos_e = torch.cumsum(onehot, dim=0) - 1                      # inclusive-1
    pos_e = pos_e.gather(1, flat_e[:, None])[:, 0]

    if E >= G:   # experts partitioned over ranks
        v_idx = flat_e // E_loc
        sub_idx = flat_e % E_loc
        slot_pos = pos_e
    else:        # experts replicated R times: round-robin across replicas
        spread = pos_e % R
        v_idx = flat_e + E * spread
        sub_idx = torch.zeros_like(flat_e)
        slot_pos = pos_e // R
    keep = slot_pos < C
    c_idx = torch.where(keep, slot_pos, torch.full_like(slot_pos, C))

    # ---- dispatch scatter into (G, E_loc, C, D); a dropped row lands in
    # the extra slot C, which is cut off (the reference's mode="drop") ----
    tok_idx = torch.arange(N, device=dev).repeat_interleave(cfg.top_k)
    disp = torch.zeros((G, E_loc, C + 1, D), dtype=cd, device=dev)
    disp[v_idx, sub_idx, c_idx] = xt[tok_idx].to(cd)
    recv = disp[:, :, :C]

    # ---- expert FFN: three grouped matmuls ----
    xe = recv.permute(1, 0, 2, 3).reshape(E_loc, G * C, D).contiguous()
    if cfg.act == "swiglu":
        h = silu(kops.expert_matmul(xe, w1.to(cd))) \
            * kops.expert_matmul(xe, w3.to(cd))
    else:
        h = gelu(kops.expert_matmul(xe, w1.to(cd)))
    ye = kops.expert_matmul(h, w2.to(cd))
    back = ye.reshape(E_loc, G, C, D).permute(1, 0, 2, 3)

    # ---- combine: dropped assignments read a zero pad row ----
    pad = torch.zeros((G, E_loc, 1, D), dtype=cd, device=dev)
    backp = torch.cat([back, pad], dim=2)
    yk = backp[v_idx, sub_idx, c_idx].reshape(N, cfg.top_k, D)
    gates = (gate_vals * keep.reshape(N, cfg.top_k)).float()
    y = torch.einsum("nkd,nk->nd", yk.float(), gates)

    # ---- load-balance aux loss (GShard): E * sum_e f_e * P_e ----
    f_e = onehot.float().mean(0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block(p, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, D) -> (y, aux_loss), on one device."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (the factorized all-to-all "
            "dispatch) is the collective slice of ROADMAP.md, not ported "
            "yet; call moe_block with mesh=None")
    if cfg.dropless:
        raise NotImplementedError(
            "dropless MoE (capacity_factor=None) comes with the ragged "
            "all-to-all of ROADMAP.md's collective slice")
    G, E_loc, R = 1, cfg.n_experts, 1
    B, S, _ = x.shape
    C = _capacity(cfg, B * S, max(cfg.n_experts, G))
    return _moe_inner(x, p["router"], _virtual_weights(p["w1"], G),
                      _virtual_weights(p["w3"], G),
                      _virtual_weights(p["w2"], G), cfg=cfg, G=G,
                      E_loc=E_loc, R=R, C=C)
