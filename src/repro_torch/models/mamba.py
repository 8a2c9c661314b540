"""Mamba (selective SSM) block, jamba's mixer layer (port of
``repro.models.mamba``).

Training / prefill run the selective recurrence over time with the state
``(B, Ein, n)`` in f32; decode is the same recurrence for one step, which
keeps a token's cost O(1) in the context.  Where the reference scans one
step at a time, the port runs :func:`remat.chunked_scan`: the
input-dependent factors ``exp(dt A)`` and ``dt B x`` of
``remat.SCAN_CHUNK`` steps are formed at once (elementwise, the
reference's arithmetic), then the steps run in a Python loop, two ops
each.  Under autograd with
``cfg.recurrent_step_remat`` each chunk is checkpointed, so
backpropagation through time keeps only the carried state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, silu
from repro_torch.models.remat import chunked_scan, dot
from .config import ModelConfig


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Ein = cfg.ssm_expand * D
    n = cfg.ssm_state
    r = _dt_rank(cfg)
    return {
        "in_proj": ParamSpec((D, 2 * Ein), ("embed_fsdp", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, Ein), (None, "mlp")),
        "conv_b": ParamSpec((Ein,), ("mlp",), init="zeros"),
        "x_proj": ParamSpec((Ein, r + 2 * n), ("mlp", None)),
        "dt_proj": ParamSpec((r, Ein), (None, "mlp")),
        "dt_bias": ParamSpec((Ein,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((Ein, n), ("mlp", None), init="ones"),
        "D_skip": ParamSpec((Ein,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((Ein, D), ("mlp", "embed_fsdp")),
    }


def _ssm_params(p, xc, cfg):
    """Input-dependent (dt, B, C) from the conv branch xc: (B, S, Ein)."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    proj = dot(xc.float(), p["x_proj"].float())
    dt_in, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dot(dt_in, p["dt_proj"].float())
                    + p["dt_bias"].float())                # (B, S, Ein)
    return dt, Bm, Cm


def _conv_step(p, x_window):
    """Causal depthwise conv over (B, S, K, Ein) windows -> (B, S, Ein)."""
    w = p["conv_w"].float()                                # (K, Ein)
    return torch.einsum("bske,ke->bse", x_window.float(), w) \
        + p["conv_b"].float()


def _selective_chunk(h, xc, dt, Bm, Cm, A):
    """T steps of the selective recurrence from state h (B, Ein, n): xc,
    dt (B, T, Ein), Bm, Cm (B, T, n), A (Ein, n).  Returns (h, y (B, T,
    Ein))."""
    da = torch.exp(dt[..., None] * A)                      # (B, T, Ein, n)
    dbx = (dt[..., None] * Bm[:, :, None, :]) * xc[..., None]
    hs = []
    for t in range(xc.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    return h, torch.einsum("bten,btn->bte", torch.stack(hs, 1), Cm)


def mamba_block(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D).  state: None (train / prefill from scratch) or a dict
    with 'ssm' (B, Ein, n) f32 and 'conv' (B, K-1, Ein) for incremental
    decode.  Returns (y, new_state)."""
    B, S, D = x.shape
    Ein = cfg.ssm_expand * D
    K = cfg.ssm_conv
    n = cfg.ssm_state
    cd = cfg.cdtype

    xz = dot(x.to(cd), p["in_proj"].to(cd))                # (B, S, 2Ein)
    xs, z = xz.chunk(2, dim=-1)

    if state is None:
        conv_tail = torch.zeros((B, K - 1, Ein), dtype=cd, device=x.device)
        ssm0 = torch.zeros((B, Ein, n), dtype=torch.float32,
                           device=x.device)
    else:
        conv_tail, ssm0 = state["conv"], state["ssm"]

    # causal depthwise conv: explicit windows for S <= 4 (decode), else
    # the shifted sum (the two sum in different orders, as the reference)
    xs_pad = torch.cat([conv_tail.to(cd), xs], dim=1)
    if S <= 4:
        xc = _conv_step(p, torch.stack([xs_pad[:, t:t + K]
                                        for t in range(S)], dim=1))
    else:
        w = p["conv_w"].float()
        xc = sum(xs_pad[:, K - 1 - i: K - 1 - i + S].float() * w[K - 1 - i]
                 for i in range(K))
        xc = xc + p["conv_b"].float()
    xc = silu(xc)                                          # (B, S, Ein) f32

    dt, Bm, Cm = _ssm_params(p, xc, cfg)
    A = -torch.exp(p["A_log"].float())                     # (Ein, n)
    h_final, y = chunked_scan(_selective_chunk, ssm0, (xc, dt, Bm, Cm),
                              (A,), remat=cfg.recurrent_step_remat)
    y = y + xc * p["D_skip"].float()
    y = y.to(cd) * silu(z)
    out = dot(y, p["out_proj"].to(cd))
    return out, {"ssm": h_final, "conv": xs_pad[:, -(K - 1):].to(cd)}
