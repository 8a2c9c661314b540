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

On a mesh whose ``model`` dim splits the ``mlp`` channels (the resolver,
as ``models.ffn``; where it does not divide, the block runs whole), each
rank runs ``Ein / |model|`` of the ``Ein`` channels: ``in_proj`` is
column-parallel with its ``[xs | z]`` halves split pairwise
(``ParamSpec.column_groups``), the conv, ``dt_proj``, ``A_log`` and
``D_skip`` are the rank's channels, ``x_proj`` is row-split so its
``(dt, B, C)`` product is summed over ``model`` (``tp_sum``, both
passes), the scan runs on the local channels with no collective, and
``out_proj`` is row-parallel: two all-reduces a call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, silu
from repro_torch.models.ffn import row_parallel
from repro_torch.models.remat import chunked_scan, dot
from repro_torch.parallel.sharding import (split_group, tp_copy, tp_sum,
                                           used_columns)
from .config import ModelConfig


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Ein = cfg.ssm_expand * D
    n = cfg.ssm_state
    r = _dt_rank(cfg)
    return {
        "in_proj": ParamSpec((D, 2 * Ein), ("embed_fsdp", "mlp"),
                             column_groups=2),
        "conv_w": ParamSpec((cfg.ssm_conv, Ein), (None, "mlp")),
        "conv_b": ParamSpec((Ein,), ("mlp",), init="zeros"),
        "x_proj": ParamSpec((Ein, r + 2 * n), ("mlp", None)),
        "dt_proj": ParamSpec((r, Ein), (None, "mlp")),
        "dt_bias": ParamSpec((Ein,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((Ein, n), ("mlp", None), init="ones"),
        "D_skip": ParamSpec((Ein,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((Ein, D), ("mlp", "embed_fsdp")),
    }


def mixer_group(cfg: ModelConfig, mesh=None, rules=None):
    """The ``model`` group the block's channels are split over (the
    resolver's split of ``out_proj``, which consumes them; ``in_proj``
    follows it, :func:`parallel.sharding.used_columns`), or None where
    it runs whole."""
    return split_group(mamba_specs(cfg)["out_proj"], mesh, rules)


def _ssm_params(p, xc, cfg, group=None):
    """Input-dependent (dt, B, C) from the conv branch xc: (B, S, Ein)
    (this rank's channels; the ``x_proj`` product summed over
    ``group``)."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    proj = tp_sum(dot(xc.float(), p["x_proj"].float()), group)
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


def mamba_block(p, x, cfg: ModelConfig, state=None, mesh=None, rules=None):
    """x: (B, S, D).  state: None (train / prefill from scratch) or a dict
    with 'ssm' (B, Ein, n) f32 and 'conv' (B, K-1, Ein) for incremental
    decode (on a mesh, Ein this rank's channels).  Returns (y,
    new_state)."""
    B, S, D = x.shape
    group = mixer_group(cfg, mesh, rules)
    Ein = cfg.ssm_expand * D // (1 if group is None else group.size)
    K = cfg.ssm_conv
    n = cfg.ssm_state
    cd = cfg.cdtype

    x = tp_copy(x.to(cd), group)
    w_in = used_columns(p["in_proj"], mamba_specs(cfg)["in_proj"], group,
                        mesh, rules)
    xz = dot(x, w_in.to(cd))                               # (B, S, 2Ein)
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

    dt, Bm, Cm = _ssm_params(p, xc, cfg, group)
    A = -torch.exp(p["A_log"].float())                     # (Ein, n)
    h_final, y = chunked_scan(_selective_chunk, ssm0, (xc, dt, Bm, Cm),
                              (A,), remat=cfg.recurrent_step_remat)
    y = y + xc * p["D_skip"].float()
    y = y.to(cd) * silu(z)
    out = row_parallel(y, p["out_proj"], cd, group)
    return out, {"ssm": h_final, "conv": xs_pad[:, -(K - 1):].to(cd)}
