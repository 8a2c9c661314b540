"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), port
of ``repro.models.xlstm`` (arXiv:2405.04517).

The mLSTM cell keeps a per-head matrix memory ``C: (hd, hd)`` with
exponential input gating and a stabilizer state; the sLSTM cell keeps
scalar memories with exponential gating and a block-diagonal (per-head)
recurrence.  Both are recurrences over time with single-step decode.
Where the reference scans, the port runs :func:`remat.chunked_scan`
(``remat.SCAN_CHUNK`` steps a call, each step its own ops; one call per
chunk for the chunkwise mLSTM); under autograd with
``cfg.recurrent_step_remat`` each call is checkpointed, so
backpropagation through time keeps only the carried state.

Block structure: mLSTM = up-projection (2x) -> q/k/v -> mLSTM cell ->
group norm -> gated (SiLU) down-projection.  sLSTM = sLSTM cell (4 gates)
-> group norm -> GLU-style projection (4/3 factor).

On a mesh whose ``model`` dim splits the ``mlp`` dims (the resolver;
where it does not divide, the blocks run whole):

* mLSTM: ``up`` is column-parallel with its ``[xi | z]`` halves split
  pairwise (``ParamSpec.column_groups``); ``wq``, ``wk``, ``wv``,
  ``wif`` and ``wo`` are split on their input dim, so their five f32
  products are partial sums, summed over ``model`` in one all-reduce
  (``tp_sum``), after which the rank keeps its ``H / |model|`` heads of
  q, k, v and the gates and its ``Din / |model|`` columns of the output
  gate; the cell runs on those heads (its state split over heads); the
  group norm's mean square is summed over ``model``; ``down`` is
  row-parallel.  Three all-reduces a call.
* sLSTM: ``w_gates`` is column-split and its product gathered over
  ``model`` (``sp_gather``), so the cell runs whole on every rank (its
  state whole); ``up1`` / ``up2`` are column-parallel and ``down``
  row-parallel.  One all-gather and one all-reduce a call.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, rms_norm, silu
from repro_torch.models.ffn import row_parallel
from repro_torch.models.remat import chunked_scan, dot
from repro_torch.parallel.sharding import (model_dim, sp_gather,
                                           split_group, tp_copy, tp_rank,
                                           tp_sum, used_columns)
from .config import ModelConfig


def _log_sigmoid(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Din = 2 * D                      # up-projection factor 2
    H = cfg.n_heads
    return {
        "up": ParamSpec((D, 2 * Din), ("embed_fsdp", "mlp"),
                        column_groups=2),
        "wq": ParamSpec((Din, Din), ("mlp", None)),
        "wk": ParamSpec((Din, Din), ("mlp", None)),
        "wv": ParamSpec((Din, Din), ("mlp", None)),
        "wif": ParamSpec((Din, 2 * H), ("mlp", None)),  # i/f gate preacts
        "wo": ParamSpec((Din, Din), ("mlp", None)),     # output gate
        "gn": ParamSpec((Din,), ("mlp",), init="ones"),
        "down": ParamSpec((Din, D), ("mlp", "embed_fsdp")),
    }


def _mlstm_steps(carry, q, k, v, i_pre, f_pre):
    """T steps of the mLSTM cell: q, k, v (B, T, H, hd), i_pre, f_pre (B,
    T, H); carry (C (B, H, hd, hd), n (B, H, hd), m (B, H)).  Returns
    (carry, h (B, T, H, hd))."""
    C, n, m = carry
    hs = []
    for t in range(q.shape[1]):
        q_t, k_t, v_t, i_t, f_t = q[:, t], k[:, t], v[:, t], i_pre[:, t], \
            f_pre[:, t]
        log_f = _log_sigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        i_s = torch.exp(i_t - m_new)[..., None]            # (B, H, 1)
        f_s = torch.exp(log_f + m - m_new)[..., None]
        C = f_s[..., None] * C + i_s[..., None] * \
            (v_t[..., :, None] * k_t[..., None, :])        # (B, H, hd, hd)
        n = f_s * n + i_s * k_t
        num = torch.einsum("bhij,bhj->bhi", C, q_t)
        den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n, q_t)),
                            torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return (C, n, m), torch.stack(hs, 1)


def mlstm_group(cfg: ModelConfig, mesh=None, rules=None):
    """The ``model`` group the mLSTM's heads are split over (the
    resolver's split of ``up``), or None where it runs whole."""
    return split_group(mlstm_specs(cfg)["down"], mesh, rules)


def check_mlstm_heads(cfg: ModelConfig, shape: dict, rules=None) -> None:
    """Raise where the mesh shape ``shape`` (``{dim: size}``) splits the
    mLSTM's leaves over ``model`` but not its heads."""
    t = shape.get("model", 1)
    spec = mlstm_specs(cfg)["down"]
    if cfg.n_heads % t and model_dim(spec.shape, spec.logical, shape,
                                     rules) is not None:
        raise ValueError(
            f"{cfg.name}: the mLSTM splits its heads over 'model', so it "
            f"needs n_heads ({cfg.n_heads}) divisible by model ({t}) on the "
            f"mesh {shape}")


def _group_rms_norm(h, gamma, group, width: int, eps: float = 1e-6):
    """:func:`common.rms_norm` of ``h`` over ``width`` channels of which
    this rank holds ``h``'s last dim: the sum of squares is summed over
    ``group`` in f32 (both passes: every rank's output reads it)."""
    if group is None:
        return rms_norm(h, gamma, eps)
    x = h.float()
    var = tp_sum(torch.sum(x * x, dim=-1, keepdim=True), group) / width
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(h.dtype)


def mlstm_block(p, x, cfg: ModelConfig, state=None, mesh=None, rules=None):
    """x: (B, S, D) -> (y, state).  state: {C: (B,H,hd,hd), n: (B,H,hd),
    m: (B,H)}, f32 (on a mesh, H this rank's heads)."""
    B, S, D = x.shape
    cd = cfg.cdtype
    Din = 2 * D
    hd = Din // cfg.n_heads
    group = mlstm_group(cfg, mesh, rules)
    t, r = (1, 0) if group is None else (group.size, tp_rank(group))
    H, Dl = cfg.n_heads // t, Din // t            # this rank's heads

    x = tp_copy(x.to(cd), group)
    up = dot(x, used_columns(p["up"], mlstm_specs(cfg)["up"], group, mesh,
                             rules).to(cd))
    xi, z = up.chunk(2, dim=-1)                           # (B,S,Dl) each
    xf = xi.float()

    names = ("wq", "wk", "wv", "wo", "wif")
    if group is None:
        q, k, v, o, g = (dot(xf, p[w].float()) for w in names)
    else:
        # the five partial sums, summed over model in one all-reduce
        q, k, v, o, g = tp_sum(torch.cat(
            [dot(xf, p[w].float()) for w in names], -1), group).split(
            [Din] * 4 + [2 * cfg.n_heads], -1)
    own = slice(r * Dl, (r + 1) * Dl)             # this rank's heads' columns
    q, k, v = (a[..., own].reshape(B, S, H, hd) for a in (q, k, v))
    k = k / math.sqrt(hd)
    gates = g.reshape(B, S, 2, cfg.n_heads)[..., r * H:(r + 1) * H]
    i_pre, f_pre = gates[:, :, 0], gates[:, :, 1]         # (B, S, H)
    o_gate = torch.sigmoid(o[..., own])

    if state is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]

    L = cfg.xlstm_chunk
    if L and S > L and S % L == 0:
        h, (Cf, nf, mf) = _mlstm_chunked(
            q, k, v, i_pre, f_pre, (C0, n0, m0), L,
            step_remat=cfg.recurrent_step_remat)
    else:
        (Cf, nf, mf), h = chunked_scan(
            _mlstm_steps, (C0, n0, m0), (q, k, v, i_pre, f_pre),
            remat=cfg.recurrent_step_remat)
    h = _group_rms_norm(h.reshape(B, S, Dl), p["gn"], group, Din) * o_gate
    y = row_parallel(h.to(cd) * silu(z), p["down"], cd, group)
    return y, {"C": Cf, "n": nf, "m": mf}


def _mlstm_chunk(carry, qc, kc, vc, ic, fc):
    """One chunk of L tokens of the chunkwise mLSTM: qc, kc, vc (B, L, H,
    hd), ic, fc (B, L, H).  Returns (carry, h (B, L, H, hd))."""
    C, n, m = carry                          # (B,H,hd,hd),(B,H,hd),(B,H)
    L = qc.shape[1]
    qc = qc.transpose(1, 2)                  # (B,H,L,hd)
    kc = kc.transpose(1, 2)
    vc = vc.transpose(1, 2)
    ic = ic.transpose(1, 2)                  # (B,H,L)
    fc = fc.transpose(1, 2)

    log_f = _log_sigmoid(fc)                 # (B,H,L)
    b = torch.cumsum(log_f, dim=-1)          # b_t
    a = ic - b                               # a_s
    M = torch.maximum(m[..., None], torch.cummax(a, dim=2).values)

    # intra-chunk scores; the mask is applied to the exponent (where
    # s > t, a_s - M_t may overflow exp), which gives the reference's
    # values and keeps inf * 0 out of the backward
    scores = torch.einsum("bhtd,bhsd->bhts", qc, kc)
    mask = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    expo = a[:, :, None, :] - M[..., None]   # a_s - M_t
    W = scores * torch.exp(torch.where(mask, expo,
                                       torch.full_like(expo, -math.inf)))

    inter_scale = torch.exp(m[..., None] - M)              # (B,H,L)
    inter_num = torch.einsum("bhij,bhtj->bhti", C, qc) \
        * inter_scale[..., None]
    num = inter_num + torch.einsum("bhts,bhsd->bhtd", W, vc)
    l = torch.einsum("bhj,bhtj->bht", n, qc) * inter_scale \
        + torch.sum(W, dim=-1)
    m_t = b + M
    den = torch.maximum(torch.abs(l), torch.exp(-m_t))[..., None]
    h = num / den                                          # (B,H,L,hd)

    # end-of-chunk state: e^{b_L - b_s + i_s - m_new} = e^{a_s - M_L}
    M_L = M[..., -1]
    w_end = torch.exp(a - M_L[..., None])
    C_new = torch.exp(m - M_L)[..., None, None] * C + \
        torch.einsum("bhs,bhsd,bhse->bhde", w_end, vc, kc)
    n_new = torch.exp(m - M_L)[..., None] * n + \
        torch.einsum("bhs,bhsd->bhd", w_end, kc)
    m_new = b[..., -1] + M_L
    return (C_new, n_new, m_new), h.transpose(1, 2)        # (B,L,H,hd)


def _mlstm_chunked(q, k, v, i_pre, f_pre, state, L: int,
                   step_remat: bool = False):
    """Chunkwise-parallel mLSTM: the state is read and written once per
    chunk of L tokens, the intra-chunk interactions through an (L, L)
    attention-like matrix (the reference's derivation:
    ``repro.models.xlstm._mlstm_chunked``).  Returns (h (B, S, H, hd),
    (C, n, m))."""
    carry, h = chunked_scan(_mlstm_chunk, state, (q, k, v, i_pre, f_pre),
                            chunk=L, remat=step_remat)
    return h, carry


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    F_ = max(1, 4 * D // 3) // 8 * 8 or 8
    return {
        "w_gates": ParamSpec((D, 4 * D), ("embed_fsdp", "mlp")),
        # block-diagonal per-head recurrence: heads do not mix through R
        "r_gates": ParamSpec((H, D // H, 4 * (D // H)), (None, None, None)),
        "gn": ParamSpec((D,), (None,), init="ones"),
        "up1": ParamSpec((D, F_), ("embed_fsdp", "mlp")),
        "up2": ParamSpec((D, F_), ("embed_fsdp", "mlp")),
        "down": ParamSpec((F_, D), ("mlp", "embed_fsdp")),
    }


def _slstm_steps(carry, wx, r):
    """T steps of the sLSTM cell: wx (B, T, 4D) the input's gate
    pre-activations, r (H, Dh, 4Dh); carry (c, n, m, h), each (B, D).
    Returns (carry, h (B, T, D))."""
    c, n, m, h = carry
    B, D = h.shape
    H, Dh = r.shape[0], r.shape[1]
    hs = []
    for t in range(wx.shape[1]):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r)
        pre = wx[:, t] + rec.reshape(B, H, 4, Dh).transpose(1, 2) \
            .reshape(B, 4 * D)
        zt, it, ft, ot = pre.chunk(4, dim=-1)
        log_f = _log_sigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(zt)
        n = f_s * n + i_s
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return (c, n, m, h), torch.stack(hs, 1)


def slstm_block(p, x, cfg: ModelConfig, state=None, mesh=None, rules=None):
    """x: (B, S, D) -> (y, state).  state: {c, n, m, h}: (B, D) each, f32
    (whole on every rank of a mesh)."""
    B, S, D = x.shape
    cd = cfg.cdtype
    specs = slstm_specs(cfg)
    # the gate columns split as the "mlp" rule splits them, the FFN's as
    # its consumer down is; under embed_fsdp=("model",) w_gates, up1 and
    # up2 are gathered whole and each rank uses those columns
    # (parallel.sharding.used_columns)
    gates_group = split_group(replace(specs["w_gates"],
                                      logical=(None, "mlp")), mesh, rules)
    ffn_group = split_group(specs["down"], mesh, rules)
    w_gates = used_columns(p["w_gates"], specs["w_gates"], gates_group,
                           mesh, rules)
    up1, up2 = (used_columns(p[k], specs[k], ffn_group, mesh, rules)
                for k in ("up1", "up2"))

    if state is None:
        z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        c0, n0, h0 = z, z + 1e-6, z
        m0 = torch.full((B, D), -1e30, dtype=torch.float32, device=x.device)
    else:
        c0, n0, m0, h0 = state["c"], state["n"], state["m"], state["h"]

    # this rank's gate columns, gathered: [z | i | f | o] whole
    wx = sp_gather(dot(tp_copy(x, gates_group).float(),
                       w_gates.float()), gates_group, -1)
    (cf, nf, mf, hf), h = chunked_scan(
        _slstm_steps, (c0, n0, m0, h0), (wx,), (p["r_gates"].float(),),
        remat=cfg.recurrent_step_remat)
    h = tp_copy(rms_norm(h, p["gn"]).to(cd), ffn_group)
    y = row_parallel(silu(dot(h, up1.to(cd))) * dot(h, up2.to(cd)),
                     p["down"], cd, ffn_group)
    return y, {"c": cf, "n": nf, "m": mf, "h": hf}
