"""Spectral long-convolution mixer, port of ``repro.models.spectral``: an
LTI diagonal SSM whose full-sequence pass is an FFT causal convolution.

The state-space kernel is time-invariant (unlike mamba's selective
scan), so the length-S output is a causal convolution with the
materialized kernel ``K[t, e] = sum_n C[e,n] * Abar[e,n]^t * Bbar[e,n]``,
computed in O(S log S) with ``torch.fft`` instead of an O(S) scan.
Decode keeps the recurrent form: one O(Ein*n) state update per token,
the same linear system.

Opt-in via ``ModelConfig(spectral_long_conv=True)`` (substitutes the
recurrent mixers in ``block_pattern``) or ``block_pattern=("spectral",)``.
:func:`distributed_fft_causal_conv` is the sequence-sharded convolution
through the pencil FFT (``workloads.fft``) over a torus communicator.

On a mesh whose ``model`` dim splits the ``mlp`` channels, each rank runs
``Ein / |model|`` of them, as mamba does: ``in_proj`` column-parallel
with its ``[xs | z]`` halves split pairwise (``ParamSpec
.column_groups``), ``A_log``, ``B``, ``C``, ``dt_log`` and ``D_skip``
the rank's channels (so the kernel covers them alone), ``out_proj``
row-parallel: one all-reduce a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, silu
from repro_torch.models.ffn import row_parallel
from repro_torch.models.remat import chunked_scan, dot
from repro_torch.parallel.sharding import split_group, tp_copy, used_columns
from .config import ModelConfig


def spectral_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Ein = cfg.ssm_expand * D
    n = cfg.ssm_state
    return {
        "in_proj": ParamSpec((D, 2 * Ein), ("embed_fsdp", "mlp"),
                             column_groups=2),
        "A_log": ParamSpec((Ein, n), ("mlp", None), init="ones"),
        "B": ParamSpec((Ein, n), ("mlp", None)),
        "C": ParamSpec((Ein, n), ("mlp", None)),
        "dt_log": ParamSpec((Ein,), ("mlp",), init="zeros"),
        "D_skip": ParamSpec((Ein,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((Ein, D), ("mlp", "embed_fsdp")),
    }


def mixer_group(cfg: ModelConfig, mesh=None, rules=None):
    """The ``model`` group the block's channels are split over (the
    resolver's split of ``in_proj``), or None where it runs whole."""
    return split_group(spectral_specs(cfg)["out_proj"], mesh, rules)


def _discretize(p):
    """(Abar, Bbar, C, dt * A) of the ZOH-Euler discretized diagonal
    system."""
    A = -torch.exp(p["A_log"].float())                     # (Ein, n) < 0
    dt = F.softplus(p["dt_log"].float())[:, None]
    dA = torch.exp(dt * A)                                 # (Ein, n)
    dB = dt * p["B"].float()                               # (Ein, n)
    return dA, dB, p["C"].float(), dt * A


def ssm_kernel(p, L: int):
    """The causal conv kernel ``K``: (L, Ein), ``K[t] = C . Abar^t .
    Bbar`` (so ``K[0] = C . Bbar``)."""
    _, dB, C, dtA = _discretize(p)
    t = torch.arange(L, dtype=torch.float32, device=dB.device)
    powers = torch.exp(t[:, None, None] * dtA[None])       # (L, Ein, n)
    return torch.einsum("len,en->le", powers, C * dB)


def fft_causal_conv(x, kernel):
    """Causal (linear, not circular) convolution of ``x``: (B, S, E)
    with the per-channel ``kernel``: (S, E) through a zero-padded FFT;
    float32."""
    S = x.shape[1]
    L = 2 * S
    X = torch.fft.rfft(x.float(), n=L, dim=1)
    Kf = torch.fft.rfft(kernel.float(), n=L, dim=0)
    return torch.fft.irfft(X * Kf[None], n=L, dim=1)[:, :S]


def distributed_fft_causal_conv(comm, x, kernel):
    """Sequence-sharded causal convolution through the pencil FFT.

    The transforms along the padded sequence axis run through
    :class:`~repro_torch.workloads.fft.PencilFFT`, a slab over all of
    ``comm``'s torus axes in complex64, so each of the four global
    re-shards is a cached ``TransposePlan`` collective.  SPMD: every rank
    of ``comm`` calls it, in the same order.

    Input: every rank passes the global ``x``: (B, S, E) and ``kernel``:
    (S, E) and cuts, with no exchange, its own ``(L/p, B*E)`` slab (rows
    ``[r*L/p, (r+1)*L/p)``, ``r`` its torus rank, ``L = 2S``) of the
    zero-padded, time-major array.  Output: this rank's rows of the
    reference's output sharding, the sequence rows ``[r*L/p, (r+1)*L/p)
    ∩ [0, S)`` as (B, rows, E) float32; the ranks past ``p/2`` hold
    none.  Concatenated in torus-rank order, the ranks' rows are
    :func:`fft_causal_conv` of the global input."""
    from repro_torch.workloads.fft import PencilFFT

    B, S, E = x.shape
    L = 2 * S
    p = comm.p
    if L % p or (B * E) % p:
        raise ValueError(f"padded seq {L} and B*E {B * E} must divide "
                         f"p={p}")
    fft = PencilFFT(comm, (L, B * E), axes=(0,),
                    grid=(tuple(comm.axis_names),), dtype="complex64")
    r = comm.rank
    if r is None:
        raise ValueError("the distributed convolution needs a mesh-backed "
                         "comm")
    rows, cols = L // p, B * E // p
    lo, n = r * rows, max(0, min(rows, S - r * rows))
    xl = torch.zeros(rows, B * E, dtype=torch.complex64, device=x.device)
    if n:
        xl[:n] = x[:, lo:lo + n].float().transpose(0, 1).reshape(n, B * E)
    X = fft.forward_fn()(xl)                               # (L, B*E/p)
    e_idx = (r * cols + torch.arange(cols, device=x.device)) % E
    Kf = torch.fft.fft(kernel.to(torch.complex64), n=L, dim=0)   # (L, E)
    y = fft.inverse_fn()(X * Kf[:, e_idx])                 # (L/p, B*E)
    return y[:n].real.reshape(n, B, E).transpose(0, 1).contiguous()


def _recurrence_chunk(h, x, dA, dB, C):
    """T steps of the recurrence: x (B, T, Ein), h (B, Ein, n).  Returns
    (h, y (B, T, Ein))."""
    ys = []
    for t in range(x.shape[1]):
        h = dA[None] * h + dB[None] * x[:, t, :, None]
        ys.append(torch.einsum("ben,en->be", h, C))
    return h, torch.stack(ys, 1)


def spectral_block(p, x, cfg: ModelConfig, state=None, mesh=None,
                   rules=None):
    """x: (B, S, D).  ``state=None`` (train / prefill from scratch) runs
    the FFT convolution and returns the final recurrent state for the
    decode hand-off; with a state dict (``{'ssm': (B, Ein, n)}``, on a
    mesh Ein this rank's channels) it runs the step recurrence, the same
    linear system.  Returns (y, new_state)."""
    B, S, D = x.shape
    cd = cfg.cdtype
    group = mixer_group(cfg, mesh, rules)
    x = tp_copy(x.to(cd), group)
    w_in = used_columns(p["in_proj"], spectral_specs(cfg)["in_proj"],
                        group, mesh, rules)
    xz = dot(x, w_in.to(cd))                               # (B, S, 2Ein)
    xs, z = xz.chunk(2, dim=-1)
    xs_f = xs.float()
    dA, dB, C, dtA = _discretize(p)

    if state is None:
        y = fft_causal_conv(xs_f, ssm_kernel(p, S))        # (B, S, Ein)
        # decode hand-off: h[S-1] = sum_s Abar^{S-1-s} Bbar x[s]
        rev = torch.arange(S - 1, -1, -1, dtype=torch.float32,
                           device=x.device)
        powers = torch.exp(rev[:, None, None] * dtA[None])  # (S, Ein, n)
        h_final = torch.einsum("sen,bse->ben", powers * dB[None], xs_f)
    else:
        h_final, y = chunked_scan(_recurrence_chunk, state["ssm"], (xs_f,),
                                  (dA, dB, C), remat=False)

    y = y + xs_f * p["D_skip"].float()
    y = y.to(cd) * silu(z)
    return row_parallel(y, p["out_proj"], cd, group), {"ssm": h_final}
