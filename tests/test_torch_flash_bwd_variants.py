"""The flash backward's three variants (repro_torch.kernels.
flash_attention_bwd): the dispatch rule, the ``force=`` checks, the dkv
split rule, and the arithmetic of the Hopper (wgmma) variant against the
JAX reference kernel.

A CUDA kernel has no interpret mode, so the wgmma variant's tile program is
emulated here in torch as the kernel runs it: the dq kernel over 128-row q
tiles and the kv tiles of 128 rows its ``kv_range`` keeps (S = Q K^T and
dP = dO V^T in f32 from bf16 operands, p = 2^(S * scale log2(e) - lse
log2(e)) with the two f32 factors rounded and the exponent one fused
multiply-add, masked p exactly 0, ds = p (dp - delta) scale, dQ +=
bf16(dS) K in f32); the dkv kernel in the transposed
orientation over 128-row kv tiles, each kv head's query-head group split
into ``nsplit`` blocks that sum their heads in order and the 64-row q
tiles its ``q_range`` keeps (S^T = K Q^T, dP^T = V dO^T, P^T and dS^T
with lse and delta broadcast along columns, dV += bf16(P^T) dO and
dK += bf16(dS^T) Q in f32), then the blocks' f32 partials summed in split
order and rounded once.  The emulation sums each product in torch's f32
order; the tensor cores' order differs from it only in the last bits,
which only the card checks (chip_smoke.py, against the plain version).
It is held against ``repro.kernels.flash_attention_bwd.
flash_attention_bwd`` in interpret mode on the same bf16 inputs made with
numpy, with the JAX forward's ``out`` and ``lse``, at rtol = atol = 2e-2
(the reference's bf16 ``_tol``), and against the port's plain version at
the same tolerance.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention_bwd import \
    flash_attention_fwd as jax_flash_fwd
from repro_torch.kernels.flash_attention_bwd import (
    KV_TILE, VARIANTS_BWD, choose, dkv_splits, flash_attention_bwd,
    flash_attention_bwd_plain, variant)

Q_TILE_DQ, Q_TILE_DKV = 128, 64      # the kernels' q tiles
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 32, 64, 80, 128])
def test_variant_rule(dtype, Dh):
    if dtype == torch.float32:
        want = "simt"
    else:
        want = "wgmma" if Dh in (64, 80, 128) else "mma"
    assert variant(Dh, dtype) == want


def _zeros(B, H, S, Dh, dtype, offset=0):
    """A contiguous (B, H, S, Dh) tensor whose data starts ``offset``
    elements into its storage."""
    n = B * H * S * Dh
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(B, H, S, Dh)


@pytest.mark.parametrize("Sq,Skv,want", [(8, 8, "wgmma"), (8, 0, "mma"),
                                         (0, 8, "mma")])
def test_calls_without_rows_take_mma(Sq, Skv, want):
    q = _zeros(1, 4, Sq, 64, torch.bfloat16)
    kv = _zeros(1, 2, Skv, 64, torch.bfloat16)
    assert choose(q, kv, kv, others=(q,)) == want
    if want == "mma":
        with pytest.raises(ValueError):
            choose(q, kv, kv, "wgmma")
    assert choose(q, kv, kv, "mma") == "mma"


def test_unaligned_bf16_bases_raise():
    q = _zeros(1, 2, 8, 64, torch.bfloat16, offset=1)
    kv = _zeros(1, 2, 8, 64, torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        choose(q, kv, kv)
    with pytest.raises(ValueError, match="aligned"):
        choose(kv, kv, kv, others=(kv, q))        # do, out
    f = _zeros(1, 2, 8, 64, torch.float32, offset=1)
    assert choose(f, f, f) == "simt"      # f32 loads no 16-byte rows


@pytest.mark.parametrize("dtype,Dh,force", [
    (torch.bfloat16, 128, "tensor_cores"),      # no such variant
    (torch.float32, 64, "wgmma"),                # f32 would round to tf32
    (torch.float32, 64, "mma"),
    (torch.bfloat16, 64, "simt"),                # the SIMT kernel is f32
    (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 32, "wgmma"),
])
def test_forced_variant_that_cannot_take_the_call_raises(dtype, Dh, force):
    q = _zeros(1, 2, 8, Dh, dtype)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        choose(q, q, q, force)
    before = dict(flash_attention_bwd.variant_launches)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, lse, q, force=force)
    assert flash_attention_bwd.variant_launches == before


@pytest.mark.parametrize("force", [None, "wgmma", "mma"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(force):
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in ((1, 4, 16, 64),
                                                  (1, 2, 16, 64),
                                                  (1, 2, 16, 64),
                                                  (1, 4, 16, 64)))
    out = torch.zeros_like(q)
    lse = torch.zeros(1, 4, 16)
    before = flash_attention_bwd.launches, \
        dict(flash_attention_bwd.variant_launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, force=force)
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, out, lse, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.variant_launches) == before
    assert before == (0, dict.fromkeys(VARIANTS_BWD, 0))


# the training shapes (B, Hq, Hkv, Skv) and the split each takes on 132 SMs:
# [train], [train_ep] full and cut, [train_tp] full and cut, [train_danube],
# whisper's encoder and cross-attention
@pytest.mark.parametrize("B,Hq,Hkv,Skv,want", [
    (2, 32, 8, 2048, 1), (1, 32, 8, 1024, 4), (1, 4, 2, 1024, 2),
    (1, 16, 4, 1024, 4), (1, 2, 1, 1024, 2), (1, 32, 8, 6144, 1),
    (4, 6, 6, 1500, 1)])
def test_dkv_split_rule(B, Hq, Hkv, Skv, want):
    got = dkv_splits(B, Hq, Hkv, Skv, 132)
    assert got == want
    group, tiles = Hq // Hkv, B * Hkv * -(-Skv // KV_TILE)
    assert group % got == 0
    # the fewest that fills the card, else the whole group
    assert tiles * got >= 132 or got == group
    assert all(group % d or tiles * d < 132 for d in range(1, got))


# ---------------------------------------------------------------------------
# the wgmma variant's arithmetic
# ---------------------------------------------------------------------------


def _mask(rows, cols, *, causal, window, kv_offset, Skv):
    r = rows[:, None] + kv_offset
    c = cols[None, :]
    mask = c < Skv
    if causal:
        mask = mask & (c <= r)
    if window is not None:
        mask = mask & (c > r - window)
    return mask


def _kv_range(q0, Sq, Skv, *, causal, window, kv_offset):
    """The dq kernel's kv tiles for the q tile at q0 (kv_range<128, 128>)."""
    row_hi = min(q0 + Q_TILE_DQ, Sq) - 1 + kv_offset
    lo, hi = 0, Skv
    if causal:
        hi = min(hi, row_hi + 1)
    if window is not None:
        lo = max(0, q0 + kv_offset - window + 1)
    return lo - lo % KV_TILE, hi


def _q_range(k0, Sq, Skv, *, causal, window, kv_offset):
    """The dkv kernel's q tiles for the kv tile at k0 (q_range<128, 64>)."""
    k_last = min(k0 + KV_TILE, Skv) - 1
    lo, hi = 0, Sq
    if causal:
        lo = max(0, k0 - kv_offset)
    if window is not None:
        hi = min(hi, k_last + window - kv_offset)
    return lo - lo % Q_TILE_DKV, hi


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_wgmma_bwd(q, k, v, out, lse, do, *, causal=True, window=None,
                      kv_offset=0, nsplit=1):
    """The wgmma variant's tile program on bf16 inputs (the note at the
    top); returns (dq, dk, dv) in bf16."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    heads = group // nsplit
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    scale2 = scale * LOG2E                  # both rounded to f32
    lse2 = lse * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * out.float()).sum(-1)
    m = dict(causal=causal, window=window, kv_offset=kv_offset)

    def p_ds(s, dp, lse2_, delta_, mask):
        # the fused multiply-add: one rounding of s * scale2 - lse2
        x = (s.double() * scale2.double() - lse2_.double()).float()
        p = torch.where(mask, torch.exp2(x), 0.0)
        return p, p * (dp - delta_) * scale

    dq = torch.zeros(B, Hq, Sq, Dh)
    kg, vg = (t.repeat_interleave(group, 1) for t in (kf, vf))
    for q0 in range(0, Sq, Q_TILE_DQ):
        rows = torch.arange(q0, min(q0 + Q_TILE_DQ, Sq))
        lo, hi = _kv_range(q0, Sq, Skv, **m)
        for c0 in range(lo, hi, KV_TILE):
            cols = torch.arange(c0, min(c0 + KV_TILE, Skv))
            s = qf[:, :, rows] @ kg[:, :, cols].transpose(-1, -2)
            dp = dof[:, :, rows] @ vg[:, :, cols].transpose(-1, -2)
            _, ds = p_ds(s, dp, lse2[:, :, rows, None],
                         delta[:, :, rows, None],
                         _mask(rows, cols, Skv=Skv, **m))
            dq[:, :, rows] += _bf16(ds) @ kg[:, :, cols]

    # query head j of kv head h is q head h * group + j
    qh, oh = (t.reshape(B, Hkv, group, Sq, Dh) for t in (qf, dof))
    lh, dh = (t.reshape(B, Hkv, group, Sq) for t in (lse2, delta))
    dk, dv = torch.zeros(B, Hkv, Skv, Dh), torch.zeros(B, Hkv, Skv, Dh)
    for k0 in range(0, Skv, KV_TILE):
        cols = torch.arange(k0, min(k0 + KV_TILE, Skv))
        lo, hi = _q_range(k0, Sq, Skv, **m)
        part_k, part_v = [], []
        for split in range(nsplit):
            acc_k = torch.zeros(B, Hkv, len(cols), Dh)
            acc_v = torch.zeros(B, Hkv, len(cols), Dh)
            for j in range(split * heads, (split + 1) * heads):
                for r0 in range(lo, hi, Q_TILE_DKV):
                    rows = torch.arange(r0, min(r0 + Q_TILE_DKV, Sq))
                    st = kf[:, :, cols] @ qh[:, :, j, rows].transpose(-1, -2)
                    dpt = vf[:, :, cols] @ oh[:, :, j, rows].transpose(-1, -2)
                    pt, dst = p_ds(st, dpt, lh[:, :, j, None, rows],
                                   dh[:, :, j, None, rows],
                                   _mask(rows, cols, Skv=Skv, **m).T)
                    acc_v += _bf16(pt) @ oh[:, :, j, rows]
                    acc_k += _bf16(dst) @ qh[:, :, j, rows]
            part_k.append(acc_k)
            part_v.append(acc_v)
        sk, sv = part_k[0], part_v[0]
        for pk, pv in zip(part_k[1:], part_v[1:]):      # in split order
            sk, sv = sk + pk, sv + pv
        dk[:, :, cols], dv[:, :, cols] = sk, sv
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


# GQA, causal, windows, kv offsets (+ and -, and a window with a negative
# offset: q_range at 128-row kv tiles), ragged Sq != Skv, head dims 64 /
# 80 / 128, rows with no unmasked column (kv_offset -4), more than one kv
# tile and q tile on each side
CASES = [
    ((1, 4, 2, 256, 256, 128), dict(causal=True)),
    ((2, 6, 3, 48, 48, 64), dict(causal=False)),
    ((1, 4, 2, 37, 77, 64), dict(causal=True, kv_offset=40)),
    ((1, 4, 2, 130, 200, 128), dict(causal=True, window=50, kv_offset=70)),
    ((1, 2, 1, 40, 40, 64), dict(causal=True, kv_offset=-4)),
    ((1, 4, 2, 160, 160, 80), dict(causal=True, window=40)),
    ((1, 8, 2, 150, 150, 128), dict(causal=False)),
    ((1, 4, 2, 200, 200, 64), dict(causal=True, kv_offset=-70)),
    ((1, 2, 2, 140, 140, 128), dict(causal=True, window=100,
                                    kv_offset=-20)),
]
_JAX = {}


def _inputs(i):
    """bf16 q, k, v, do of CASES[i] from numpy: torch tensors, JAX arrays."""
    B, Hq, Hkv, Sq, Skv, Dh = CASES[i][0]
    rng = np.random.default_rng(100 + i)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, Dh), (B, Hkv, Skv, Dh), (B, Hkv, Skv, Dh),
                      (B, Hq, Sq, Dh))]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


def _jax_reference(i):
    """The JAX forward's (out, lse) and the Pallas backward's (dq, dk, dv)
    in interpret mode for CASES[i], as numpy f32 (computed once)."""
    if i not in _JAX:
        _, (jq, jk, jv, jdo) = _inputs(i)
        kw = CASES[i][1]
        out, lse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
        grads = jax_flash_bwd(jq, jk, jv, out, lse, jdo, interpret=True,
                              **kw)
        _JAX[i] = tuple(np.array(x.astype(jnp.float32))
                        for x in (out, lse, *grads))
    return _JAX[i]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_wgmma_arithmetic_matches_jax_kernel(i):
    (q, k, v, do), _ = _inputs(i)
    kw = CASES[i][1]
    out_np, lse_np, *want = _jax_reference(i)
    out = torch.from_numpy(out_np).to(torch.bfloat16)
    lse = torch.from_numpy(lse_np)
    group = q.shape[1] // k.shape[1]
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for nsplit in [d for d in range(1, group + 1) if group % d == 0]:
        got = emulate_wgmma_bwd(q, k, v, out, lse, do, nsplit=nsplit, **kw)
        for name, g, w, p in zip("qkv", got, want, plain):
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                       atol=2e-2,
                                       err_msg=f"d{name} nsplit {nsplit}")
            # what the card holds the kernel to: the plain version
            torch.testing.assert_close(g, p, rtol=2e-2, atol=2e-2)
    if kw.get("kv_offset", 0) < 0 and kw.get("window") is None:
        # the rows before the first key see nothing: dq exactly 0
        assert not got[0][:, :, :-kw["kv_offset"]].any()
