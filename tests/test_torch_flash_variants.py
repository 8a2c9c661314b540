"""The flash forward's two variants (repro_torch.kernels.flash_attention):
the dispatch rule, the ``force=`` checks, and the arithmetic of the
tensor-core (wgmma) variant against the JAX reference kernels.

A CUDA kernel has no interpret mode, so the wgmma variant's arithmetic is
emulated here in torch, tile by tile as the kernel computes it (128-row q
tiles, 128-column kv tiles, f32 S from bf16 operands, online softmax, p
entering P V as 1, 2 or 3 bf16 terms, and optionally the kernel's
re-summation: in rows whose running max |x| reaches 16, the logits within
24 of it summed again as an f32 FMA chain over the head dim in order).
Which form ships is the kernel's compile-time choice (``tc::P_PARTS``,
``tc::RESUM_MIN``, ``tc::RESUM_WINDOW``), which ``flash_attention.
numerics()`` reads from the built library on the card; every form is
emulated here, the shipped one (3 terms, re-summed) included.  The
emulation sums S in torch's f32 order; the kernel's tensor-core sums
differ from it only in summation order, which only the card checks
(chip_smoke.py, against the plain version).  It is held
against ``repro.kernels.flash_attention.flash_attention``
(out) and ``repro.kernels.flash_attention_bwd.flash_attention_fwd`` (lse),
both in interpret mode, on the same bf16 inputs made with numpy.
Tolerances: out 2e-2 (the reference's bf16 ``_tol``), lse 1e-4 (f32).
The Pallas kernel gives a row with no unmasked column ``exp(s - m) = 1``
for its masked logits, i.e. the mean of v; the reference's rule, which
the port keeps, writes 0 there (``ref_attention``), so those rows are held
against ``ref_attention``.  The card check (chip_smoke.py) holds the CUDA
kernel against the plain version at the same tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention_bwd import \
    flash_attention_fwd as jax_flash_fwd
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (VARIANTS, choose,
                                                 flash_attention, variant)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_fwd, flash_attention_fwd_plain)

NEG_INF = -1e30
TILE = 128
RESUM = (16.0, 24.0)      # the kernel's tc::RESUM_MIN, tc::RESUM_WINDOW


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 32, 64, 80, 128])
def test_variant_rule(dtype, Dh):
    want = "wgmma" if dtype == torch.bfloat16 and Dh in (64, 80, 128) \
        else "simt"
    assert variant(Dh, dtype) == want
    assert variant(Dh, dtype, aligned=False) == "simt"


@pytest.mark.parametrize("wrapper", [flash_attention, flash_attention_fwd])
def test_cpu_tensors_take_plain_versions_and_count_no_launch(wrapper):
    q = torch.randn(1, 4, 16, 64).to(torch.bfloat16)
    k = torch.randn(1, 2, 16, 64).to(torch.bfloat16)
    before = wrapper.launches, dict(wrapper.variant_launches)
    got = wrapper(q, k, k, force="wgmma")
    out = got[0] if isinstance(got, tuple) else got
    torch.testing.assert_close(out, flash_attention_fwd_plain(q, k, k)[0])
    assert (wrapper.launches, wrapper.variant_launches) == before
    assert before == (0, dict.fromkeys(VARIANTS, 0))


@pytest.mark.parametrize("wrapper", [flash_attention, flash_attention_fwd])
@pytest.mark.parametrize("dtype,Dh,force", [
    (torch.bfloat16, 128, "tensor_cores"),      # no such variant
    (torch.float32, 64, "wgmma"),                # f32 would round to tf32
    (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 32, "wgmma"),
])
def test_forced_variant_that_cannot_take_the_call_raises(wrapper, dtype, Dh,
                                                         force):
    q = torch.zeros(1, 2, 8, Dh, dtype=dtype)
    with pytest.raises(ValueError):
        choose(q, q, q, force)
    before = dict(wrapper.variant_launches)
    with pytest.raises(ValueError):
        wrapper(q, q, q, force=force)
    assert wrapper.variant_launches == before
    assert fa_mod.choose(q, q, q, "simt") == "simt"


@pytest.mark.parametrize("wrapper", [flash_attention, flash_attention_fwd])
@pytest.mark.parametrize("Dh", [64, 128])
def test_no_kv_rows_take_simt(wrapper, Dh):
    q = torch.ones(1, 4, 8, Dh, dtype=torch.bfloat16)
    kv = torch.ones(1, 2, 0, Dh, dtype=torch.bfloat16)
    assert choose(q, kv, kv) == "simt"
    assert choose(q, kv, kv, "simt") == "simt"
    with pytest.raises(ValueError):
        choose(q, kv, kv, "wgmma")
    with pytest.raises(ValueError):
        wrapper(q, kv, kv, force="wgmma")
    if wrapper is flash_attention:      # every output row 0
        out = wrapper(q, kv, kv, causal=False)
        assert out.shape == q.shape and not out.any()


# ---------------------------------------------------------------------------
# the wgmma variant's arithmetic
# ---------------------------------------------------------------------------


def _mask(rows, cols, *, causal, window, kv_offset):
    r = rows[:, None] + kv_offset
    c = cols[None, :]
    mask = torch.ones((len(rows), len(cols)), dtype=torch.bool)
    if causal:
        mask &= c <= r
    if window is not None:
        mask &= c > r - window
    return mask


def _in_order_scores(qf, kf):
    """q k^T summed over the head dim in order, one f32 rounding per
    term: the f32 FMA chain, since a product of bf16 values is exact in
    f32 (the plain version's order)."""
    acc = torch.zeros(qf.shape[:-1] + kf.shape[-2:-1])
    for d in range(qf.shape[-1]):
        acc = acc + qf[..., d, None] * kf[..., None, :, d]
    return acc


def _k_step_scores(qf, kf):
    """q k^T as a model of the tensor cores' order: each k step's 16
    products summed exactly and rounded once, the steps added in f32.
    The hardware's own order is not documented; this one differs from
    the in-order chain by a few ulps, as the card's does."""
    acc = torch.zeros(qf.shape[:-1] + kf.shape[-2:-1])
    for d in range(0, qf.shape[-1], 16):
        step = qf[..., d:d + 16].double() @ \
            kf[..., d:d + 16].double().transpose(-1, -2)
        acc = acc + step.float()
    return acc


def emulate_wgmma(q, k, v, *, causal=True, window=None, kv_offset=0,
                  parts=1, resum=None):
    """The wgmma variant's arithmetic on bf16 q, k, v: per 128-row q tile,
    the kernel's kv tiles (128 columns; tiles wholly above the diagonal or
    before the window skipped), S = q k^T in f32, masked logits -inf;
    with ``resum = (lo, window)``, in rows whose running max ``top`` of
    ``x = S * scale`` (this tile's included) has |top| >= lo, the tile's
    S at or above ``(top - window) / scale`` replaced by the in-order
    sums; then the running max of x from -1e30, ``p = exp(x - m)``, l
    summed from the unrounded p, and P V with p as ``parts`` bf16 terms
    (bf16(p), then the bf16 rounding of what the terms before leave of
    p), f32 sums.
    Returns ``(out in bf16, out in f32, lse)``; a row with l == 0 writes
    0 and lse -1e30."""
    B, Hq, Sq, Dh = q.shape
    Skv = k.shape[2]
    group = Hq // k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32)
    qf = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    scores = _k_step_scores(qf, kf)
    in_order = _in_order_scores(qf, kf) if resum else None
    out = torch.zeros(B, Hq, Sq, Dh)
    lse = torch.empty(B, Hq, Sq)
    for q0 in range(0, Sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, Sq))
        kv_lo, kv_hi = 0, Skv
        if causal:
            kv_hi = min(kv_hi, int(rows[-1]) + kv_offset + 1)
        if window is not None:
            kv_lo = max(0, q0 + kv_offset - window + 1)
        kv_lo -= kv_lo % TILE
        m = torch.full((B, Hq, len(rows)), NEG_INF)
        l = torch.zeros(B, Hq, len(rows))
        acc = torch.zeros(B, Hq, len(rows), Dh)
        for c0 in range(kv_lo, kv_hi, TILE):
            cols = torch.arange(c0, min(c0 + TILE, Skv))
            s = scores[:, :, rows][..., cols]
            s = s.masked_fill(~_mask(rows, cols, causal=causal,
                                     window=window, kv_offset=kv_offset),
                              -math.inf)
            if resum:
                lo, width = resum
                top = torch.maximum(m, s.amax(-1) * scale)
                cut = ((top - width) / scale)[..., None]
                redo = ((top > NEG_INF) & (top.abs() >= lo))[..., None] \
                    & (s >= cut)
                s = torch.where(redo, in_order[:, :, rows][..., cols], s)
            x = s * scale
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            rest = p
            for _ in range(parts):
                term = rest.to(torch.bfloat16).float()
                acc = acc + term @ vf[:, :, cols]
                rest = rest - term
            m = m_new
        div = torch.where(l == 0, 1.0, l)
        out[:, :, rows] = acc / div[..., None]
        lse[:, :, rows] = m + torch.log(div)
    return out.to(q.dtype), out, lse


def _inputs(B, Hq, Hkv, Sq, Skv, Dh, seed, q_scale=1.0):
    """bf16 q, k, v from numpy, as torch tensors and as JAX arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, Dh), (B, Hkv, Skv, Dh), (B, Hkv, Skv, Dh))]
    arrs[0] *= q_scale
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    return ts, js


# the card sweeps' bf16 shapes at Dh 64 / 128 (what the wgmma variant
# takes), a multi-tile window, and q x 30 (softmax near one-hot, as at the
# reference init)
CASES = [
    ((1, 8, 8, 128, 128, 64), dict(causal=True), 1.0),
    ((1, 8, 8, 128, 128, 64), dict(causal=False), 1.0),
    ((2, 6, 3, 48, 48, 64), dict(causal=False), 1.0),
    ((1, 4, 2, 100, 100, 128), dict(causal=True), 1.0),
    ((1, 4, 2, 37, 77, 64), dict(causal=False), 1.0),
    ((1, 4, 2, 37, 77, 64), dict(causal=True, kv_offset=40), 1.0),
    ((1, 4, 2, 130, 200, 128), dict(causal=True, window=50, kv_offset=70),
     1.0),
    ((1, 2, 1, 40, 40, 64), dict(causal=True, kv_offset=-4), 1.0),
    ((1, 4, 2, 300, 300, 128), dict(causal=True, window=100), 1.0),
    ((1, 4, 2, 256, 256, 128), dict(causal=True), 30.0),
    # head dim 80 (h2o-danube), which the kernel runs in the 128-column
    # tile with the columns past 80 zero: 5 k steps of S, P V over 80
    ((1, 4, 2, 160, 160, 80), dict(causal=True, window=40), 1.0),
]
_JAX = {}


def _jax_reference(i):
    """(out, lse) of the Pallas kernels in interpret mode and the
    reference oracle's out, for CASES[i] (computed once per case)."""
    if i not in _JAX:
        shape, kw, q_scale = CASES[i]
        _, (jq, jk, jv) = _inputs(*shape, seed=i, q_scale=q_scale)
        out = jax_flash(jq, jk, jv, interpret=True, **kw)
        _, lse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
        ref = jax_ref_attention(jq, jk, jv, **kw)
        _JAX[i] = tuple(np.array(x.astype(jnp.float32))
                        for x in (out, lse, ref))
    return _JAX[i]


# P in 1, 2 or 3 bf16 terms; 3 terms with the large logits re-summed
FORMS = [(1, None), (2, None), (3, None), (3, RESUM)]


@pytest.mark.parametrize("parts,resum", FORMS)
@pytest.mark.parametrize("i", range(len(CASES)))
def test_wgmma_arithmetic_matches_jax_kernels(i, parts, resum):
    shape, kw, q_scale = CASES[i]
    (q, k, v), _ = _inputs(*shape, seed=i, q_scale=q_scale)
    out, _, lse = emulate_wgmma(q, k, v, parts=parts, resum=resum, **kw)
    want_out, want_lse, ref = (x.copy() for x in _jax_reference(i))
    Sq, Skv = shape[3], shape[4]
    masked = ~_mask(torch.arange(Sq), torch.arange(Skv), causal=kw["causal"],
                    window=kw.get("window"),
                    kv_offset=kw.get("kv_offset", 0)).any(-1).numpy()
    want_out[:, :, masked] = ref[:, :, masked]      # the reference's rule
    assert not out[:, :, torch.from_numpy(masked)].any()
    np.testing.assert_allclose(out.float().numpy(), want_out, rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-4, atol=1e-4)
    # what the card holds the kernel to: the plain version, same tolerances
    plain_out, plain_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out, plain_out, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("i", [3, 9])
def test_resum_brings_large_logits_to_the_plain_order(i):
    """At randn scale (case 3, |x| < 16) the re-summation changes nothing;
    at q x 30 (case 9) it gives the largest logits the plain version's
    in-order sums, so the output lies nearer the plain one."""
    shape, kw, q_scale = CASES[i]
    (q, k, v), _ = _inputs(*shape, seed=i, q_scale=q_scale)
    plain = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                      **kw)[0]
    base = emulate_wgmma(q, k, v, parts=3, **kw)[1]
    redone = emulate_wgmma(q, k, v, parts=3, resum=RESUM, **kw)[1]
    if q_scale == 1.0:
        assert torch.equal(base, redone)
    else:
        gap = [float((o - plain).abs().max()) for o in (base, redone)]
        assert gap[1] < gap[0] / 10


@pytest.mark.parametrize("i", [3, 9])
def test_more_p_terms_lie_nearer_f32(i):
    """With the large logits re-summed (so S's order matters only below
    |x| 16), each further P term brings the output nearer f32."""
    shape, kw, q_scale = CASES[i]
    (q, k, v), _ = _inputs(*shape, seed=i, q_scale=q_scale)
    exact = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                      **kw)[0]
    err = [float((emulate_wgmma(q, k, v, parts=n, resum=RESUM, **kw)[1]
                  - exact).abs().max()) for n in (1, 2, 3)]
    assert err[0] >= err[1] >= err[2]
    assert err[1] < 1e-4 and err[2] < 1e-5
