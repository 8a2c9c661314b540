"""The Python side of the port's grouped matmul (repro_torch) that the CPU
can check: which kernel variant a call takes, which operand layouts the
wrapper accepts, and ``GroupedMatmulFn``'s backward on transposed views
against autograd of the plain gmm and the JAX reference's gradient; and the
flash backward wrapper's kv-head gradients.  The kernels themselves run
only on the card (``chip_smoke.py`` holds each against its plain version
there).

Tolerances: the gmm gradients at 2e-5, the reference's own
(``tests/test_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import moe_gmm
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd_plain)
from repro_torch.kernels.moe_gmm import (GroupedMatmulFn, grouped_matmul,
                                         variant)
from repro_torch.kernels.ref import ref_gmm

BF16, F32 = torch.bfloat16, torch.float32
E, D, F = 16, 4096, 6400            # phi3.5-moe: experts, d_model, d_ff


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# variant dispatch
# ---------------------------------------------------------------------------

# (what, (E, C, K, N), layouts): every main-path product.  Forward: lhs
# row-major ("k"), rhs row-major ("mn").  dlhs = dout @ rhs^T reads rhs^T
# K-major; drhs = lhs^T @ dout reads lhs^T C-major.
MAIN_PATH = [
    ("decode w1/w3", (E, 4, D, F), ("k", "mn"), "decode"),
    ("decode w2", (E, 4, F, D), ("k", "mn"), "decode"),
    ("prefill w1/w3", (E, 640, D, F), ("k", "mn"), "wgmma"),
    ("prefill w2", (E, 640, F, D), ("k", "mn"), "wgmma"),
    ("EP w1/w3", (4, 512, D, F), ("k", "mn"), "wgmma"),
    ("EP w2", (4, 512, F, D), ("k", "mn"), "wgmma"),
    ("dlhs w1/w3", (E, 640, F, D), ("k", "k"), "wgmma"),
    ("drhs w1/w3", (E, D, 640, F), ("mn", "mn"), "wgmma"),
    ("dlhs w2", (E, 640, D, F), ("k", "k"), "wgmma"),
    ("drhs w2", (E, F, 640, D), ("mn", "mn"), "wgmma"),
]


@pytest.mark.parametrize("what,shape,layouts,want", MAIN_PATH,
                         ids=[m[0] for m in MAIN_PATH])
def test_main_path_shapes_take_the_tensor_core_variants(what, shape, layouts,
                                                        want):
    assert variant(*shape, BF16, layouts) == want


@pytest.mark.parametrize("shape", [(16, 4, 12, 20), (3, 9, 33, 130),
                                   (5, 7, 300, 3), (2, 130, 17, 129)])
@pytest.mark.parametrize("layouts", [("k", "mn"), ("k", "k"), ("mn", "mn"),
                                     ("mn", "k")])
def test_unaligned_shapes_take_simt(shape, layouts):
    assert variant(*shape, BF16, layouts) == "simt"


@pytest.mark.parametrize("what,shape,layouts,_", MAIN_PATH,
                         ids=[m[0] for m in MAIN_PATH])
def test_f32_and_misaligned_bases_take_simt(what, shape, layouts, _):
    assert variant(*shape, F32, layouts) == "simt"
    assert variant(*shape, BF16, layouts, aligned=False) == "simt"


def test_variant_edges():
    # decode needs both operands in their natural layout; a C-major lhs
    # needs C aligned to 8; K = 0 has nothing to contract
    assert variant(2, 16, 64, 64, BF16) == "decode"
    assert variant(2, 17, 64, 64, BF16) == "wgmma"
    assert variant(2, 4, 64, 64, BF16, ("k", "k")) == "wgmma"
    assert variant(2, 12, 64, 64, BF16, ("mn", "mn")) == "simt"
    assert variant(2, 16, 64, 64, BF16, ("mn", "mn")) == "wgmma"
    assert variant(2, 64, 0, 64, BF16) == "simt"


# ---------------------------------------------------------------------------
# the wrapper's layout check
# ---------------------------------------------------------------------------

def _views(E, C, K, N):
    lhs = {"k": torch.zeros(E, C, K),
           "mn": torch.zeros(E, K, C).transpose(1, 2)}
    rhs = {"mn": torch.zeros(E, K, N),
           "k": torch.zeros(E, N, K).transpose(1, 2)}
    return lhs, rhs


@pytest.mark.parametrize("lhs_major", ["k", "mn"])
@pytest.mark.parametrize("rhs_major", ["k", "mn"])
def test_check_accepts_both_layouts_of_each_operand(lhs_major, rhs_major):
    lhs, rhs = _views(3, 8, 16, 24)
    assert moe_gmm._check(lhs[lhs_major], rhs[rhs_major]) \
        == (lhs_major, rhs_major)


@pytest.mark.parametrize("lhs,rhs", [
    (torch.zeros(2, 4, 16)[:, :, ::2], torch.zeros(2, 8, 4)),   # K stride 2
    (torch.zeros(2, 4, 8), torch.zeros(2, 8, 8)[:, :, :4]),     # row pitch 8
    (torch.zeros(4, 2, 8).transpose(0, 1), torch.zeros(2, 8, 4)),  # E inner
    (torch.zeros(2, 4, 8), torch.zeros(1, 8, 4).expand(2, 8, 4)),  # broadcast
    (torch.zeros(2, 5, 8)[:, :4], torch.zeros(2, 8, 4)),       # E pitch
])
def test_check_refuses_other_layouts(lhs, rhs):
    with pytest.raises(ValueError):
        moe_gmm._check(lhs, rhs)


# jamba-v0.1-52b's expert FFN (E 16, d 4096, F 14336) at a 65 536-token
# prefill (C = 10240): E * C * N = 2.35e9 elements past 2^31, and the
# backward's drhs of w1 in its C-major / N-major layouts
JAMBA_C = 10240
PAST_2_31 = [
    ("w1", (16, JAMBA_C, 4096, 14336), ("k", "mn")),
    ("w2", (16, JAMBA_C, 14336, 4096), ("k", "mn")),
    ("drhs w1", (16, 4096, JAMBA_C, 14336), ("mn", "mn")),
]


def _meta(E, C, K, N, layouts):
    lhs = torch.empty(E, C, K, dtype=BF16, device="meta") \
        if layouts[0] == "k" else \
        torch.empty(E, K, C, dtype=BF16, device="meta").transpose(1, 2)
    rhs = torch.empty(E, K, N, dtype=BF16, device="meta") \
        if layouts[1] == "mn" else \
        torch.empty(E, N, K, dtype=BF16, device="meta").transpose(1, 2)
    return lhs, rhs


@pytest.mark.parametrize("what,shape,layouts", PAST_2_31,
                         ids=[m[0] for m in PAST_2_31])
def test_check_takes_products_past_2_31_elements(what, shape, layouts):
    E, C, K, N = shape
    assert max(C * K, K * N, C * N) * E >= 2 ** 31
    assert moe_gmm._check(*_meta(E, C, K, N, layouts)) == layouts
    which = variant(E, C, K, N, BF16, layouts)
    assert which == "wgmma"
    moe_gmm._check_launch(E, C, K, N, which)


@pytest.mark.parametrize("call", [
    lambda: moe_gmm._check(*_meta(1, 2 ** 31, 8, 8, ("k", "mn"))),
    lambda: moe_gmm._check(*_meta(1, 8, 8, 2 ** 31, ("k", "k"))),
    lambda: moe_gmm._check_launch(65536, 4, 8, 8, "decode"),
    lambda: moe_gmm._check_launch(65536, 640, 8, 8, "wgmma"),
    lambda: moe_gmm._check_launch(1, 640, 8, 256 * 65535 + 8, "wgmma"),
    lambda: moe_gmm._check_launch(1, 128 * 65535 + 1, 8, 8, "simt"),
    lambda: moe_gmm._check_launch(1, 2 ** 26, 2 ** 13, 8, "wgmma"),
], ids=["C 2^31", "N 2^31", "decode grid y", "wgmma grid z",
        "wgmma grid y", "simt grid y", "TMA stride 2^40 B"])
def test_check_refuses_what_is_32_bit(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# GroupedMatmulFn's backward: transposed views, no copies
# ---------------------------------------------------------------------------

def test_backward_passes_views_not_copies(monkeypatch):
    lhs = torch.randn(2, 8, 16, requires_grad=True)
    rhs = torch.randn(2, 16, 24, requires_grad=True)
    calls = []

    def recording(a, b):
        calls.append((a, b))
        return ref_gmm(a, b)
    monkeypatch.setattr(moe_gmm, "grouped_matmul", recording)
    GroupedMatmulFn.apply(lhs, rhs).sum().backward()
    (_, _), (_, rhs_t), (lhs_t, _) = calls
    assert rhs_t.data_ptr() == rhs.data_ptr()
    assert rhs_t.stride() == (384, 1, 24)
    assert lhs_t.data_ptr() == lhs.data_ptr()
    assert lhs_t.stride() == (128, 1, 16)
    assert [moe_gmm._check(a, b) for a, b in calls] == \
        [("k", "mn"), ("k", "k"), ("mn", "mn")]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("E_,C,K,N", [(4, 16, 32, 24), (2, 128, 64, 128),
                                      (16, 4, 12, 20)])
def test_backward_equals_autograd_of_plain_gmm_bit_for_bit(dtype, E_, C, K,
                                                           N):
    lhs, rhs, dout = (torch.from_numpy(_normal(s, *shape)).to(dtype)
                      for s, shape in ((70, (E_, C, K)), (71, (E_, K, N)),
                                       (72, (E_, C, N))))
    a1, b1 = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    got = torch.autograd.grad(GroupedMatmulFn.apply(a1, b1), (a1, b1), dout)
    a2, b2 = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    want = torch.autograd.grad(ref_gmm(a2, b2), (a2, b2), dout)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("E_,C,K,N", [(4, 16, 32, 24), (3, 40, 24, 16)])
def test_backward_matches_jax_grad_of_ref_gmm(E_, C, K, N):
    lhs, rhs, dout = (_normal(80, E_, C, K), _normal(81, E_, K, N),
                      _normal(82, E_, C, N))
    want = jax.grad(lambda a, b: jnp.sum(jax_ref.ref_gmm(a, b) * dout),
                    argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = (torch.from_numpy(x.copy()).requires_grad_() for x in (lhs, rhs))
    got = torch.autograd.grad(GroupedMatmulFn.apply(tl, tr), (tl, tr),
                              torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_cpu_calls_count_no_variant_launch():
    before = dict(grouped_matmul.variant_launches)
    a = torch.randn(2, 8, 16, requires_grad=True)
    b = torch.randn(2, 16, 8, requires_grad=True)
    GroupedMatmulFn.apply(a, b).sum().backward()
    assert grouped_matmul.variant_launches == before
    assert set(before) == set(moe_gmm.VARIANTS)


# ---------------------------------------------------------------------------
# the flash backward wrapper's kv-head gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,kw", [
    (1, 4, 1, 32, 16, dict(causal=True)),
    (2, 6, 3, 24, 32, dict(causal=False)),
    (1, 8, 2, 40, 16, dict(causal=True, window=8)),
])
def test_flash_bwd_wrapper_returns_kv_head_gradients(B, Hq, Hkv, S, Dh, kw):
    q, k, v, do = (torch.from_numpy(_normal(90 + i, *shape))
                   for i, shape in enumerate([(B, Hq, S, Dh), (B, Hkv, S, Dh),
                                              (B, Hkv, S, Dh),
                                              (B, Hq, S, Dh)]))
    out, lse = flash_attention_fwd_plain(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == (B, Hkv, S, Dh)
    for got, want in zip((dq, dk, dv), flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw)):
        assert torch.equal(got, want)
