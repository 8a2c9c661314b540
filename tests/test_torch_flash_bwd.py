"""The port's trainable kernels (repro_torch) against the JAX reference.

``flash_attention_fwd`` / ``flash_attention_bwd`` and the autograd
Functions ``FlashAttentionFn`` / ``GroupedMatmulFn`` take their plain
versions on CPU tensors, so these tests hold those plain versions, and the
Functions' own backward formulas, against the reference's Pallas kernels
in interpret mode and against autodiff of its oracles, on the same numpy
inputs.  The card runs the CUDA kernels against the same plain versions
(``chip_smoke.py``).

Tolerances are the reference's own (``tests/test_kernels.py``): the
forward's out and lse at 2e-5 (f32), gradients at 2e-4, the grouped
matmul's gradients at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention_bwd import (
    flash_attention_bwd as jax_flash_bwd,
    flash_attention_fwd as jax_flash_fwd)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention_bwd import (
    FlashAttentionFn, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.kernels.moe_gmm import GroupedMatmulFn, grouped_matmul

# the shapes of the reference's backward test (tests/test_kernels.py)
SHAPES = [(1, 2, 2, 32, 16, True, None), (2, 4, 2, 32, 16, True, None),
          (1, 4, 1, 32, 16, False, None), (1, 2, 2, 48, 16, True, 8),
          (1, 8, 2, 64, 32, True, None)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _inputs(B, Hq, Hkv, S, Dh, seed=0):
    return (_normal(seed, B, Hq, S, Dh), _normal(seed + 1, B, Hkv, S, Dh),
            _normal(seed + 2, B, Hkv, S, Dh), _normal(seed + 3, B, Hq, S, Dh))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal,window", SHAPES)
def test_fwd_plain_matches_jax_kernel(B, Hq, Hkv, S, Dh, causal, window):
    q, k, v, _ = _inputs(B, Hq, Hkv, S, Dh)
    want_out, want_lse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=16, block_k=16, interpret=True)
    out, lse = flash_attention_fwd_plain(*_t(q, k, v), causal=causal,
                                         window=window)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    _close(out.numpy(), want_out, 2e-5)
    _close(lse.numpy(), want_lse, 2e-5)


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal,window", SHAPES)
def test_bwd_plain_matches_jax_kernel(B, Hq, Hkv, S, Dh, causal, window):
    q, k, v, do = _inputs(B, Hq, Hkv, S, Dh, seed=10)
    kw = dict(causal=causal, window=window, block_q=16, block_k=16,
              interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jax_flash_fwd(jq, jk, jv, **kw)
    want = jax_flash_bwd(jq, jk, jv, out, lse, jdo, **kw)
    got = flash_attention_bwd_plain(
        *_t(q, k, v, np.asarray(out), np.asarray(lse), do), causal=causal,
        window=window)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, 2e-4)


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal,window", SHAPES)
def test_function_grads_match_autodiff_of_ref_attention(
        B, Hq, Hkv, S, Dh, causal, window):
    q, k, v, do = _inputs(B, Hq, Hkv, S, Dh, seed=20)

    def f_ref(q, k, v):
        return jnp.sum(jax_ref.ref_attention(q, k, v, causal=causal,
                                             window=window) * do)

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = FlashAttentionFn.apply(tq, tk, tv, causal, window, None, 0)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 2e-4)


def test_fully_masked_rows_give_zero_out_and_grads():
    # kv_offset -4: query rows 0-3 see no key under the causal mask
    q, k, v, do = _inputs(1, 2, 1, 16, 16, seed=30)
    out, lse = flash_attention_fwd_plain(*_t(q, k, v), causal=True,
                                         kv_offset=-4)
    assert torch.all(out[:, :, :4] == 0)
    assert torch.all(lse[:, :, :4] == -1e30)
    assert torch.isfinite(lse[:, :, 4:]).all()
    dq, dk, dv = flash_attention_bwd_plain(*_t(q, k, v), out, lse,
                                           *_t(do), causal=True,
                                           kv_offset=-4)
    assert torch.all(dq[:, :, :4] == 0)
    # keys past the last visible one (12..15) get no gradient
    assert torch.all(dk[:, :, 12:] == 0) and torch.all(dv[:, :, 12:] == 0)


@pytest.mark.parametrize("E,C,K,N", [(4, 16, 32, 24), (2, 128, 64, 128),
                                     (16, 4, 12, 20)])
def test_gmm_function_grads_match_autodiff_of_ref_gmm(E, C, K, N):
    lhs, rhs, dout = (_normal(40, E, C, K), _normal(41, E, K, N),
                      _normal(42, E, C, N))
    _, vjp = jax.vjp(jax_ref.ref_gmm, jnp.asarray(lhs), jnp.asarray(rhs))
    want = vjp(jnp.asarray(dout))
    tl, tr = _t(lhs, rhs, grad=True)
    out = GroupedMatmulFn.apply(tl, tr)
    assert type(out.grad_fn).__name__ == "GroupedMatmulFnBackward"
    got = torch.autograd.grad(out, (tl, tr), torch.from_numpy(dout))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 2e-5)


def test_ops_route_through_the_functions_only_under_autograd():
    q, k, v, _ = _inputs(1, 4, 2, 32, 16, seed=50)
    tq, tk, tv = _t(q, k, v, grad=True)
    lhs, rhs = _t(_normal(51, 2, 8, 16), _normal(52, 2, 16, 8), grad=True)
    assert type(ops.attention(tq, tk, tv).grad_fn).__name__ \
        == "FlashAttentionFnBackward"
    assert type(ops.expert_matmul(lhs, rhs).grad_fn).__name__ \
        == "GroupedMatmulFnBackward"
    with torch.no_grad():                 # serving: the forward kernels
        assert ops.attention(tq, tk, tv).grad_fn is None
        assert ops.expert_matmul(lhs, rhs).grad_fn is None
    with ops.plain_versions():            # the reference run: autograd
        names = {type(ops.attention(tq, tk, tv).grad_fn).__name__,
                 type(ops.expert_matmul(lhs, rhs).grad_fn).__name__}
        assert not names & {"FlashAttentionFnBackward",
                            "GroupedMatmulFnBackward"}


def test_cpu_tensors_count_no_launch():
    q, k, v, do = _t(*_inputs(1, 2, 2, 16, 16, seed=60))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches,
              grouped_matmul.launches)
    out, lse = flash_attention_fwd(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, do)
    a, b = _t(_normal(61, 2, 4, 8), _normal(62, 2, 8, 4), grad=True)
    GroupedMatmulFn.apply(a, b).sum().backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches,
            grouped_matmul.launches) == before


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 2, 16, 16), device="meta")
    lse = torch.empty((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(q, q, q, q, lse, q)
