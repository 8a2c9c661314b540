"""Port kernels (repro_torch) against the JAX reference kernels.

On this CPU the port's wrappers take their plain PyTorch versions (a CUDA
kernel has no interpret mode); the JAX side runs the Pallas kernels in
interpret mode, as tests/test_kernels.py does.  Inputs come from numpy
with a seed and go to both packages.  Tolerances: 1e-5 (gmm, f32) and
2e-5 (attention, f32) as in tests/test_kernels.py; bf16 gets the
reference's 2e-2 / 3e-2.  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.moe_gmm import grouped_matmul as jax_gmm
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_gmm import grouped_matmul, grouped_matmul_plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _bf16_pair(a):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,C,K,N", [
    (4, 16, 32, 24), (2, 128, 64, 128), (8, 8, 8, 8), (1, 256, 128, 64),
    (16, 4, 12, 20),
])
def test_gmm_plain_matches_jax_kernel(E, C, K, N):
    a, b = _normal(0, E, C, K), _normal(1, E, K, N)
    want = jax_gmm(jnp.asarray(a), jnp.asarray(b), block_c=32, block_n=32,
                   block_k=16, interpret=True)
    got = grouped_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (E, C, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gmm_plain_bf16_matches_jax_kernel():
    ja, ta = _bf16_pair(_normal(2, 2, 32, 32))
    jb, tb = _bf16_pair(_normal(3, 2, 32, 16))
    want = jax_gmm(ja, jb, block_c=16, block_n=16, block_k=16,
                   interpret=True)
    got = grouped_matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _qkv(B, Hq, Hkv, Sq, Skv, Dh, seed=0):
    return (_normal(seed, B, Hq, Sq, Dh), _normal(seed + 1, B, Hkv, Skv, Dh),
            _normal(seed + 2, B, Hkv, Skv, Dh))


def _flash_pair(q, k, v, *, block_q=16, block_k=16, **kw):
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=block_q, block_k=block_k, interpret=True, **kw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh", [
    (1, 2, 2, 64, 32), (2, 4, 2, 32, 16), (1, 4, 1, 64, 32),
    (1, 8, 8, 128, 64), (2, 6, 3, 48, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel(B, Hq, Hkv, S, Dh, causal):
    got, want = _flash_pair(*_qkv(B, Hq, Hkv, S, S, Dh), causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [1, 8, 16, 64])
def test_flash_plain_sliding_window(window):
    got, want = _flash_pair(*_qkv(1, 2, 2, 64, 64, 32), causal=True,
                            window=window)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_kv_offset_decode():
    got, want = _flash_pair(*_qkv(1, 2, 2, 8, 64, 32), causal=True,
                            kv_offset=56, block_q=8)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_bf16():
    q, k, v = _qkv(1, 4, 2, 32, 32, 32)
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    want = jax_flash(jq, jk, jv, block_q=16, block_k=16, interpret=True)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_flash_plain_fully_masked_rows_give_zero():
    # kv_offset < 0 leaves the first rows without any visible key: the
    # reference oracle (and the CUDA kernel's l == 0 rule) writes 0 there
    q, k, v = _qkv(1, 2, 1, 16, 16, 16)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                kv_offset=-4)
    want = jax_ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, kv_offset=-4)
    assert not got[:, :, :4].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# dispatch: device decides, no fallback, counters
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    gmm0, fa0 = grouped_matmul.launches, flash_attention.launches
    a, b = torch.randn(2, 4, 8), torch.randn(2, 8, 4)
    q, k = torch.randn(1, 2, 8, 16), torch.randn(1, 1, 8, 16)
    torch.testing.assert_close(ops.expert_matmul(a, b),
                               grouped_matmul_plain(a, b))
    torch.testing.assert_close(ops.attention(q, k, k),
                               flash_attention_plain(q, k, k))
    torch.testing.assert_close(ops.attention(q, k, k, impl="torch"),
                               flash_attention_plain(q, k, k))
    with ops.plain_versions():
        ops.expert_matmul(a, b)
    assert ops._PLAIN is False
    assert (grouped_matmul.launches, flash_attention.launches) == (gmm0, fa0)
    assert (gmm0, fa0) == (0, 0)
    with pytest.raises(ValueError):
        ops.expert_matmul(a, b, impl="pallas")


def test_wrappers_refuse_other_devices():
    a = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        grouped_matmul(a, torch.empty(2, 8, 4, device="meta"))
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("lhs,rhs,err", [
    (torch.zeros(2, 4, 8), torch.zeros(2, 4, 8), ValueError),       # K != K
    (torch.zeros(2, 4, 8), torch.zeros(3, 8, 4), ValueError),       # E != E
    (torch.zeros(2, 4, 8, dtype=torch.float16),
     torch.zeros(2, 8, 4, dtype=torch.float16), TypeError),
    (torch.zeros(2, 4, 8), torch.zeros(2, 8, 4, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(2, 4, 16)[:, :, ::2], torch.zeros(2, 8, 4),
     ValueError),                                                    # strided
])
def test_gmm_kernel_checks(lhs, rhs, err):
    with pytest.raises(err):
        gmm_mod._check(lhs, rhs)


@pytest.mark.parametrize("q,k,err", [
    (torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24), ValueError),  # Dh
    (torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16), ValueError),  # GQA
    (torch.zeros(1, 4, 8, 16, dtype=torch.float16),
     torch.zeros(1, 2, 8, 16, dtype=torch.float16), TypeError),
    (torch.zeros(1, 4, 16, 8).transpose(2, 3), torch.zeros(1, 2, 8, 16),
     ValueError),                                                  # strided
])
def test_flash_kernel_checks(q, k, err):
    with pytest.raises(err):
        fa_mod._check(q, k, k)


def test_kernel_sources_build_for_sm90a():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f"repro_{name}(" in src            # the C entry point
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and name in path.name
