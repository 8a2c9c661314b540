"""The port's round-k datatype pack/unpack (repro_torch.kernels.
block_reorder) against the JAX reference kernels.

On this CPU the wrappers take their plain versions (a CUDA kernel has no
interpret mode); the JAX side runs the Pallas kernels in interpret mode,
as tests/test_kernels.py does, on the same sweep of tori.  Inputs come
from numpy with a seed.  The functions are pure data movement, so every
comparison is bit-exact.  chip_smoke.py holds the CUDA kernel against
these plain versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_reorder import datatype_pack as jax_pack
from repro.kernels.block_reorder import datatype_unpack as jax_unpack
from repro_torch.core.simulator import round_datatype
from repro_torch.kernels import block_reorder as br
from repro_torch.kernels import ops

SWEEP = [(5, 4), (2, 3, 4), (4, 3, 3, 4), (2, 2, 2, 2), (6,), (3, 2)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _pair(dims, B, dtype, seed=0):
    """The same (p, B) values in both packages."""
    p = math.prod(dims)
    a = np.random.default_rng(seed).standard_normal((p, B)) * 100
    t_dtype, j_dtype = DTYPES[dtype]
    t = torch.from_numpy(a).to(t_dtype)
    j = jnp.asarray(a).astype(j_dtype)
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.float().numpy())
    return t, j


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dims", SWEEP)
def test_pack_matches_jax_kernel(dims, dtype):
    x, jx = _pair(dims, 5, dtype)
    for k in range(len(dims)):
        got = br.datatype_pack(x, dims=dims, k=k)
        want = jax_pack(jx, dims=dims, k=k, interpret=True)
        np.testing.assert_array_equal(_np(got), _jnp(want))
        assert got.dtype == x.dtype
        back = br.datatype_unpack(got, dims=dims, k=k)
        assert torch.equal(back, x)                 # unpack(pack(x)) == x
        if dtype == "float32":
            np.testing.assert_array_equal(
                _np(back), _jnp(jax_unpack(want, dims=dims, k=k,
                                           interpret=True)))


@pytest.mark.parametrize("dims", SWEEP)
def test_natural_order_is_the_movedim_order(dims):
    """The natural variant packs what the reference's in-place natural
    round exchanges: peer j's message is the digit-k slice j of the
    reversed(dims) block view, in that view's order."""
    x, _ = _pair(dims, 3, "float32", seed=1)
    d, p = len(dims), math.prod(dims)
    view = x.reshape(tuple(reversed(dims)) + (3,))
    for k in range(d):
        want = view.movedim(d - 1 - k, 0).reshape(p, 3)
        got = br.datatype_pack(x, dims=dims, k=k, variant="natural")
        assert torch.equal(got, want)
        assert torch.equal(br.datatype_unpack(got, dims=dims, k=k,
                                              variant="natural"), x)


@pytest.mark.parametrize("dims", SWEEP)
def test_paper_positions_are_round_datatype(dims):
    for k in range(len(dims)):
        positions, extent = round_datatype(dims, k)
        assert br.round_positions(dims, k, "paper") == \
            (tuple(positions), extent)
        sigma, Dk, sizes, strides = br.round_tiles(dims, k, "natural")
        assert (sigma, Dk) == (extent, dims[k])
        assert sizes == tuple(reversed(dims[k + 1:]))
        assert sigma * math.prod(sizes) * Dk == math.prod(dims)


def test_odd_sizes_and_dtypes_round_trip():
    for dims, B in (((5, 4), 1), ((2, 3, 4), 7), ((3, 2), 0), ((6,), 33)):
        p = math.prod(dims)
        for dtype in (torch.float64, torch.int8, torch.bool, torch.int16):
            x = torch.from_numpy(np.random.default_rng(2).integers(
                0, 100, (p, B))).to(dtype)
            for k in range(len(dims)):
                for variant in br.VARIANTS:
                    y = ops.pack_round(x, dims, k, variant=variant)
                    assert torch.equal(
                        ops.unpack_round(y, dims, k, variant=variant), x)


def test_ops_follow_the_device_and_plain_versions():
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    want = br.datatype_pack_plain(x, dims=(2, 3, 4), k=1)
    assert torch.equal(ops.pack_round(x, (2, 3, 4), 1), want)
    assert torch.equal(ops.pack_round(x, (2, 3, 4), 1, impl="torch"), want)
    with ops.plain_versions():
        assert torch.equal(ops.unpack_round(want, (2, 3, 4), 1), x)
    assert ops._PLAIN is False
    # CPU tensors never launch (or count) the kernel
    assert (br.datatype_pack.launches, br.datatype_unpack.launches) == (0, 0)
    with pytest.raises(ValueError):
        ops.pack_round(x, (2, 3, 4), 1, impl="cuda")


@pytest.mark.parametrize("x,dims,k,variant,err", [
    (torch.zeros(24), (2, 3, 4), 0, "paper", ValueError),          # 1-D
    (torch.zeros(24, 2), (5, 4), 0, "paper", ValueError),         # p
    (torch.zeros(2, 24).t(), (2, 3, 4), 0, "paper", ValueError),  # strided
    (torch.zeros(24, 2), (2, 3, 4), 3, "paper", ValueError),      # k
    (torch.zeros(24, 2), (2, 3, 4), 0, "sideways", ValueError),   # variant
    (torch.zeros(2 ** 9, 1), (2,) * 9, 0, "paper", ValueError),   # d > 8
])
def test_kernel_checks(x, dims, k, variant, err):
    with pytest.raises(err):
        br._check(x, dims, k, variant)
    with pytest.raises(err):
        br.datatype_pack(x, dims=dims, k=k, variant=variant)


def test_wrappers_refuse_other_devices():
    y = torch.empty(6, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        br.datatype_pack(y, dims=(3, 2), k=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        br.datatype_unpack(y, dims=(3, 2), k=0)
