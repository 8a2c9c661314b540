"""The port's round-k datatype pack/unpack (repro_torch.kernels.
block_reorder) against the JAX reference kernels.

On this CPU the wrappers take their plain versions (a CUDA kernel has no
interpret mode); the JAX side runs the Pallas kernels in interpret mode,
as tests/test_kernels.py does, on the same sweep of tori.  Inputs come
from numpy with a seed.  The functions are pure data movement, so every
comparison is bit-exact.  chip_smoke.py holds the CUDA kernel against
these plain versions on the card.  The fused round boundary
(``datatype_repack``), the row maps and their runs, the group-order
folding and ``core.factorized.round_schedule`` are held here too.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_reorder import datatype_pack as jax_pack
from repro.kernels.block_reorder import datatype_unpack as jax_unpack
from repro_torch.core.factorized import round_schedule
from repro_torch.core.simulator import round_datatype
from repro_torch.kernels import block_reorder as br
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _peer_index

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
    (torch.zeros(4, 2), (-2, -2), 0, "paper", ValueError),        # dim < 1
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


def _expand_runs(g, run_src):
    """The row map that ``map_runs`` collapsed."""
    return tuple(s * g + i for s in run_src for i in range(g))


def _pairs(d):
    return [(ku, kp) for ku in range(d) for kp in range(d)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dims", SWEEP)
def test_repack_matches_jax_kernels(dims, dtype):
    """The fused pass (paper order) == the JAX unpack then the JAX pack,
    for every ordered pair of rounds."""
    x, jx = _pair(dims, 5, dtype, seed=3)
    unpacked = {k: jax_unpack(jx, dims=dims, k=k, interpret=True)
                for k in range(len(dims))}
    for ku, kp in _pairs(len(dims)):
        got = br.datatype_repack(x, dims=dims, k_unpack=ku, k_pack=kp)
        want = jax_pack(unpacked[ku], dims=dims, k=kp, interpret=True)
        np.testing.assert_array_equal(_np(got), _jnp(want))
        assert got.dtype == x.dtype


@pytest.mark.parametrize("variant", br.VARIANTS)
@pytest.mark.parametrize("dims", SWEEP)
def test_repack_is_the_composition(dims, variant):
    """Both variants: the fused pass == the port's plain unpack then pack
    == the row map applied as an index."""
    x, _ = _pair(dims, 3, "float32", seed=4)
    for ku, kp in _pairs(len(dims)):
        want = br.datatype_pack_plain(
            br.datatype_unpack_plain(x, dims=dims, k=ku, variant=variant),
            dims=dims, k=kp, variant=variant)
        got = ops.repack_round(x, dims, ku, kp, variant=variant)
        assert torch.equal(got, want)
        rmap = br.row_map(dims, ku, kp, variant)
        assert torch.equal(x[torch.tensor(rmap)], want)
        assert br.is_identity(rmap) == (ku == kp)


@pytest.mark.parametrize("dims", SWEEP)
def test_row_maps_and_their_runs(dims):
    """Each pass's row map collapses into runs of g rows whose expansion
    is the map again; the pack's map is the plain version's index and g
    is the coarsest uniform run length."""
    p = math.prod(dims)
    for variant in br.VARIANTS:
        for k in range(len(dims)):
            positions, extent = br.round_positions(dims, k, variant)
            index = _peer_index(positions, extent, dims[k], "cpu")
            assert br.row_map(dims, None, k, variant) == \
                tuple(index.tolist())
            unpack = br.row_map(dims, k, None, variant)
            assert [unpack[i] for i in index.tolist()] == list(range(p))
        for ku, kp in [(None, k) for k in range(len(dims))] \
                + [(k, None) for k in range(len(dims))] \
                + _pairs(len(dims)):
            rmap = br.row_map(dims, ku, kp, variant)
            g, run_src = br.map_runs(rmap)
            assert p % g == 0 and len(run_src) == p // g
            assert _expand_runs(g, run_src) == rmap
            assert sorted(run_src) == list(range(p // g))
            if g < p:        # no coarser uniform run length fits
                assert any(_expand_runs(m * g, [
                    rmap[r] // (m * g) for r in range(0, p, m * g)]) != rmap
                    for m in range(2, p // g + 1) if (p // g) % m == 0)


def test_runs_of_a_two_by_two_round():
    """The (2,2) torus's passes move 4 runs of a quarter of the buffer."""
    assert br.map_runs(br.row_map((2, 2), None, 0)) == (1, (0, 2, 1, 3))
    assert br.map_runs(br.row_map((2, 2), 0, 1)) == (1, (0, 2, 1, 3))
    assert br.map_runs(br.row_map((2, 2), None, 1)) == (4, (0,))
    assert br.map_runs(br.row_map((4, 2), None, 0)) == (1, tuple(
        r // 2 + 4 * (r % 2) for r in range(8)))
    assert br.map_runs(br.row_map((2, 4), None, 0)) == (1, tuple(
        2 * (r % 4) + r // 4 for r in range(8)))
    assert br.map_runs(br.row_map((2, 3, 4), None, 1)) == (2, tuple(
        3 * (r % 4) + r // 4 for r in range(12)))


@pytest.mark.parametrize("dims", [(2, 2), (3, 2), (2, 3, 2), (4,)])
def test_group_orders_fold_into_the_pass(dims):
    """A pass that carries the groups' rank orders == the plain pass with
    the chunks moved to and from group-rank order by index."""
    x, _ = _pair(dims, 2, "int32", seed=5)
    rng = np.random.default_rng(6)
    d = len(dims)
    for ku in [None, *range(d)]:
        for kp in [None, *range(d)]:
            recv = None if ku is None else tuple(rng.permutation(dims[ku]))
            send = None if kp is None else tuple(rng.permutation(dims[kp]))
            y = x
            if ku is not None:
                y = y.reshape(dims[ku], -1)[torch.tensor(recv)] \
                    .reshape(x.shape)
                y = br.datatype_unpack_plain(y, dims=dims, k=ku)
            if kp is not None:
                y = br.datatype_pack_plain(y, dims=dims, k=kp)
                y = y.reshape(dims[kp], -1)[torch.argsort(torch.tensor(
                    send))].reshape(x.shape)
            rmap = br.row_map(dims, ku, kp, "paper", recv, send)
            assert torch.equal(x[torch.tensor(rmap)], y), (ku, kp)
            if ku is not None and kp is not None:
                assert torch.equal(br.datatype_repack(
                    x, dims=dims, k_unpack=ku, k_pack=kp, recv_order=recv,
                    send_order=send), y)
            elif kp is not None:
                assert torch.equal(ops.pack_round(x, dims, kp,
                                                  send_order=send), y)
            elif ku is not None:
                assert torch.equal(ops.unpack_round(x, dims, ku,
                                                    recv_order=recv), y)
    with pytest.raises(ValueError):
        br.row_map(dims, None, 0, "paper", None, (0,) * dims[0])


def test_nine_dims_round_trip():
    """The kernel has no limit on d (the map is built on the host)."""
    dims = (2,) * 9
    x = torch.arange(512 * 2, dtype=torch.int32).reshape(512, 2)
    for k in range(9):
        y = br.datatype_pack(x, dims=dims, k=k)
        assert torch.equal(br.datatype_unpack(y, dims=dims, k=k), x)


def test_repack_follows_the_device_and_plain_versions():
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    want = br.datatype_repack_plain(x, dims=(2, 3, 4), k_unpack=0,
                                    k_pack=2)
    assert torch.equal(ops.repack_round(x, (2, 3, 4), 0, 2), want)
    assert torch.equal(ops.repack_round(x, (2, 3, 4), 0, 2, impl="torch"),
                       want)
    assert br.datatype_repack.launches == 0
    with pytest.raises(ValueError):
        ops.repack_round(x, (2, 3, 4), 0, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        br.datatype_repack(torch.empty(6, 2, device="meta"), dims=(3, 2),
                           k_unpack=0, k_pack=1)


SCHEDULE_TORI = [(2, 2), (4,), (2, 3, 4), (4, 3, 3, 4)]


@pytest.mark.parametrize("variant", br.VARIANTS)
@pytest.mark.parametrize("dims", SCHEDULE_TORI)
def test_round_schedule(dims, variant):
    """Every round order: the pack of the first round, a fused pass
    between rounds, the unpack of the last, without the identity passes:
    the last dimension's pack and unpack.  d passes when that dimension
    runs first or last, d + 1 otherwise (none on a 1-D torus)."""
    d = len(dims)
    for order in itertools.permutations(range(d)):
        passes = round_schedule(dims, order, variant)
        bounds = list(zip((None,) + order, order + (None,)))
        want = [(ku, kp) for ku, kp in bounds
                if (ku, kp) not in ((None, d - 1), (d - 1, None))]
        if d == 1:
            want = []
        assert list(passes) == want, order
        assert len(passes) == (0 if d == 1 else d if d - 1 in (
            order[0], order[-1]) else d + 1)
        for ku, kp in bounds:
            assert br.is_identity(br.row_map(dims, ku, kp, variant)) == \
                ((ku, kp) not in passes)
    assert round_schedule(dims, None, variant) == \
        round_schedule(dims, tuple(range(d)), variant)


def test_round_schedule_checks():
    with pytest.raises(ValueError):
        round_schedule((2, 1, 2), (0, 1, 2))        # a trivial dim
    with pytest.raises(ValueError):
        round_schedule((2, 2), (0, 0))
