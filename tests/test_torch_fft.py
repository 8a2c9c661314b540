"""The port's pencil FFT (repro_torch.workloads.fft, the TransposePlan of
core.plan, TorusComm.transpose, the simulator's pencil oracles, the
transpose cost model and models.spectral.distributed_fft_causal_conv)
against the JAX package.

Without devices: the oracles and the cost model give the reference's
values; ``TransposePlan.describe()`` and ``PencilFFT.describe()`` give
the reference's dicts for dims-only comms (the 2-D slab, the 3-D and 4-D
pencils, the real pencil; the backends direct, factorized, tuned and
pipelined).  On gloo worlds of 4 ranks (2,2) and 12 ranks (2,3,2), one
spawn each per module (``tests/torch_fft.py``): every transpose is a pure
re-shard, bit for bit under every backend; a stage's inverse shares its
inner plan; a rebuild hits the registry; the FFT is within 1e-5
(complex64) or 1e-12 (complex128) of numpy's; the traced forward is
bit-equal to the untraced one with the span tree of its plans.  The
(2,3,2) world's transposes, forward FFT, round trip and distributed
convolution are held against the JAX package's, run on 12 forced host
devices in a subprocess.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_fft as cases
from repro.core import comm as jax_comm
from repro.core import plan as jax_plan
from repro.core import simulator as jax_sim
from repro.core import tuning as jax_tuning
from repro.core.cache import free_all as jax_free_all
from repro.workloads import pencil_fft as jax_pencil_fft
from repro_torch.core import cache, comm, plan, simulator, tuning
from repro_torch.workloads import pencil_fft
from torch_dist import run_world

PAPER_TORI = [(5, 4), (2, 3, 4)]


@pytest.fixture(autouse=True)
def _fresh_registries():
    def clear():
        for mod in (plan, jax_plan):
            mod.free_plans()
            mod._PLANS.stats.update(hits=0, misses=0, evictions=0)
        cache.free_all()
        jax_free_all()
        comm.free_comms()
        jax_comm.free_comms()
    clear()
    yield
    clear()


# ---------------------------------------------------------------------------
# the oracles and the cost model
# ---------------------------------------------------------------------------


def _oracle_cases():
    """The paper's tori with the split / concat cases of the reference's
    FFT acceptance script, each in its default and its reversed round
    order."""
    out = []
    for dims in PAPER_TORI:
        p = math.prod(dims)
        for pencil, s, c in (((2 * p, 3), 0, 1), ((3, p, 2), 1, 2)):
            for order in (None, tuple(reversed(range(len(dims))))):
                out.append((dims, pencil, s, c, order))
    return out


@pytest.mark.parametrize("dims,pencil,split,concat,order", _oracle_cases())
def test_pencil_oracles_match_reference(dims, pencil, split, concat, order):
    got, gvol = simulator.simulate_pencil_transpose(dims, pencil, split,
                                                    concat, order)
    want, wvol = jax_sim.simulate_pencil_transpose(dims, pencil, split,
                                                   concat, order)
    assert got == want
    assert gvol.__dict__ == wvol.__dict__
    p = math.prod(dims)
    for r in range(p):
        ref = simulator.pencil_transpose_reference(p, pencil, split, concat,
                                                   r)
        assert ref == jax_sim.pencil_transpose_reference(p, pencil, split,
                                                         concat, r)
        assert got[r] == ref
    assert simulator.check_correct_pencil_transpose(dims, pencil, split,
                                                    concat, order)
    assert jax_sim.check_correct_pencil_transpose(dims, pencil, split,
                                                  concat, order)


def test_pencil_oracle_refusals():
    for mod in (simulator, jax_sim):
        with pytest.raises(ValueError, match="differ"):
            mod.simulate_pencil_transpose((2, 2), (4, 4), 1, 1)
        with pytest.raises(ValueError, match="divisible"):
            mod.simulate_pencil_transpose((2, 3), (4, 5), 1, 0)


@pytest.mark.parametrize("dims,names", [((2, 2), ("data", "pod")),
                                        ((2, 3, 2), ("a", "b", "c")),
                                        ((4, 2), ("x", "pod"))])
def test_transpose_cost_model_matches_reference(dims, names):
    p = math.prod(dims)
    links = tuning.default_links(names)
    jlinks = jax_tuning.default_links(names)
    for pencil_bytes in (64.0 * p, 2.0**20 * p, 2.0**28):
        for kind in ("direct", "factorized"):
            assert tuning.predict_transpose(dims, links, pencil_bytes, p,
                                            kind) == \
                jax_tuning.predict_transpose(dims, jlinks, pencil_bytes, p,
                                             kind)
        for max_chunks in (1, 8):
            got = tuning.choose_transpose_algorithm(
                dims, links, pencil_bytes, max_chunks=max_chunks)
            want = jax_tuning.choose_transpose_algorithm(
                dims, jlinks, pencil_bytes, max_chunks=max_chunks)
            assert (got.kind, got.n_chunks, got.predicted_seconds) == \
                (want.kind, want.n_chunks, want.predicted_seconds)
    with pytest.raises(ValueError, match="transpose kind"):
        tuning.predict_transpose(dims, links, 1024.0, p, "ring")


# ---------------------------------------------------------------------------
# describe() and the registry, without devices
# ---------------------------------------------------------------------------

BACKENDS = ({"backend": "direct"}, {"backend": "factorized"},
            {"backend": "tuned"}, {"backend": "pipelined", "n_chunks": 2})


@pytest.mark.parametrize("kw", BACKENDS, ids=lambda kw: kw["backend"])
@pytest.mark.parametrize("dims,names,shape,split,concat,dtype", [
    ((2, 2), ("data", "pod"), (128, 512, 512), 1, 0, "complex64"),
    ((2, 3, 2), ("a", "b", "c"), (2, 12, 24), 2, 1, "complex128"),
    ((2, 3, 2), ("a", "b", "c"), (24, 3), 0, 1, "float32"),
])
def test_transpose_describe_matches_reference(kw, dims, names, shape, split,
                                              concat, dtype):
    got = comm.torus_comm(dims, names).transpose(
        shape, dtype, split_axis=split, concat_axis=concat, **kw)
    want = jax_comm.torus_comm(dims, names).transpose(
        shape, dtype, split_axis=split, concat_axis=concat, **kw)
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    assert got.kind == "transpose" and got.out_shape == want.out_shape
    assert got.specs() == tuple(_spec(sp) for sp in want.specs())
    # through plan_transpose, the same cached object
    again = plan.plan_transpose(dims, names, shape, dtype, split_axis=split,
                                concat_axis=concat, **kw)
    assert again is got and again.describe()["cache"] == "hit"
    # the inverse stage shares the inner dense plan
    inv = comm.torus_comm(dims, names).transpose(
        got.out_shape, dtype, split_axis=concat, concat_axis=split, **kw)
    assert inv.inner is got.inner


def test_transpose_sub_comm_and_eviction():
    c = comm.torus_comm((2, 3, 2), ("a", "b", "c"))
    jc = jax_comm.torus_comm((2, 3, 2), ("a", "b", "c"))
    got = c.sub(("a", "b")).transpose((4, 12), "complex64", split_axis=1,
                                      concat_axis=0, backend="factorized")
    want = jc.sub(("a", "b")).transpose((4, 12), "complex64", split_axis=1,
                                        concat_axis=0, backend="factorized")
    assert got.describe() == want.describe()
    assert got.describe()["parent"] == ["a", "b", "c"]
    assert plan.plan_cache_stats()["size"] == 2      # transpose + inner
    plan._drop_plan(got._registry_key)
    assert got.inner._registry_key not in plan._PLANS
    assert plan.plan_cache_stats()["size"] == 0
    for bad, match in (((4, 12), "differ"), ((4, 10), "divisible")):
        with pytest.raises(ValueError, match=match):
            c.transpose(bad, "complex64", split_axis=1,
                        concat_axis=1 if match == "differ" else 0)


FFT_CASES = [
    ("slab2d", (2, 2), ("data", "pod"), (16, 12), {}),
    ("pencil3d", (2, 2), ("data", "pod"), (512, 512, 512), {}),
    ("real", (2, 2), ("data", "pod"), (512, 512, 510), {"real": True}),
    ("slab3d", (2, 3, 2), ("a", "b", "c"), (12, 24, 4), {}),
    ("pencil4d", (2, 3, 2), ("a", "b", "c"), (4, 6, 6, 4), {}),
    ("real_grid", (2, 3, 2), ("a", "b", "c"), (12, 12, 10),
     {"real": True, "grid": (("a", "b"), ("c",)), "axes": (0, 2)}),
]


def _spec(pspec) -> tuple:
    """A ``PartitionSpec`` as the port states it: per array axis a tuple
    of torus axis names or None (JAX keeps a one-name entry bare)."""
    return tuple((s,) if isinstance(s, str) else None if s is None
                 else tuple(s) for s in pspec)


@pytest.mark.parametrize("kw", BACKENDS, ids=lambda kw: kw["backend"])
@pytest.mark.parametrize("case", FFT_CASES, ids=lambda c: c[0])
def test_pencil_fft_describe_matches_reference(case, kw):
    _, dims, names, shape, fkw = case
    got = pencil_fft(comm.torus_comm(dims, names), shape, **fkw, **kw)
    want = jax_pencil_fft(jax_comm.torus_comm(dims, names), shape, **fkw,
                          **kw)
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    assert got.in_spec == _spec(want.in_spec)
    assert got.out_spec == _spec(want.out_spec)
    size = plan.plan_cache_stats()["size"]
    again = pencil_fft(comm.torus_comm(dims, names), shape, **fkw, **kw)
    assert all(a is b for a, b in zip(again.plans, got.plans))
    assert plan.plan_cache_stats()["size"] == size
    with pytest.raises(ValueError, match="dims-only"):
        got.in_index()


def test_pencil_fft_refusals():
    c = comm.torus_comm((2, 2), ("data", "pod"))
    for kw, match in (({"global_shape": (8,)}, "rank >= 2"),
                      ({"global_shape": (8, 8), "axes": (0, 0)},
                       "duplicate"),
                      ({"global_shape": (8, 8), "grid": (("data",),)},
                       "partition"),
                      ({"global_shape": (8, 8), "real": True,
                        "axes": (0,)}, "rfft axis"),
                      ({"global_shape": (8, 8), "dtype": "int32"},
                       "unsupported"),
                      ({"global_shape": (6, 8)}, "divisible")):
        with pytest.raises(ValueError, match=match):
            pencil_fft(c, **kw)


# ---------------------------------------------------------------------------
# gloo worlds
# ---------------------------------------------------------------------------

_RESULTS: dict = {}


def _results(n, tmp_path_factory):
    if n not in _RESULTS:
        _RESULTS[n] = run_world(cases.world_checks, n,
                                tmp_path_factory.mktemp("fft"),
                                *cases.WORLDS[n])
    return _RESULTS[n]


@pytest.fixture(scope="module", params=sorted(cases.WORLDS))
def world(request, tmp_path_factory):
    return request.param, _results(request.param, tmp_path_factory)


@pytest.mark.parametrize("check", cases.CHECKS)
def test_fft_on_gloo(world, check):
    n, results = world
    failed = [r for r, res in enumerate(results) if not res["ok"][check]]
    assert not failed, f"{check} wrong on ranks {failed} of the " \
        f"{cases.WORLDS[n][0]} torus"


def test_distributed_conv_on_gloo(tmp_path_factory):
    from repro_torch.models.spectral import fft_causal_conv
    import torch
    for n in sorted(cases.WORLDS):
        rows = [r["outs"]["conv"]
                for r in _results(n, tmp_path_factory)]
        # ranks past p/2 hold no row
        assert all(r.shape[1] == 0 for r in rows[n // 2:])
        x, k = cases.conv_inputs(*cases.CONV[n])
        want = fft_causal_conv(torch.from_numpy(x),
                               torch.from_numpy(k)).numpy()
        np.testing.assert_allclose(np.concatenate(rows, axis=1), want,
                                   rtol=0, atol=1e-3)


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)      # the complex128 cases
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.cache import cart_create
from repro.core.comm import torus_comm
from repro.models.spectral import distributed_fft_causal_conv
from repro.workloads import pencil_fft

sys.path.insert(0, sys.argv[2])
import torch_fft as cases

n = 12
dims, names = cases.WORLDS[n]
mesh = cart_create(jax.devices()[:n], dims, names)
comm = torus_comm(mesh, names)
out = {}
for name, (shape, kw) in cases.CASES[n].items():
    real = kw.get("real", False)
    for cdtype in cases.CDTYPES:
        dtype = cases.REAL_OF[cdtype] if real else cdtype
        fft = pencil_fft(comm, shape, dtype=dtype, backend="factorized",
                         **kw)
        G = cases.work_array(name, shape, cdtype, real)

        def chain(xl):
            ys = []
            for k in range(fft.g - 1, -1, -1):
                xl = fft.plans[k].apply(xl)
                ys.append(xl)
            return tuple(ys)

        specs = [P(*[fft._gspecs[d[a]] if a in d else None
                     for a in range(fft.m)])
                 for d in cases.stage_dists(fft.g)]
        ys = jax.jit(jax.shard_map(chain, mesh=mesh, in_specs=specs[0],
                                   out_specs=tuple(specs[1:]),
                                   check_vma=False))(
            jax.device_put(G, NamedSharding(mesh, specs[0])))
        for i, y in enumerate(ys):
            out[f"{name}_{cdtype}_stage{i}"] = np.asarray(y)
        g_in = cases.global_input(name, shape, cdtype, real)
        x = jax.device_put(jnp.asarray(g_in),
                           NamedSharding(mesh, fft.in_spec))
        y = fft.forward_fn()(x)
        out[f"{name}_{cdtype}_forward"] = np.asarray(y)
        out[f"{name}_{cdtype}_roundtrip"] = np.asarray(fft.inverse_fn()(y))
x, k = cases.conv_inputs(*cases.CONV[n])
out["conv"] = np.asarray(distributed_fft_causal_conv(comm, jnp.asarray(x),
                                                     jnp.asarray(k)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fft_jax")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "out.npz"),
         str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _sliced(a, index):
    return a[cases.as_slices(index)]


@pytest.mark.parametrize("cdtype", cases.CDTYPES)
@pytest.mark.parametrize("name", sorted(cases.CASES[12]))
def test_against_jax_on_12_devices(name, cdtype, jax_outputs,
                                   tmp_path_factory):
    results = _results(12, tmp_path_factory)
    for rank, res in enumerate(results):
        o = res["outs"][(name, cdtype)]
        # transposes bit for bit, stage after stage
        for i, (got, index) in enumerate(zip(o["stages"],
                                             o["stage_index"])):
            want = _sliced(jax_outputs[f"{name}_{cdtype}_stage{i}"], index)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        # the forward FFT within the reference's own bound against numpy
        fwd = jax_outputs[f"{name}_{cdtype}_forward"]
        gap = np.abs(o["forward"] - _sliced(fwd, o["out_index"])).max()
        assert gap <= cases.TOL[cdtype] * np.abs(fwd).max(), (rank, gap)
        # the round trip
        shape, kw = cases.CASES[12][name]
        g_in = cases.global_input(name, shape, cdtype, kw.get("real", False))
        want = _sliced(g_in, o["in_index"])
        assert o["roundtrip"].dtype == want.dtype
        assert np.abs(o["roundtrip"] - want).max() \
            <= 1e-5 * np.abs(g_in).max()
        ref_back = _sliced(jax_outputs[f"{name}_{cdtype}_roundtrip"],
                           o["in_index"])
        assert np.abs(o["roundtrip"] - ref_back).max() \
            <= 1e-5 * np.abs(g_in).max()


def test_distributed_conv_against_jax(jax_outputs, tmp_path_factory):
    from repro_torch.models.spectral import fft_causal_conv
    import torch
    rows = [r["outs"]["conv"] for r in _results(12, tmp_path_factory)]
    got = np.concatenate(rows, axis=1)
    want = jax_outputs["conv"]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() < 1e-3
    x, k = cases.conv_inputs(*cases.CONV[12])
    local = fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k))
    assert np.abs(got - local.numpy()).max() < 1e-3
