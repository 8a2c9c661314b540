"""The port's ragged and sparse Alltoallv (repro_torch.core.ragged,
core.sparse, the RaggedA2APlan / SparseA2APlan of core.plan and the
simulator's Alltoallv oracles) against the JAX package.

Host-side functions (message masks, traffic stats, the exact paths, the
oracles) must return the reference's values on seeded count matrices
with zero rows; plan resolution must give the reference's ``describe()``
and registry behaviour.  The bucketed ``forward`` / ``reverse`` run on
gloo worlds of 4 and 6 ranks (one world per torus, spawned once per
module) on seeded counts with zeros and whole empty lanes: the rows each
rank counts must carry the oracle's element tags and equal the JAX
package's plans, run inside ``shard_map`` on 6 forced host devices in a
subprocess; ``recv_counts`` must be equal.  Rows beyond a count are
unspecified for the sparse plan and are not compared.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import comm as jax_comm
from repro.core import plan as jax_plan
from repro.core import ragged as jax_ragged
from repro.core import simulator as jax_sim
from repro.core import sparse as jax_sparse
from repro.core.cache import free_all as jax_free_all
from repro_torch.core import cache, comm, plan, ragged, simulator, sparse
from torch_dist import run_world

WORLDS = {4: ((2, 2), ("a", "b")), 6: ((2, 3), ("a", "b"))}
MAX_COUNT = 5                  # bucket 8: every window is padded
ROW = (2,)
RAGGED_BACKENDS = ("factorized", "overlap", "direct", "tuned")
CHECKS = ("ragged_rows", "ragged_counts", "ragged_reverse", "sparse_rows",
          "sparse_counts", "sparse_reverse", "lanes_skipped",
          "occupancy", "counts_matrix")
HOST_DIMS = [((2, 2), None), ((2, 3), (1, 0)), ((3, 4), None),
             ((2, 3, 2), (2, 0, 1)), ((4,), None)]


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
        plan.set_plan_cache_capacity(256)
        jax_plan.set_plan_cache_capacity(256)
    clear()
    yield
    clear()


def _counts(p: int, seed: int, density: float) -> np.ndarray:
    """Seeded (p, p) send counts in 1..MAX_COUNT at ``density``, with
    rank 1's row zero (it sends nothing)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(1, MAX_COUNT + 1, (p, p)) * (rng.random((p, p))
                                                  < density)
    c[1] = 0
    return c.astype(np.int32)


def _payload(counts, m: int) -> np.ndarray:
    """x[s, t, :counts[s, t]] carries the tag of (s, t, j); the rest 0."""
    p = counts.shape[0]
    x = np.zeros((p, p, m) + ROW, np.float32)
    for s in range(p):
        for t in range(p):
            for j in range(int(counts[s, t])):
                x[s, t, j] = (s * p + t) * 64 + j + 1
    return x


# ---------------------------------------------------------------------------
# host-side functions and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,order", HOST_DIMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_host_paths_match_reference(dims, order, seed):
    p = math.prod(dims)
    counts = _counts(p, seed, density=0.4)
    rng = np.random.default_rng(seed + 7)
    rows = [[rng.standard_normal((int(counts[s, t]), 3)).astype(np.float32)
             for t in range(p)] for s in range(p)]
    for mine, ref in ((ragged.exact_alltoallv, jax_ragged.exact_alltoallv),
                      (lambda *a: sparse.sparse_exact_alltoallv(*a)[:2],
                       lambda *a: jax_sparse.sparse_exact_alltoallv(*a)[:2])):
        recv, cm = mine(rows, dims, order)
        jrecv, jcm = ref(rows, dims, order)
        assert cm == jcm == counts.tolist()
        for r in range(p):
            for s in range(p):
                np.testing.assert_array_equal(recv[r][s], jrecv[r][s])
                np.testing.assert_array_equal(recv[r][s], rows[s][r])
    *_, vol = sparse.sparse_exact_alltoallv(rows, dims, order)
    *_, jvol = jax_sparse.sparse_exact_alltoallv(rows, dims, order)
    assert vol.__dict__ == jvol.__dict__
    for k in range(len(dims)):
        assert ragged.exact_round_message_elements(dims, counts, k) == \
            jax_ragged.exact_round_message_elements(dims, counts, k)
    assert sparse.sparse_traffic_stats(dims, counts, order) == \
        jax_sparse.sparse_traffic_stats(dims, counts, order)
    active = tuple(s for s in dims if s > 1)
    act_order = None if order is None else tuple(order)
    for m, jm in zip(sparse.round_message_masks(active, act_order),
                     jax_sparse.round_message_masks(active, act_order)):
        np.testing.assert_array_equal(m, jm)
    for name in ("simulate_factorized_alltoallv",
                 "simulate_sparse_alltoallv"):
        got, gv = getattr(simulator, name)(dims, counts.tolist(), order)
        want, wv = getattr(jax_sim, name)(dims, counts.tolist(), order)
        assert got == want and gv.__dict__ == wv.__dict__
    assert simulator.simulate_direct_alltoallv(counts.tolist()) == \
        jax_sim.simulate_direct_alltoallv(counts.tolist())
    assert simulator.check_correct_alltoallv(dims, counts, order)
    assert simulator.check_correct_sparse_alltoallv(dims, counts, order)
    vol = simulator.simulate_factorized_alltoallv(dims, counts, order)[1]
    assert vol.occupancy(8) == jax_sim.simulate_factorized_alltoallv(
        dims, counts, order)[1].occupancy(8)


def test_small_helpers_match_reference():
    for n in (1, 2, 3, 17, 1024, 1025):
        assert ragged.next_pow2(n) == jax_ragged.next_pow2(n)
    with pytest.raises(ValueError):
        ragged.next_pow2(0)
    import torch
    c = np.array([3, 0, 5, 1], np.int32)
    assert float(ragged.bucket_occupancy(torch.from_numpy(c), 8)) == \
        pytest.approx(float(jax_ragged.bucket_occupancy(c, 8)))
    with pytest.raises(ValueError, match="active"):
        sparse.round_message_masks((2, 1))
    with pytest.raises(ValueError, match="counts"):
        simulator.simulate_direct_alltoallv([[1, -1], [0, 0]])


# ---------------------------------------------------------------------------
# plan resolution, describe() and the registry
# ---------------------------------------------------------------------------

RAGGED_CASES = [dict(backend="tuned"), dict(backend="factorized"),
                dict(backend="overlap", n_chunks=3),
                dict(backend="direct", avg_count=2.5),
                dict(backend="tuned", round_order=(1, 0), max_chunks=1)]


@pytest.mark.parametrize("case", range(len(RAGGED_CASES)))
@pytest.mark.parametrize("dims,names,row,dtype,max_count", [
    ((2, 2), ("data", "pod"), (4096,), "bfloat16", 2048),
    ((2, 3), ("i", "j"), (4,), "float32", 5),
])
def test_ragged_describe_matches_reference(case, dims, names, row, dtype,
                                           max_count):
    kw = RAGGED_CASES[case]
    got = plan.plan_ragged_all_to_all(dims, names, row, dtype,
                                      max_count=max_count, **kw)
    want = jax_plan.plan_ragged_all_to_all(dims, names, row, dtype,
                                           max_count=max_count, **kw)
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    assert plan.plan_ragged_all_to_all(dims, names, row, dtype,
                                       max_count=max_count, **kw) is got
    assert got.describe()["cache"] == "hit"


@pytest.mark.parametrize("density", [None, 0.05, 0.5])
@pytest.mark.parametrize("dims,names,order", [
    ((2, 2), ("data", "pod"), None), ((2, 3), ("i", "j"), (1, 0)),
    ((3, 1, 2), ("i", "j", "k"), None)])
def test_sparse_describe_matches_reference(density, dims, names, order):
    kw = dict(max_count=5, avg_count=2.0, density=density,
              round_order=order)
    got = plan.plan_sparse_all_to_all(dims, names, (4,), "float32", **kw)
    want = jax_plan.plan_sparse_all_to_all(dims, names, (4,), "float32",
                                           **kw)
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    counts = _counts(math.prod(dims), 3, 0.3)
    assert got.analyze(counts) == want.analyze(counts)
    assert got.describe() == want.describe()


def test_dropless_choice_matches_reference():
    """The density-aware ragged-vs-sparse choice, priced by both
    packages' tuning."""
    from repro.core import tuning as jax_tuning
    from repro_torch.core import tuning
    for dims, names in (((2, 2), ("data", "pod")), ((4, 2), ("i", "j"))):
        for density in (1e-3, 0.05, 0.3, 1.0):
            for row_bytes, bucket in ((8192.0, 2048), (16.0, 8)):
                got = tuning.choose_ragged_algorithm(
                    dims, tuning.default_links(names), row_bytes, bucket,
                    max_chunks=4, density=density)
                want = jax_tuning.choose_ragged_algorithm(
                    dims, jax_tuning.default_links(names), row_bytes,
                    bucket, max_chunks=4, density=density)
                assert (got.kind, got.n_chunks, got.predicted_seconds) == \
                    (want.kind, want.n_chunks, want.predicted_seconds)


def test_evicting_ragged_plan_drops_nested_entries():
    r = plan.plan_ragged_all_to_all((2, 3), ("i", "j"), (4,), "float32",
                                    max_count=5)
    assert plan.plan_cache_stats()["size"] == 3   # ragged + data + counts
    plan._PLANS.get(r.data._registry_key)
    plan._PLANS.get(r.counts_plan._registry_key)
    plan.set_plan_cache_capacity(3)
    plan.plan_all_to_all((5,), ("z",), (4,), "float32", backend="direct")
    for p_ in (r, r.data, r.counts_plan):
        assert p_._registry_key not in plan._PLANS
    assert plan.plan_cache_stats()["size"] == 1


def test_shared_counts_plan_survives_sibling_eviction():
    a = plan.plan_ragged_all_to_all((2, 3), ("i", "j"), (4,), "float32",
                                    max_count=5)
    b = plan.plan_ragged_all_to_all((2, 3), ("i", "j"), (4,), "float32",
                                    max_count=9)
    s = plan.plan_sparse_all_to_all((2, 3), ("i", "j"), (4,), "float32",
                                    max_count=5)
    assert a.counts_plan is b.counts_plan is s.counts_plan
    plan._drop_plan(a._registry_key)
    assert a.data._registry_key not in plan._PLANS
    for p_ in (b, b.data, b.counts_plan, s):
        assert p_._registry_key in plan._PLANS
    c = comm.torus_comm((2, 3), ("i", "j"))
    c.ragged_all_to_all((4,), "float32", max_count=3)
    c.sparse_all_to_all((4,), "float32", max_count=3)
    live = plan.plan_cache_stats()["size"]
    c.free()
    assert plan.plan_cache_stats()["size"] < live


def test_refusals_and_validation(monkeypatch, tmp_path):
    import torch
    from repro.core import plan as jax_plan
    with pytest.raises(ValueError, match="avg_count"):
        plan.plan_ragged_all_to_all((2, 2), ("i", "j"), max_count=4,
                                    avg_count=9)
    with pytest.raises(ValueError, match="density"):
        plan.plan_sparse_all_to_all((2, 2), ("i", "j"), max_count=4,
                                    density=1.5)
    # "autotune" resolves the data plan as the reference does on the same
    # (here empty) tuning DB, and runs like every backend
    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "t.json"))
    auto = plan.plan_ragged_all_to_all((2, 2), ("i", "j"), (4,),
                                       "float32", max_count=4,
                                       backend="autotune")
    ref = jax_plan.plan_ragged_all_to_all((2, 2), ("i", "j"), (4,),
                                          "float32", max_count=4,
                                          backend="autotune")
    assert auto.data.tuned_from == "model"
    assert auto.describe() == ref.describe()
    x = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="DeviceMesh"):
        auto.data.forward(x.reshape(4, -1))
    with pytest.raises(ValueError, match="DeviceMesh"):
        plan.plan_ragged_all_to_all((2, 2), ("i", "j"), (4,), "float32",
                                    max_count=4, backend="factorized"
                                    ).forward(x, torch.zeros(4))


# ---------------------------------------------------------------------------
# the bucketed paths on gloo worlds
# ---------------------------------------------------------------------------


def _counted_rows_ok(recv, recv_counts, counts, rank, p):
    """Every counted row of every window carries the oracle's tag, and
    ``recv_counts`` is the count matrix's column."""
    oracle = simulator.simulate_direct_alltoallv(counts.tolist())[rank]
    ok = np.array_equal(recv_counts, counts[:, rank])
    for s in range(p):
        for j, (es, er, ej) in enumerate(oracle[s]):
            ok &= bool(np.all(recv[s, j] == (es * p + er) * 64 + ej + 1))
    return ok


def _world_checks(rank, n, dims, names, seed, density):
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm

    p = math.prod(dims)
    counts = _counts(p, seed, density)
    X = torch.from_numpy(_payload(counts, MAX_COUNT))
    x, c = X[rank].clone(), torch.from_numpy(counts[rank].copy())
    mesh = cart_create(n, dims, names, device_type="cpu")
    ok = {k: True for k in CHECKS}
    outs = {}
    for variant in ("natural", "paper"):
        tc = torus_comm(mesh, names, variant=variant)
        for backend in RAGGED_BACKENDS:
            rp = tc.ragged_all_to_all(ROW, "float32", max_count=MAX_COUNT,
                                      backend=backend, n_chunks=2)
            recv, rc = rp.forward(x, c)
            ok["ragged_rows"] &= _counted_rows_ok(
                recv.numpy(), rc.numpy(), counts, rank, p)
            ok["ragged_counts"] &= rc.dtype == torch.int32 and \
                torch.equal(rc, torch.from_numpy(counts[:, rank]))
            back, brc = rp.reverse(x, c)
            ok["ragged_reverse"] &= torch.equal(back, recv) and \
                torch.equal(brc, rc)
            ok["counts_matrix"] &= torch.equal(
                rp.counts_matrix(c), torch.from_numpy(counts))
            ok["occupancy"] &= math.isclose(
                float(rp.occupancy(c)), counts[rank].sum() / (p * rp.bucket),
                rel_tol=1e-6)
            outs[("ragged", variant, backend)] = (recv.numpy(), rc.numpy())
        sp = tc.sparse_all_to_all(ROW, "float32", max_count=MAX_COUNT,
                                  density=density)
        recv, rc = sp.forward(x, c)
        ok["sparse_rows"] &= _counted_rows_ok(recv.numpy(), rc.numpy(),
                                              counts, rank, p)
        ok["sparse_counts"] &= torch.equal(
            rc, torch.from_numpy(counts[:, rank]))
        back, brc = sp.reverse(x, c)
        ok["sparse_reverse"] &= _counted_rows_ok(
            back.numpy(), brc.numpy(), counts, rank, p)
        # the seeded counts leave some lanes of each direction empty
        for reverse in (False, True):
            masks = sp.lane_masks(reverse, torch.device("cpu"))
            lanes = ((torch.from_numpy(counts) > 0) & masks).flatten(1) \
                .any(1)
            ok["lanes_skipped"] &= 0 < int(lanes.sum()) < lanes.numel()
        outs[("sparse", variant, "sparse")] = (recv.numpy(), rc.numpy())
    return {k: bool(v) for k, v in ok.items()}, outs


SEED = {4: (8, 0.25), 6: (7, 0.1)}      # (seed, density) of the counts
_RESULTS: dict = {}


def _results(n, tmp_path_factory):
    if n not in _RESULTS:
        _RESULTS[n] = run_world(_world_checks, n,
                                tmp_path_factory.mktemp("ragged"),
                                *WORLDS[n], *SEED[n])
    return _RESULTS[n]


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    return request.param, _results(request.param, tmp_path_factory)


@pytest.mark.parametrize("check", CHECKS)
def test_ragged_on_gloo(world, check):
    n, results = world
    failed = [r for r, (ok, _) in enumerate(results) if not ok[check]]
    assert not failed, f"{check} wrong on ranks {failed} of the " \
        f"{WORLDS[n][0]} torus"


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.core.cache import cart_create
from repro.core.comm import torus_comm

data = np.load(sys.argv[1])
max_count, row, densities = eval(sys.argv[2])
out = {}
for n, dims, names in eval(sys.argv[3]):
    X, C = data[f"X{n}"], data[f"C{n}"]
    mesh = cart_create(jax.devices()[:n], dims, names)
    spec = P(tuple(reversed(names)))
    for variant in ("natural", "paper"):
        tc = torus_comm(mesh, names, variant=variant)
        plans = {("ragged", b): tc.ragged_all_to_all(
                     row, "float32", max_count=max_count, backend=b,
                     n_chunks=2)
                 for b in ("factorized", "overlap", "direct", "tuned")}
        plans[("sparse", "sparse")] = tc.sparse_all_to_all(
            row, "float32", max_count=max_count, density=densities[n])
        for (kind, b), plan in plans.items():
            def local(x, c):
                recv, rc = plan.forward(x[0], c[0])
                return recv[None], rc[None]
            recv, rc = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(spec, spec),
                out_specs=(spec, spec), check_vma=False))(X, C)
            out[f"{n}_{kind}_{variant}_{b}_recv"] = np.asarray(recv)
            out[f"{n}_{kind}_{variant}_{b}_rc"] = np.asarray(rc)
np.savez(sys.argv[4], **out)
"""


def test_bucketed_paths_match_jax(tmp_path, tmp_path_factory):
    arrays = {}
    for n in WORLDS:
        p = math.prod(WORLDS[n][0])
        counts = _counts(p, *SEED[n])
        arrays[f"X{n}"] = _payload(counts, MAX_COUNT)
        arrays[f"C{n}"] = counts
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    worlds = [(n, dims, names) for n, (dims, names) in WORLDS.items()]
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp_path / "in.npz"),
         repr((MAX_COUNT, ROW, {n: d for n, (_, d) in SEED.items()})),
         repr(worlds),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_out = np.load(tmp_path / "out.npz")
    for n in WORLDS:
        counts = arrays[f"C{n}"]
        for rank, (_, outs) in enumerate(_results(n, tmp_path_factory)):
            for (kind, variant, b), (recv, rc) in outs.items():
                key = f"{n}_{kind}_{variant}_{b}"
                jrecv = jax_out[f"{key}_recv"][rank]
                np.testing.assert_array_equal(rc, jax_out[f"{key}_rc"][rank])
                for s in range(len(counts)):
                    k = int(counts[s, rank])
                    np.testing.assert_array_equal(
                        recv[s, :k], jrecv[s, :k],
                        err_msg=f"{key} rank {rank} from {s}")
