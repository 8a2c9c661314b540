"""The port's collective core without a world (repro_torch.core: dims,
simulator, tuning, plan resolution, the registries) against the JAX
package.

Resolution is pure tuning code copied from the reference, so every
decision and every ``describe()`` dict must equal the reference's.  The
multi-rank execution of the same plans runs on gloo worlds in
test_torch_collective.py.
"""

import json
import math

import pytest
import torch

from repro.core import comm as jax_comm
from repro.core import dims as jax_dims
from repro.core import plan as jax_plan
from repro.core import simulator as jax_sim
from repro.core import tuning as jax_tuning
from repro.core.cache import free_all as jax_free_all
from repro_torch.core import cache, comm, dims, plan, simulator, tuning
from repro_torch.core.plan import free_plans, plan_all_to_all, \
    plan_cache_stats, set_plan_cache_capacity
from repro_torch.core.tuning import DCN, ICI


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both packages' registries empty, at default capacity, before and
    after each test."""
    def clear():
        for mod in (plan, jax_plan):
            mod.free_plans()
            mod._PLANS.stats.update(hits=0, misses=0, evictions=0)
        cache.free_all()
        jax_free_all()
        comm.free_comms()
        jax_comm.free_comms()
    clear()
    cap = plan._PLANS.capacity
    yield
    set_plan_cache_capacity(cap)
    clear()


# ---------------------------------------------------------------------------
# dims, simulator, tuning: copies of stdlib modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_dims_create_matches_reference(d):
    for p in range(1, 1153):
        assert dims.dims_create(p, d) == jax_dims.dims_create(p, d)
    assert dims.dims_create(1152, 2) == (36, 32)


def test_dims_helpers_match_reference():
    for n in (1, 2, 12, 97, 360, 1152):
        assert dims.divisors(n) == jax_dims.divisors(n)
        assert dims.max_dims(n) == jax_dims.max_dims(n)
        assert dims.prime_factorization(n) == jax_dims.prime_factorization(n)


@pytest.mark.parametrize("shape", [(5, 4), (2, 3, 4), (4, 3, 3, 4)])
def test_simulator_matches_reference(shape):
    orders = [None, tuple(reversed(range(len(shape))))]
    for order in orders:
        assert simulator.check_correct(shape, order)
        assert simulator.check_correct(shape, order) == \
            jax_sim.check_correct(shape, order)
        got, vol = simulator.simulate_factorized_alltoall(shape, order)
        want, jvol = jax_sim.simulate_factorized_alltoall(shape, order)
        assert got == want
        assert vol.blocks_sent_per_round == jvol.blocks_sent_per_round
        assert vol.total_blocks_sent == vol.theorem1_formula == \
            jvol.theorem1_formula
    p = math.prod(shape)
    assert simulator.simulate_direct_alltoall(p) == \
        jax_sim.simulate_direct_alltoall(p)
    for k in range(len(shape)):
        assert simulator.round_datatype(shape, k) == \
            jax_sim.round_datatype(shape, k)
        assert simulator.example_index_table(shape, k) == \
            jax_sim.example_index_table(shape, k)
        if shape in simulator.PAPER_EXAMPLES:
            assert simulator.example_index_table(shape, k) == \
                simulator.PAPER_EXAMPLES[shape][k]
    for r in range(p):
        c = simulator.rank_to_coords(r, shape)
        assert c == jax_sim.rank_to_coords(r, shape)
        assert simulator.coords_to_rank(c, shape) == r


GRID_DIMS = [(2, 2), (4, 2), (16, 4), (5, 4), (2, 3, 4), (2, 3, 2),
             (4, 3, 3, 4), (36, 32), (1, 4, 4)]
GRID_BYTES = [4.0, 1024.0, float(1 << 16), float(1 << 20), float(1 << 24)]


@pytest.mark.parametrize("shape", GRID_DIMS)
def test_choose_algorithm_matches_reference(shape):
    for links in ((ICI,) * len(shape), tuning.default_links(
            ("data", "pod", "x", "y")[:len(shape)])):
        jlinks = tuple(jax_tuning.LinkModel(l.alpha, l.bandwidth)
                       for l in links)
        for b in GRID_BYTES:
            for max_chunks in (1, 4, 8):
                got = tuning.choose_algorithm(shape, links, b,
                                              max_chunks=max_chunks)
                want = jax_tuning.choose_algorithm(shape, jlinks, b,
                                                   max_chunks=max_chunks)
                assert (got.kind, got.dims, got.n_chunks,
                        got.predicted_seconds) == \
                    (want.kind, want.dims, want.n_chunks,
                     want.predicted_seconds)
            for kind in ("allgather", "reduce_scatter"):
                got = tuning.choose_dimwise_algorithm(kind, shape, links, b)
                want = jax_tuning.choose_dimwise_algorithm(kind, shape,
                                                           jlinks, b)
                assert (got.kind, got.predicted_seconds) == \
                    (want.kind, want.predicted_seconds)
        assert tuning.crossover_block_bytes(shape, links) == \
            jax_tuning.crossover_block_bytes(shape, jlinks)
    p = math.prod(shape)
    assert tuning.candidate_factorizations(p) == \
        jax_tuning.candidate_factorizations(p)


def test_tuning_helpers_match_reference():
    from repro.core.ragged import next_pow2
    for n in (1, 2, 3, 17, 1024, 1025):
        assert tuning.next_pow2(n) == next_pow2(n)
    s = tuning.choose_serving_split((4, 2), None, row_bytes=4096.0,
                                    max_count=100)
    js = jax_tuning.choose_serving_split((4, 2), None, row_bytes=4096.0,
                                         max_count=100)
    assert s.n_prefill == js.n_prefill
    assert s.predicted_seconds == js.predicted_seconds


# ---------------------------------------------------------------------------
# plan resolution and describe()
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(backend="tuned"),
    dict(backend="tuned", max_chunks=1),
    dict(backend="direct"),
    dict(backend="factorized", variant="paper", round_order=(1, 0)),
    dict(backend="pipelined", n_chunks=3),
    dict(backend="overlap"),
    dict(backend="factorized", reverse_round_order=(0, 1)),
    dict(backend="tuned", links=(ICI, DCN), compute_seconds=1e-4),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
@pytest.mark.parametrize("shape,names,block,dtype", [
    ((4, 2), ("data", "pod"), (4, 64, 4096), "bfloat16"),
    ((2, 2), ("i", "j"), (8,), "float32"),
    ((3, 2), ("a", "b"), (1 << 16,), "int32"),
])
def test_describe_matches_reference(case, shape, names, block, dtype):
    kw = dict(PLAN_CASES[case])
    if "links" in kw:
        jkw = dict(kw, links=tuple(jax_tuning.LinkModel(l.alpha,
                                                        l.bandwidth)
                                   for l in kw["links"]))
    else:
        jkw = kw
    got = plan_all_to_all(shape, names, block, getattr(torch, dtype), **kw)
    want = jax_plan.plan_all_to_all(shape, names, block, dtype, **jkw)
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    # a second fetch is a hit on both sides
    assert plan_all_to_all(shape, names, block, dtype, **kw) is got
    assert got.describe() == jax_plan.plan_all_to_all(
        shape, names, block, dtype, **jkw).describe()


def test_describe_golden():
    """tests/test_core_plan.py's golden, on the port."""
    p = plan_all_to_all((4, 2), ("i", "j"), (16, 8), "bfloat16",
                        backend="overlap", variant="paper",
                        round_order=(1, 0), n_chunks=3, links=(ICI, DCN))
    d = p.describe()
    pred = d.pop("predicted_seconds")
    assert pred > 0
    assert d == {
        "kind": "dense",
        "axis_names": ["i", "j"],
        "dims": [4, 2],
        "p": 8,
        "d": 2,
        "backend": "overlap",
        "requested_backend": "overlap",
        "variant": "paper",
        "round_order": [1, 0],
        "reverse_round_order": [0, 1],
        "n_chunks": 3,
        "block_shape": [16, 8],
        "dtype": "bfloat16",
        "block_bytes": 256,
        "blocks_sent_per_device": 2 * 8 - (2 + 4),   # Theorem 1
        "links": [{"alpha": ICI.alpha, "bandwidth": ICI.bandwidth},
                  {"alpha": DCN.alpha, "bandwidth": DCN.bandwidth}],
        "tuned_from": None,
        "measured": None,
        "cache": "miss",
        "drift_ratio": None,
    }
    json.dumps(p.describe())


def test_no_cost_inputs_and_validation():
    d = plan_all_to_all((2, 2), ("i", "j"), backend="factorized").describe()
    assert d["block_shape"] is None and d["predicted_seconds"] is None
    with pytest.raises(ValueError, match="tuned"):
        plan_all_to_all((2, 2), ("i", "j"), backend="tuned")
    with pytest.raises(ValueError, match="backend"):
        plan_all_to_all((2, 2), ("i", "j"), backend="quantum")
    with pytest.raises(ValueError, match="variant"):
        plan_all_to_all((2, 2), ("i", "j"), backend="direct",
                        variant="sideways")
    with pytest.raises(ValueError, match="permutation"):
        plan_all_to_all((2, 3), ("i", "j"), backend="factorized",
                        round_order=(0, 0))
    p = plan_all_to_all((2, 1, 3), ("i", "j", "k"), backend="factorized",
                        round_order=(1, 0))
    assert p.order == (1, 0) and p.rev_order == (0, 1)
    assert plan_all_to_all((4, 2), ("data", "pod"),
                           backend="factorized").links == (ICI, DCN)


def test_unported_backends_raise_and_never_substitute(monkeypatch, tmp_path):
    x = torch.zeros(8, 4)
    calls = []

    def engine(name):
        def run(*args, **kwargs):
            calls.append(name)
            return args[0]
        return run

    for name in ("_factorized_impl", "_factorized_tiled_impl",
                 "_overlapped_impl", "_overlapped_tiled_impl"):
        monkeypatch.setattr(plan, name, engine(name))
    for backend in ("overlap", "pipelined"):
        # every entry point dispatches to the overlap engine, never to
        # factorized in its place
        p = plan_all_to_all((4, 2), ("i", "j"), (4,), "float32",
                            backend=backend)
        assert p.backend == backend and p.n_chunks == 2
        calls.clear()
        for run in (p.forward, p.reverse, lambda x: p.tiled(x, 0, 0),
                    p.overlap):
            run(x)
        assert calls == ["_overlapped_impl"] * 2 + \
            ["_overlapped_tiled_impl", "_overlapped_impl"], calls
    monkeypatch.undo()
    # "autotune" resolves as the reference does on the same tuning DB: a
    # miss is the cost model's choice, a hit the recorded winner; it runs
    # like every backend (here: a dims-only plan, no process groups)
    from repro_torch.core.autotune import TuningDB, plan_db_key
    db_path = tmp_path / "tuning.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(db_path))
    monkeypatch.setenv("REPRO_TUNING_DB", str(db_path))
    auto = plan_all_to_all((4, 2), ("i", "j"), (4,), "float32",
                           backend="autotune")
    tuned = jax_plan.plan_all_to_all((4, 2), ("i", "j"), (4,), "float32",
                                     backend="tuned")
    assert auto.backend == tuned.backend and auto.tuned_from == "model"
    TuningDB().put(plan_db_key(None, (4, 2), ("i", "j"), (4,),
                               "float32", "natural"), {
        "version": 1, "winner": {"backend": "overlap", "round_order": [1, 0],
                                 "n_chunks": 4, "median_us": 3.0}})
    auto = plan_all_to_all((4, 2), ("i", "j"), (4,), "float32",
                           backend="autotune")
    ref = jax_plan.plan_all_to_all((4, 2), ("i", "j"), (4,), "float32",
                                   backend="autotune")
    assert auto.describe() == ref.describe()
    assert (auto.backend, auto.order, auto.n_chunks, auto.tuned_from) \
        == ("overlap", (1, 0), 4, "measured")
    for run in (auto.forward, auto.reverse, lambda x: auto.tiled(x, 0, 0),
                auto.overlap):
        with pytest.raises(ValueError, match="DeviceMesh"):
            run(x)
    # a plan built from dims alone has no process groups to run on
    with pytest.raises(ValueError, match="DeviceMesh"):
        plan_all_to_all((4, 2), ("i", "j"), backend="direct").forward(x)


def test_dtype_spellings_share_a_plan():
    a = plan_all_to_all((2, 2), ("i", "j"), (8,), torch.bfloat16,
                        backend="direct")
    assert plan_all_to_all((2, 2), ("i", "j"), (8,), "bfloat16",
                           backend="direct") is a
    assert a.block_bytes == 16 and a.describe()["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="dtype"):
        plan.torch_dtype("float99")


# ---------------------------------------------------------------------------
# registries and the communicator
# ---------------------------------------------------------------------------


def test_registry_hits_misses_and_bound():
    a = plan_all_to_all((2, 2), ("i", "j"), (8,), "float32")
    b = plan_all_to_all((2, 2), ("i", "j"), (8,), "float32")
    assert a is b and a.describe()["cache"] == "hit"
    assert plan_cache_stats()["hits"] == 1
    assert plan_cache_stats()["misses"] == 1
    set_plan_cache_capacity(4)
    for k in range(20):
        plan_all_to_all((2, 2), ("i", "j"), (k + 1,), "float32",
                        backend="direct")
    stats = plan_cache_stats()
    assert stats["size"] <= 4 and stats["evictions"] == 17
    free_plans()
    assert plan_cache_stats()["size"] == 0


def test_lru_cache():
    seen = []
    c = cache.LRUCache(capacity=2, on_evict=seen.append)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and seen == [2]
    assert c.stats == {"hits": 1, "misses": 1, "evictions": 1}
    c.set_capacity(1)
    assert len(c) == 1 and c.stats["evictions"] == 2


def test_comm_describe_sub_and_free_match_reference():
    c = comm.torus_comm((2, 3, 2), ("a", "b", "c"))
    jc = jax_comm.torus_comm((2, 3, 2), ("a", "b", "c"))
    assert comm.torus_comm((2, 3, 2), ("a", "b", "c")) is c
    assert repr(c) == repr(jc)
    s, js = c.sub(("c", "a")), jc.sub(("c", "a"))
    assert s.dims == js.dims == (2, 2)
    for x, jx in ((c, jc), (s, js)):
        x.all_to_all((8,), "float32")
        jx.all_to_all((8,), "float32")
        assert x.describe() == jx.describe()
    # sub-comm all-to-all plans are the top-level plans
    assert s.all_to_all((8,), "float32") is \
        comm.torus_comm((2, 2), ("c", "a")).all_to_all((8,), "float32")
    for fam in ("all_gather", "reduce_scatter"):
        for owner, jowner in ((c, jc), (s, js)):
            back = tuple(reversed(range(owner.d)))
            for kw in (dict(backend="tuned"),
                       dict(backend="factorized", round_order=back)):
                got = getattr(owner, fam)((4, 4), "int32", **kw)
                want = getattr(jowner, fam)((4, 4), "int32", **kw)
                assert got.describe() == want.describe()
                assert repr(got) == repr(want)
    with pytest.raises(ValueError, match="gather_backend|backend"):
        c.all_gather((4,), "int32", backend="overlap")
    live = plan_cache_stats()["size"]
    assert c.stats()["comm"]["plans_live"] > 0
    with c:
        pass
    assert plan_cache_stats()["size"] < live
    assert c.describe()["plans"] == 0 and s._freed
    assert comm.torus_comm((2, 3, 2), ("a", "b", "c")) is not c
    stats = comm.unified_stats()
    want = jax_comm.unified_stats()
    assert set(stats) == set(want) == {"factorization", "plans", "autotune",
                                       "tuning_db", "comms", "telemetry"}
    assert set(stats["telemetry"]) == set(want["telemetry"])
    assert set(stats["autotune"]) == set(want["autotune"])
    assert "plan_cache.size" in stats["telemetry"]["metrics"]
    assert "autotune.db_hits" in stats["telemetry"]["metrics"]
    with pytest.raises(ValueError, match="duplicate"):
        c.sub(("a", "a"))
    with pytest.raises(ValueError, match="not in"):
        c.sub(("z",))


@pytest.mark.parametrize("family", ["all_gather", "reduce_scatter"])
def test_gather_plans_refuse_chunks_and_dims_only_execution(family):
    c = comm.torus_comm((2, 2), ("i", "j"))
    x = torch.zeros(4) if family == "all_gather" else torch.zeros(4, 4)
    with pytest.raises(NotImplementedError, match="n_chunks=2"):
        getattr(c, family)((4,), "int32", n_chunks=2).forward(x)
    with pytest.raises(ValueError, match="DeviceMesh"):
        getattr(c, family)((4,), "int32").forward(x)
