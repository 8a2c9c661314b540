"""The port's measured plan selection (repro_torch.core.autotune) against
the JAX package.

The reference's cases (tests/test_core_autotune.py) run on the port: the
tuning DB's persistence and robustness and its environment override,
lookup and its hit / miss accounting, plan integration (``tuned_from``
provenance, the model fallback, the measured links), and the per-axis
link feedback.  The parts that need one process only use dims-tuple
plans (``fp:none`` keys); the measured search is collective in the port
and runs on gloo worlds.

Held against the reference on the same inputs, exactly unless stated:
the DB keys of dims plans, the DB file (either package's loads in the
other), and the ``describe()`` of a ``backend="autotune"`` plan for one
record per winner backend, with and without measured links
(``predicted_seconds`` to 1e-12 relative).

Two gloo worlds, (2,2) and (2,3), run the search: every rank returns
the same measured plan, ``budget_seconds=0`` times only the direct and
factorized baselines and skips the same rows on every rank, a DB hit
times nothing, the (2,3) torus measures another factorization as a row
that cannot win, and the autotuned ``forward`` (also through
``TorusComm.all_to_all`` / ``ragged_all_to_all``) equals the definition.
"""

import importlib
import json
import math
import warnings

import pytest

from repro.core import plan as jax_plan
from repro_torch.core import plan as core_plan
from repro_torch.core.autotune import (
    DB_VERSION,
    MEASURED_BACKENDS,
    TuningDB,
    autotune_stats,
    db_generation,
    default_db_path,
    fingerprint_digest,
    lookup_measured,
    plan_db_key,
    ragged_db_key,
    reset_autotune_stats,
)
from repro_torch.core.plan import free_plans, plan_all_to_all
from repro_torch.core.tuning import (
    ICI,
    LinkModel,
    choose_algorithm,
    choose_chunks,
    per_axis_links,
    predict_factorized,
    predict_overlapped,
)
from torch_dist import run_world

# the module (``repro.core`` re-exports the function under its name)
jax_autotune = importlib.import_module("repro.core.autotune")
# a DB identity as ``db_fingerprint`` makes it: rank fingerprint, backend
FP = (((0, "cpu"),), "gloo")


@pytest.fixture(autouse=True)
def _fresh_state(tmp_path, monkeypatch):
    """Every test gets an isolated tuning DB (via the env override; the
    reference's too), empty registries, and zeroed counters."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "tuning.json"))
    free_plans()
    jax_plan.free_plans()
    reset_autotune_stats()
    yield
    free_plans()
    jax_plan.free_plans()
    reset_autotune_stats()


def _record(backend="factorized", order=(0,), n_chunks=1, **extra):
    rec = {"version": DB_VERSION,
           "winner": {"backend": backend, "round_order": list(order),
                      "n_chunks": n_chunks, "median_us": 12.5},
           "table": [{"backend": backend, "dims": [1],
                      "round_order": list(order), "n_chunks": n_chunks,
                      "median_us": 12.5, "eligible": True}]}
    rec.update(extra)
    return rec


class TestTuningDB:
    def test_env_override_honored(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_TUNING_DB",
                           str(tmp_path / "other.json"))
        assert default_db_path() == tmp_path / "other.json"
        db = TuningDB()
        assert db.path == tmp_path / "other.json"
        db.put("k", _record())
        assert (tmp_path / "other.json").exists()

    def test_default_is_the_ports_own_file(self, monkeypatch, tmp_path):
        monkeypatch.delenv("REPRO_TORCH_TUNING_DB")
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        assert default_db_path() == tmp_path / "repro_torch" / "tuning.json"
        assert default_db_path() != jax_autotune.default_db_path()

    def test_round_trip_persistence(self):
        rec = _record("overlap", (1, 0), 4, measured_links=[
            {"alpha": 2e-6, "bandwidth": 1e9}])
        TuningDB().put("some|key", rec)
        # a fresh handle (fresh process analogue) reads the same record
        got = TuningDB().get("some|key")
        assert got == json.loads(json.dumps(rec))   # JSON round-trip exact
        assert len(TuningDB()) == 1

    def test_put_merges_existing_entries(self):
        TuningDB().put("a", _record())
        TuningDB().put("b", _record("direct", (0,)))
        db = TuningDB()
        assert db.get("a") is not None and db.get("b") is not None

    def test_missing_file_is_empty(self):
        assert TuningDB().load() == {}

    @pytest.mark.parametrize("garbage", [
        "{ not json",                       # corrupt
        '{"version": 1, "entries": ',       # truncated write
        '["a", "list"]',                    # wrong shape
        '{"version": 99, "entries": {}}',   # future version
    ])
    def test_corrupt_db_warns_and_loads_empty(self, garbage):
        db = TuningDB()
        db.path.write_text(garbage)
        with pytest.warns(UserWarning, match="tuning DB"):
            assert db.load() == {}

    def test_corrupt_db_never_crashes_plan_construction(self):
        TuningDB().path.write_text("\x00garbage\x00")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            p = plan_all_to_all((1,), ("x",), (8,), "float32",
                                backend="autotune")
        assert p.tuned_from == "model"   # fell back, did not crash

    def test_clear_deletes_and_missing_ok(self):
        db = TuningDB()
        db.put("k", _record())
        db.clear()
        assert not db.path.exists()
        db.clear()   # second delete is a no-op, not an error

    def test_writes_bump_generation(self):
        g0 = db_generation()
        TuningDB().put("k", _record())
        assert db_generation() == g0 + 1
        TuningDB().clear()
        assert db_generation() == g0 + 2

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_file_loads_in_the_other_package(self, writer):
        recs = {plan_db_key(None, (2, 2), ("i", "j"), (8,), "float32",
                            "natural"): _record("overlap", (1, 0), 2),
                ragged_db_key(None, (4,), ("x",), (16,), "bfloat16", 5,
                              "paper", 0.3): {
                    "version": 1, "winner": {"backend": "sparse",
                                             "median_us": 3.5}}}
        w, r = (TuningDB, jax_autotune.TuningDB)[::1 if writer == "port"
                                                 else -1]
        for k, v in recs.items():
            w().put(k, v)
        assert r().load() == w().load() == recs


class TestLookup:
    def _store(self, fp=FP, block=(8,), dtype="float32", **rec_kw):
        key = plan_db_key(fp, (1,), ("x",), block, dtype, "natural")
        TuningDB().put(key, _record(**rec_kw))
        return key

    def test_hit_and_miss_counters(self):
        assert lookup_measured(FP, (1,), ("x",), (8,), "float32",
                               "natural") is None
        self._store()
        assert lookup_measured(FP, (1,), ("x",), (8,), "float32",
                               "natural") is not None
        stats = autotune_stats()
        assert stats == {"searches": 0, "timing_executions": 0,
                         "db_hits": 1, "db_misses": 1}

    def test_fingerprint_mismatch_is_a_miss(self):
        self._store()
        other_fp = (FP[0], "nccl")      # same ranks, another backend
        assert lookup_measured(other_fp, (1,), ("x",), (8,), "float32",
                               "natural") is None
        assert plan_db_key(other_fp, (1,), ("x",), (8,), "float32",
                           "natural") != plan_db_key(
            FP, (1,), ("x",), (8,), "float32", "natural")

    def test_malformed_record_is_a_miss(self):
        key = self._store()
        entries = TuningDB().load()
        entries[key] = {"winner": {"backend": "quantum"}}
        TuningDB().put(key, entries[key])
        with pytest.warns(UserWarning, match="malformed"):
            assert lookup_measured(FP, (1,), ("x",), (8,), "float32",
                                   "natural") is None

    def test_key_separates_block_dtype_variant(self):
        base = plan_db_key(None, (2, 3), ("i", "j"), (8,), "float32",
                           "natural")
        assert base != plan_db_key(None, (2, 3), ("i", "j"), (16,),
                                   "float32", "natural")
        assert base != plan_db_key(None, (2, 3), ("i", "j"), (8,),
                                   "int32", "natural")
        assert base != plan_db_key(None, (2, 3), ("i", "j"), (8,),
                                   "float32", "paper")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
    def test_keys_match_reference(self, dtype):
        import torch
        for dt in (dtype, getattr(torch, dtype)):
            assert plan_db_key(None, (2, 3), ("i", "j"), (4, 8), dt,
                               "natural") == jax_autotune.plan_db_key(
                None, (2, 3), ("i", "j"), (4, 8), dtype, "natural")
            for density in (1.0, 0.3, 0.004):
                assert ragged_db_key(
                    None, (2, 2), ("data", "pod"), (4096,), dt, 2048,
                    "paper", density) == jax_autotune.ragged_db_key(
                    None, (2, 2), ("data", "pod"), (4096,), dtype, 2048,
                    "paper", density)
        assert fingerprint_digest(FP) == jax_autotune.fingerprint_digest(FP)


class TestPlanIntegration:
    def test_miss_falls_back_to_model(self):
        p = plan_all_to_all((1,), ("x",), (8,), "float32",
                            backend="autotune")
        assert p.requested_backend == "autotune"
        assert p.tuned_from == "model" and p.measured is None
        assert p.describe()["tuned_from"] == "model"
        assert autotune_stats()["db_misses"] == 1

    def test_autotune_needs_cost_inputs(self):
        with pytest.raises(ValueError, match="autotune"):
            plan_all_to_all((2, 2), ("i", "j"), backend="autotune")

    def test_hit_rebuilds_winner_without_measuring(self):
        key = plan_db_key(None, (1,), ("x",), (8,), "float32", "natural")
        TuningDB().put(key, _record("direct", (), 1))
        p = plan_all_to_all((1,), ("x",), (8,), "float32",
                            backend="autotune")
        assert p.tuned_from == "measured"
        assert p.backend == "direct"
        assert p.measured["median_us"] == 12.5
        assert p.describe()["measured"]["table"][0]["backend"] == "direct"
        assert autotune_stats()["timing_executions"] == 0

    def test_db_write_invalidates_cached_autotune_plan(self):
        p_model = plan_all_to_all((1,), ("x",), (8,), "float32",
                                  backend="autotune")
        assert p_model.tuned_from == "model"
        key = plan_db_key(None, (1,), ("x",), (8,), "float32", "natural")
        TuningDB().put(key, _record("direct", (), 1))
        p_meas = plan_all_to_all((1,), ("x",), (8,), "float32",
                                 backend="autotune")
        assert p_meas is not p_model
        assert p_meas.tuned_from == "measured"

    def test_unusable_record_falls_back(self):
        key = plan_db_key(None, (1,), ("x",), (8,), "float32", "natural")
        TuningDB().put(key, _record("factorized", (3, 1, 0, 2), 1))
        with pytest.warns(UserWarning, match="unusable"):
            p = plan_all_to_all((1,), ("x",), (8,), "float32",
                                backend="autotune")
        assert p.tuned_from == "model"
        stats = autotune_stats()
        assert stats["db_hits"] == 0 and stats["db_misses"] == 1, stats

    def test_measured_links_flow_into_plan(self):
        key = plan_db_key(None, (1,), ("x",), (8,), "float32", "natural")
        TuningDB().put(key, _record(
            "factorized", (), 1,
            measured_links=[{"alpha": 3e-6, "bandwidth": 2.5e9}]))
        p = plan_all_to_all((1,), ("x",), (8,), "float32",
                            backend="autotune")
        assert p.links == (LinkModel(alpha=3e-6, bandwidth=2.5e9),)
        assert p.describe()["links"] == [{"alpha": 3e-6,
                                          "bandwidth": 2.5e9}]

    def test_explicit_backend_has_no_provenance(self):
        p = plan_all_to_all((2, 2), ("i", "j"), (8,), "float32",
                            backend="factorized")
        d = p.describe()
        assert d["tuned_from"] is None and d["measured"] is None

    def test_comm_bound_db(self, tmp_path):
        """A comm bound to its own DB reads it (and so do its sub-comms),
        and is a registry entry apart from the default-DB comm."""
        from repro_torch.core.comm import torus_comm
        own = TuningDB(tmp_path / "own.json")
        own.put(plan_db_key(None, (2, 2), ("i", "j"), (8,), "float32",
                            "natural"), _record("direct", (0, 1), 1))
        comm = torus_comm((2, 2), ("i", "j"), db=own)
        assert comm is not torus_comm((2, 2), ("i", "j"))
        assert comm.all_to_all((8,), "float32",
                               backend="autotune").tuned_from == "measured"
        assert torus_comm((2, 2), ("i", "j")).all_to_all(
            (8,), "float32", backend="autotune").tuned_from == "model"
        assert comm.sub(("j",))._db is own
        assert comm.stats()["tuning_db"]["path"] == own.path_key

    @pytest.mark.parametrize("links", [False, True])
    @pytest.mark.parametrize("winner", MEASURED_BACKENDS)
    def test_describe_matches_reference(self, winner, links):
        dims, axes, block = (2, 3), ("data", "pod"), (4, 64)
        rec = _record(winner, (1, 0), 3 if winner == "overlap" else 1)
        if links:
            rec["measured_links"] = [{"alpha": 2e-6, "bandwidth": 3e10},
                                     {"alpha": 4e-5, "bandwidth": 5e9}]
        TuningDB().put(plan_db_key(None, dims, axes, block, "bfloat16",
                                   "natural"), rec)
        got = plan_all_to_all(dims, axes, block, "bfloat16",
                              backend="autotune").describe()
        want = jax_plan.plan_all_to_all(dims, axes, block, "bfloat16",
                                        backend="autotune").describe()
        assert got.pop("predicted_seconds") == pytest.approx(
            want.pop("predicted_seconds"), rel=1e-12)
        assert got == want
        assert (got["backend"], got["tuned_from"]) == (winner, "measured")

    def test_ragged_autotune_data_plan_matches_reference(self):
        TuningDB().put(plan_db_key(None, (2, 2), ("i", "j"), (8, 4),
                                   "float32", "natural"),
                       _record("overlap", (0, 1), 2))
        got = core_plan.plan_ragged_all_to_all(
            (2, 2), ("i", "j"), (4,), "float32", max_count=5,
            backend="autotune").describe()
        want = jax_plan.plan_ragged_all_to_all(
            (2, 2), ("i", "j"), (4,), "float32", max_count=5,
            backend="autotune").describe()
        assert got == want and got["tuned_from"] == "measured"


class TestPerAxisLinkFeedback:
    """Per-axis LinkModel overrides flow end-to-end through the analytic
    model (the autotune-measured-bandwidth feedback path)."""

    def test_per_axis_links_broadcast_and_validate(self):
        assert per_axis_links(ICI, 3) == (ICI, ICI, ICI)
        two = (ICI, LinkModel(alpha=1e-5, bandwidth=1e9))
        assert per_axis_links(two, 2) == two
        with pytest.raises(ValueError, match="links"):
            per_axis_links(two, 3)

    def test_uniform_scalar_accepted_everywhere(self):
        dims, b = (4, 4), float(1 << 16)
        p = math.prod(dims)
        assert predict_factorized(dims, ICI, b, p) == \
            predict_factorized(dims, (ICI, ICI), b, p)
        assert predict_overlapped(dims, ICI, b, p, 3) == \
            predict_overlapped(dims, (ICI, ICI), b, p, 3)
        assert choose_chunks(dims, ICI, b) == \
            choose_chunks(dims, (ICI, ICI), b)
        assert choose_algorithm(dims, ICI, b).kind == \
            choose_algorithm(dims, (ICI, ICI), b).kind

    def test_measured_slow_axis_changes_the_choice(self):
        dims, b = (8, 8), float(1 << 22)
        slow = LinkModel(alpha=5e-5, bandwidth=1e8)
        uniform = choose_chunks(dims, ICI, b, max_chunks=8)
        mixed = choose_chunks(dims, (ICI, slow), b, max_chunks=8)
        p = math.prod(dims)
        t_u = predict_overlapped(dims, (ICI, slow), b, p, uniform)
        t_m = predict_overlapped(dims, (ICI, slow), b, p, mixed)
        assert t_m <= t_u

    def test_legacy_pipelined_choose_chunks_accepts_overrides(self):
        from repro_torch.core.dims import dims_create
        from repro_torch.core.pipelined import choose_chunks as legacy_cc
        from repro_torch.core.tuning import choose_chunks as tuning_cc
        b = float(1 << 22)
        slow = LinkModel(alpha=5e-5, bandwidth=1e8)
        dims = dims_create(64, 2)
        assert legacy_cc(64, 2, b, ICI, 8, links=(ICI, slow)) == \
            tuning_cc(dims, (ICI, slow), b, max_chunks=8)
        assert legacy_cc(64, 2, b, ICI, 8) == \
            tuning_cc(dims, ICI, b, max_chunks=8)


# ---------------------------------------------------------------------------
# The measured search on gloo worlds
# ---------------------------------------------------------------------------

BLOCK = (48,)


def _search_rank(rank, n, dims, db_dir):
    """The search and its replays on one rank of the world."""
    import os

    import torch
    from repro_torch.core.autotune import (autotune, autotune_ragged,
                                           autotune_stats)
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.plan import plan_all_to_all

    os.environ["REPRO_TORCH_TUNING_DB"] = f"{db_dir}/default.json"
    names = ("i", "j")
    mesh = cart_create(n, dims, names, device_type="cpu")
    comm = torus_comm(mesh, names)
    p = math.prod(dims)
    gen = torch.Generator().manual_seed(2)
    X = torch.randn((p, p) + BLOCK, generator=gen)
    x, want = X[comm.rank].contiguous(), X[:, comm.rank]
    out = {}

    # before: a miss, cached in the registry under the DB's generation
    before = plan_all_to_all(mesh, names, BLOCK, torch.float32,
                             backend="autotune")
    out["before"] = before.tuned_from
    plan = autotune(mesh, names, BLOCK, torch.float32, warmup=1,
                    repeats=2, max_chunks=4, budget_seconds=120)
    out["plan"] = plan.describe()
    out["forward_ok"] = torch.equal(plan.forward(x), want) \
        and torch.equal(plan.reverse(x), want)
    stats = autotune_stats()["timing_executions"]
    again = plan_all_to_all(mesh, names, BLOCK, torch.float32,
                            backend="autotune")
    via_comm = comm.all_to_all(BLOCK, torch.float32, backend="autotune")
    out["replay_is_plan"] = again is plan and via_comm is plan
    out["replay_timed"] = autotune_stats()["timing_executions"] - stats

    # budget 0: the two baselines only, the same skipped rows everywhere
    from repro_torch.core.autotune import TuningDB
    budget = TuningDB(f"{db_dir}/budget.json")
    zero = autotune(mesh, names, BLOCK, torch.float32, warmup=0, repeats=1,
                    budget_seconds=0, db=budget)
    rec = next(iter(budget.load().values()))
    out["budget"] = (zero.describe(), rec["table"], rec["skipped"],
                     rec["measured_links"])
    out["default_keys"] = sorted(TuningDB().load())

    # the Alltoallv family: the ragged-vs-sparse search, and a ragged
    # plan whose padded data block was measured
    rp = autotune_ragged(mesh, names, (4,), torch.float32, max_count=5,
                         density=0.5, warmup=1, repeats=2)
    autotune(mesh, names, (8, 4), torch.float32, warmup=0, repeats=1,
             include_factorizations=False)
    ragged = comm.ragged_all_to_all((4,), torch.float32, max_count=5,
                                    backend="autotune")
    explicit = comm.ragged_all_to_all((4,), torch.float32, max_count=5,
                                      backend=ragged.backend,
                                      round_order=ragged.data.order,
                                      n_chunks=ragged.n_chunks)
    counts = torch.arange(p, dtype=torch.int32) % 6
    payload = torch.randn((p, 5, 4), generator=gen)
    got, want_r = ragged.forward(payload, counts), \
        explicit.forward(payload, counts)
    out["ragged"] = (type(rp).__name__, ragged.describe(),
                     all(torch.equal(a, b) for a, b in zip(got, want_r)))
    return out


def _worlds(dims, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autotune")
    return run_world(_search_rank, math.prod(dims), tmp, dims, str(tmp))


@pytest.fixture(scope="module", params=[(2, 2), (2, 3)], ids=str)
def world(request, tmp_path_factory):
    return request.param, _worlds(request.param, tmp_path_factory)


class TestAutotuneSearch:
    def test_search_agrees_and_persists(self, world):
        dims, ranks = world
        plans = [r["plan"] for r in ranks]
        assert all(d == plans[0] for d in plans)
        d = plans[0]
        assert d["tuned_from"] == "measured" and d["requested_backend"] \
            == "autotune"
        assert d["backend"] in MEASURED_BACKENDS
        table = d["measured"]["table"]
        win = min((r for r in table if r["eligible"]),
                  key=lambda r: r["median_us"])
        assert (d["backend"], d["round_order"], d["n_chunks"]) == \
            (win["backend"], win["round_order"], win["n_chunks"])
        eligible = [(r["backend"], tuple(r["round_order"]), r["n_chunks"])
                    for r in table if r["eligible"]]
        assert eligible[:3] == [("direct", (0, 1), 1),
                                ("factorized", (0, 1), 1),
                                ("factorized", (1, 0), 1)]
        assert {n for b, _, n in eligible if b == "overlap"} >= {2, 4}
        for r in ranks:
            assert r["before"] == "model"
            assert r["forward_ok"] and r["replay_is_plan"]
            assert r["replay_timed"] == 0

    def test_other_factorizations_never_win(self, world):
        dims, ranks = world
        table = ranks[0]["plan"]["measured"]["table"]
        alt = [r["dims"] for r in table if not r["eligible"]]
        assert alt == ([] if dims == (2, 2) else [[1, 2, 3]])

    def test_zero_budget_times_the_baselines_only(self, world):
        dims, ranks = world
        budgets = [r["budget"] for r in ranks]
        assert all(b[1:] == budgets[0][1:] for b in budgets)
        desc, table, skipped, links = budgets[0]
        assert [(r["backend"], r["round_order"]) for r in table] == \
            [("direct", [0, 1]), ("factorized", [0, 1])]
        assert skipped[0] == {"backend": "factorized",
                              "round_order": [1, 0], "n_chunks": 1}
        assert {s["backend"] for s in skipped} == \
            ({"factorized", "overlap"})
        assert links is None            # the fit gave up on the budget
        assert desc["tuned_from"] == "measured"
        assert desc["backend"] in ("direct", "factorized")
        # the explicit handle's record never reached the default DB
        assert len(ranks[0]["default_keys"]) == 1

    def test_alltoallv_family(self, world):
        dims, ranks = world
        kinds = {r["ragged"][0] for r in ranks}
        assert len(kinds) == 1 and kinds <= {"RaggedA2APlan",
                                             "SparseA2APlan"}
        descs = [r["ragged"][1] for r in ranks]
        assert all(d == descs[0] for d in descs)
        assert descs[0]["tuned_from"] == "measured"
        assert all(r["ragged"][2] for r in ranks)
