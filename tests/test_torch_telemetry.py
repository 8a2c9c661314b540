"""The port's telemetry (repro_torch.core.telemetry) and its hooks, against
the JAX package.

The reference's single-process cases (tests/test_telemetry.py) run on the
port's tracer, metrics, drift detector and watchdog; the detector and the
Chrome-trace export are also held against the reference on the same
inputs (equal, apart from timestamps and ids).  The reference's
wall-clock overhead ratio is replaced by a deterministic check: with
tracing off, a plan call never enters the traced path and records
nothing.

One 4-rank gloo world on the (2,2) torus runs every plan kind untraced
and traced: the outputs and the reorder passes (counted at
``kernels.ops``) are equal, the span tree is the reference's
(``plan.execute`` with a ``plan.round`` per factorized round, one fused
round otherwise; the counts phase inside the ragged call), the drift keys
are the reference's format, a ``FaultInjector`` slow round shows as that
round's drift, and ``core.profile_inspect.interleave_report`` on the
MoE's overlap call finds exchanges between its compute stages, on the
factorized call none.
"""

import json
import time
import warnings

import numpy as np
import pytest

from repro.core import telemetry as jax_telemetry
from repro_torch.core import comm as _comm  # noqa: F401  (its provider)
from repro_torch.core import plan as _plan
from repro_torch.core import telemetry
from repro_torch.core.cache import free_all
from repro_torch.core.plan import free_plans, plan_all_to_all
from repro_torch.core.telemetry import (
    DriftDetector,
    MetricsRegistry,
    Tracer,
    disable_tracing,
    drift_detector,
    enable_tracing,
    get_tracer,
    metrics,
    metrics_snapshot,
    reset_telemetry,
)
from repro_torch.runtime.watchdog import EscalationPolicy, StragglerWatchdog
from torch_dist import run_world


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Every test starts with a disabled tracer, empty metrics and an
    empty drift table, and leaves the singletons the way it found them."""
    reset_telemetry()
    yield
    reset_telemetry()
    free_plans()
    free_all()


# ---------------------------------------------------------------------------
# Tracer: spans, nesting, ring buffer, disabled path
# ---------------------------------------------------------------------------


class TestTracer:
    def test_disabled_span_is_noop(self):
        tr = Tracer()
        assert not tr.enabled
        with tr.span("anything", foo=1) as sp:
            sp.set(bar=2)       # must not raise on the null span
        assert tr.spans() == []
        assert tr.stats() == {"enabled": False, "spans": 0,
                              "capacity": 4096, "dropped": 0}

    def test_span_records_name_duration_attrs(self):
        tr = Tracer(enabled=True)
        with tr.span("work", cat="test", k=3) as sp:
            time.sleep(0.005)
            sp.set(extra="v")
        (s,) = tr.spans()
        assert s.name == "work"
        assert s.duration >= 0.004
        assert s.attrs["cat"] == "test" and s.attrs["k"] == 3
        assert s.attrs["extra"] == "v"
        assert s.parent_id is None

    def test_nesting_parent_ids(self):
        tr = Tracer(enabled=True)
        with tr.span("outer"):
            with tr.span("mid"):
                with tr.span("inner"):
                    pass
            with tr.span("mid2"):
                pass
        by_name = {s.name: s for s in tr.spans()}
        assert set(by_name) == {"outer", "mid", "inner", "mid2"}
        outer = by_name["outer"]
        assert by_name["mid"].parent_id == outer.span_id
        assert by_name["mid2"].parent_id == outer.span_id
        assert by_name["inner"].parent_id == by_name["mid"].span_id
        # children complete (and record) before the parent
        names = [s.name for s in tr.spans()]
        assert names.index("inner") < names.index("outer")

    def test_exception_tagged_and_reraised(self):
        tr = Tracer(enabled=True)
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        (s,) = tr.spans()
        assert s.attrs["exception"] == "ValueError"

    def test_ring_buffer_bound_and_dropped(self):
        tr = Tracer(capacity=4, enabled=True)
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        spans = tr.spans()
        assert len(spans) == 4
        assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
        assert tr.dropped == 6
        tr.clear()
        assert tr.spans() == [] and tr.dropped == 0

    def test_enable_disable_singleton(self):
        tr = enable_tracing(capacity=16)
        assert tr is get_tracer() and tr.enabled
        assert tr.capacity == 16
        disable_tracing()
        assert not get_tracer().enabled


# ---------------------------------------------------------------------------
# Chrome-trace export: golden schema, and the reference's document
# ---------------------------------------------------------------------------


def _span_tree(tracer):
    """The same span tree (names, attrs, nesting) on either tracer."""
    with tracer.span("plan.execute", cat="plan", backend="factorized",
                     predicted_seconds=1e-6, bad=object()):
        for k, axis in enumerate(("i", "j")):
            with tracer.span("plan.round", cat="plan", axis=axis, round=k):
                pass
    with tracer.span("train.step", cat="trainer", step=1):
        with tracer.span("checkpoint.save", cat="checkpoint", step=1):
            pass


def _comparable(doc):
    """A Chrome-trace document without its timestamps and span ids; each
    event's parent as its index in the list."""
    events = doc["traceEvents"]
    index = {ev["args"]["span_id"]: i for i, ev in enumerate(events)}
    out = []
    for ev in events:
        args = {k: v for k, v in ev["args"].items()
                if k not in ("span_id", "parent_id")}
        out.append({**{k: v for k, v in ev.items()
                       if k not in ("ts", "dur", "args")},
                    "args": args,
                    "parent": index.get(ev["args"].get("parent_id"))})
    return out, doc["displayTimeUnit"], doc["otherData"]["dropped_spans"]


class TestChromeTraceExport:
    def test_schema(self, tmp_path):
        tr = Tracer(enabled=True)
        with tr.span("plan.execute", cat="plan", backend="factorized"):
            with tr.span("plan.round", cat="plan", axis="x", round=0):
                pass
        path = tmp_path / "trace.json"
        doc = tr.export_chrome_trace(path)
        # the written file is valid JSON and identical to the return
        assert json.loads(path.read_text()) == doc
        assert doc["displayTimeUnit"] == "ms"
        assert doc["otherData"]["exporter"] == "repro_torch.core.telemetry"
        assert doc["otherData"]["dropped_spans"] == 0
        assert len(doc["traceEvents"]) == 2
        for ev in doc["traceEvents"]:
            assert set(ev) == {"name", "ph", "ts", "dur", "pid", "tid",
                               "cat", "args"}
            assert ev["ph"] == "X"
            assert ev["pid"] == 1
            assert isinstance(ev["ts"], float) and ev["ts"] >= 0.0
            assert isinstance(ev["dur"], float) and ev["dur"] >= 0.0
            assert isinstance(ev["args"], dict)
            assert "span_id" in ev["args"]
        by_name = {ev["name"]: ev for ev in doc["traceEvents"]}
        assert by_name["plan.round"]["args"]["parent_id"] \
            == by_name["plan.execute"]["args"]["span_id"]
        assert by_name["plan.round"]["cat"] == "plan"

    def test_non_json_attrs_filtered(self):
        tr = Tracer(enabled=True)
        with tr.span("s", ok=1, bad=object(), also_ok="x"):
            pass
        (ev,) = tr.export_chrome_trace()["traceEvents"]
        assert ev["args"]["ok"] == 1 and ev["args"]["also_ok"] == "x"
        assert "bad" not in ev["args"]
        json.dumps(ev)      # the whole event is serializable

    def test_matches_reference(self):
        docs = []
        for cls in (Tracer, jax_telemetry.Tracer):
            tr = cls(capacity=3, enabled=True)
            _span_tree(tr)
            docs.append(_comparable(tr.export_chrome_trace()))
        assert docs[0] == docs[1]
        assert len(docs[0][0]) == 3 and docs[0][2] == 2   # ring overflow


# ---------------------------------------------------------------------------
# Metrics registry + provider merge
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_counter_gauge_histogram(self):
        reg = MetricsRegistry()
        reg.counter("a.count").inc()
        reg.counter("a.count").inc(2)
        reg.gauge("a.gauge").set(7)
        h = reg.histogram("a.hist")
        h.observe(1.0)
        h.observe(3.0)
        snap = reg.snapshot()
        assert snap["a.count"] == 3
        assert snap["a.gauge"] == 7
        assert snap["a.hist"]["count"] == 2
        assert snap["a.hist"]["mean"] == 2.0
        assert snap["a.hist"]["min"] == 1.0 and snap["a.hist"]["max"] == 3.0

    def test_type_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")

    def test_provider_merge_namespaced(self):
        telemetry.register_stats_provider("tns", lambda: {
            "flat": 1, "nested": {"a": 2}})
        metrics().counter("tns.live").inc(5)
        snap = metrics_snapshot()
        assert snap["tns.flat"] == 1
        assert snap["tns.nested.a"] == 2
        assert snap["tns.live"] == 5
        # the built-in providers registered at import time are merged too
        assert any(k.startswith("plan_cache.") for k in snap)
        assert any(k.startswith("factorization.") for k in snap)
        assert any(k.startswith("comms.") for k in snap)
        del telemetry._PROVIDERS["tns"]

    def test_crashing_provider_contained(self):
        def boom():
            raise RuntimeError("nope")
        telemetry.register_stats_provider("bad", boom)
        snap = metrics_snapshot()
        assert "RuntimeError" in snap["bad.error"]
        del telemetry._PROVIDERS["bad"]


# ---------------------------------------------------------------------------
# DriftDetector: both sides of the threshold, and the reference's results
# ---------------------------------------------------------------------------


class TestDriftDetector:
    def test_below_threshold_no_recommendation(self):
        det = DriftDetector(threshold=1.5, min_samples=3)
        for _ in range(5):
            det.observe("k", 0.010, 0.012)      # ratio 1.2 < 1.5
        assert det.drift_ratio("k") == pytest.approx(1.2)
        assert not det.drifted("k")
        assert det.recommendations() == []
        assert det.summary()["k"]["drifted"] is False

    def test_above_threshold_recommends_once(self):
        det = DriftDetector(threshold=1.5, min_samples=3)
        for _ in range(5):
            det.observe("k", 0.010, 0.030)      # ratio 3.0 > 1.5
        assert det.drift_ratio("k") == pytest.approx(3.0)
        assert det.drifted("k")
        recs = det.recommendations()
        assert len(recs) == 1
        assert recs[0]["key"] == "k"
        assert recs[0]["action"] == "retune"
        assert recs[0]["ratio"] == pytest.approx(3.0)
        # one-shot per episode: the condition persisting does not re-fire
        assert det.recommendations() == []

    def test_recovery_rearms(self):
        det = DriftDetector(threshold=1.5, window=4, min_samples=3)
        for _ in range(4):
            det.observe("k", 0.010, 0.030)
        assert len(det.recommendations()) == 1
        for _ in range(4):                      # window flushes: healthy
            det.observe("k", 0.010, 0.010)
        assert det.recommendations() == []      # re-armed, not drifted
        for _ in range(4):                      # drifts again -> re-fires
            det.observe("k", 0.010, 0.030)
        assert len(det.recommendations()) == 1

    def test_min_samples_and_bad_prediction_guards(self):
        det = DriftDetector(min_samples=3)
        assert det.observe("k", 0.0, 1.0) is None       # unfitted model
        assert det.observe("k", -1.0, 1.0) is None
        det.observe("k", 0.01, 0.02)
        assert det.drift_ratio("k") is None             # < min_samples
        with pytest.raises(ValueError):
            DriftDetector(threshold=1.0)

    def test_matches_reference(self):
        rng = np.random.default_rng(7)
        keys = ["dense[data,pod]2x2:factorized:65536",
                "dense[data,pod]2x2:factorized:65536:axis=data",
                "ragged[data,pod]2x2:overlap:b2048", "sparse[x]4:b8:rho0.5"]
        seq = [(keys[rng.integers(len(keys))], float(rng.choice(
            [0.0, -1.0, 1e-3, 2e-3])), float(rng.uniform(0.5e-3, 6e-3)))
            for _ in range(200)]
        got = []
        for det in (DriftDetector(threshold=1.8, window=8, min_samples=3),
                    jax_telemetry.DriftDetector(threshold=1.8, window=8,
                                                min_samples=3)):
            ratios, recs = [], []
            for i, (key, pred, meas) in enumerate(seq):
                ratios.append(det.observe(key, pred, meas))
                if i % 17 == 0:
                    recs.append(det.recommendations())
            got.append((ratios, recs, det.summary(), det.recommendations()))
        assert got[0] == got[1]
        assert any(got[0][1]) and len(got[0][2]) == len(keys)


# ---------------------------------------------------------------------------
# Watchdog integration: events_dropped + drift -> retune
# ---------------------------------------------------------------------------


class TestWatchdogTelemetry:
    def test_events_dropped_counter_and_warning(self):
        wd = StragglerWatchdog(max_events=3)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(6):
                wd._record(("straggler", i, 1.0, 0.1))
        assert wd.events_dropped == 3
        assert len(wd.events) == 3
        assert metrics().snapshot()["watchdog.events_dropped"] == 3
        msgs = [str(w.message) for w in caught
                if "watchdog event window" in str(w.message)]
        assert len(msgs) == 1               # one-time, names the window
        assert "max_events=3" in msgs[0]

    def test_drift_verdict_routes_to_retune(self):
        pol = EscalationPolicy()
        act = pol.decide("drift")
        assert act.kind == "retune"
        # advisory: no incident opened, budgets untouched
        assert pol.retries == 0 and pol.recoveries == 0
        assert pol._incident_start is None
        assert pol.transitions[-1] == ("drift", "retune")

    def test_check_drift_end_to_end(self):
        det = drift_detector()
        for _ in range(5):
            det.observe("dense[x](4,):factorized:64", 0.001, 0.010)
        wd = StragglerWatchdog()
        out = wd.check_drift(step=12)
        assert len(out) == 1
        key, action = out[0]
        assert key == "dense[x](4,):factorized:64"
        assert action.kind == "retune"
        assert wd.last_verdict == "drift"
        assert any(ev[0] == "drift" for ev in wd.events)
        # one-shot: the persisting episode does not re-recommend
        assert wd.check_drift(step=13) == []
        assert metrics().snapshot()["drift.retune_recommendations"] == 1


# ---------------------------------------------------------------------------
# Tracing off: the traced path is never entered, nothing is recorded
# ---------------------------------------------------------------------------


class TestDisabledOverhead:
    def test_plan_execute_overhead_under_5pct(self, monkeypatch):
        """Deterministic form of the reference's overhead bound: off, a
        call of every execution method goes straight to the untraced
        implementation (a plan without process groups raises its
        ValueError there) and records nothing; on, the same call enters
        the traced path."""
        import torch

        class Entered(Exception):
            pass

        def traced(self, *args, **kwargs):
            raise Entered

        for cls in (_plan.A2APlan, _plan.RaggedA2APlan,
                    _plan.SparseA2APlan):
            monkeypatch.setattr(cls, "_traced_execute", traced)
        dense = plan_all_to_all((2, 2), ("i", "j"), (4,), "float32",
                                backend="factorized")
        ragged = _plan.plan_ragged_all_to_all((2, 2), ("i", "j"), (4,),
                                              max_count=4)
        sparse = _plan.plan_sparse_all_to_all((2, 2), ("i", "j"), (4,),
                                              max_count=4)
        x, c = torch.zeros(4, 4), torch.zeros(4, dtype=torch.int32)
        xr = torch.zeros(4, 4, 4)
        calls = [lambda: dense.forward(x), lambda: dense.reverse(x),
                 lambda: dense.tiled(x, 0, 0), lambda: dense.overlap(x),
                 lambda: ragged.forward(xr, c), lambda: ragged.reverse(xr, c),
                 lambda: sparse.forward(xr, c), lambda: sparse.reverse(xr, c)]
        assert not get_tracer().enabled
        for call in calls:
            with pytest.raises(ValueError, match="DeviceMesh|process"):
                call()
        assert get_tracer().spans() == []
        assert metrics().snapshot().get("plan.traced_executions", 0) == 0
        enable_tracing()
        for call in calls:
            with pytest.raises(Entered):
                call()


# ---------------------------------------------------------------------------
# One 4-rank gloo world: traced vs untraced, faults, interleaving
# ---------------------------------------------------------------------------

BLOCK = 64
ROW, MAX_COUNT = (4,), 5
D_MOE = 32


def _counted(names):
    """Counting wrappers on ``kernels.ops``'s reorder passes and gmm;
    returns the call log and an undo."""
    from repro_torch.kernels import ops as kops
    saved = {name: getattr(kops, name) for name in names}
    calls = []

    def counting(name):
        def fn(*args, **kwargs):
            calls.append(name)
            return saved[name](*args, **kwargs)
        return fn

    for name in names:
        setattr(kops, name, counting(name))

    def undo():
        for name, fn in saved.items():
            setattr(kops, name, fn)
    return calls, undo


def _moe_inputs(rank, n):
    """A small phi-like MoE layer's weights and this rank's tokens."""
    import torch
    rng = np.random.default_rng(11)
    E, F = 4, 64
    p = {"router": rng.standard_normal((D_MOE, E)),
         "w1": rng.standard_normal((E, D_MOE, F)) / 6,
         "w3": rng.standard_normal((E, D_MOE, F)) / 6,
         "w2": rng.standard_normal((E, F, D_MOE)) / 8}
    x = rng.standard_normal((n * 2, 8, D_MOE))[rank * 2:(rank + 1) * 2]
    return ({k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()},
            torch.tensor(x, dtype=torch.float32))


def _moe_cfg(backend):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="t", family="moe", n_layers=1, d_model=D_MOE, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=4, top_k=2,
        capacity_factor=8.0, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend, a2a_chunks=2)


def _interleave(rank, n):
    """The MoE layer's overlap and factorized calls under the profiler:
    ``interleave_report``'s counts per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cache import cart_create
    from repro_torch.core.profile_inspect import interleave_report
    from repro_torch.models.moe import expert_shard, moe_block
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type="cpu")
    p, x = _moe_inputs(rank, n)
    out = {}
    for backend in ("overlap", "factorized"):
        cfg = _moe_cfg(backend)
        ps = expert_shard(p, cfg, mesh)
        moe_block(ps, x, cfg, mesh=mesh)            # warm: plans, groups
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y, _ = moe_block(ps, x, cfg, mesh=mesh)
        rep = interleave_report(prof)
        out[backend] = {
            "interleaved": rep.interleaved_collectives,
            "collective_runs": rep.collective_runs,
            "computes": sum(c == "compute" for c, _ in rep.events),
            "collectives": sum(c == "collective" for c, _ in rep.events),
            "y": y}
    out["dy"] = float((out["overlap"].pop("y")
                       - out["factorized"].pop("y")).abs().max())
    return out


def _traced_rank(rank, n, trace_dir):
    """Every plan kind untraced, then traced; the span tree, drift and
    fault checks; then the interleaving report."""
    import torch
    from repro_torch.core import plan as planmod
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.faults import FaultInjector, FaultSpec

    mesh = cart_create(n, (2, 2), ("i", "j"), device_type="cpu")
    comm = torus_comm(mesh, ("i", "j"))
    gen = torch.Generator().manual_seed(3)
    X = torch.randn((n, n, BLOCK), generator=gen)
    x = X[rank].contiguous()
    t = X[rank, :, :16].reshape(2, 2 * n, 4).contiguous()
    plans = {b: comm.all_to_all((BLOCK,), torch.float32, backend=b)
             for b in ("direct", "factorized", "overlap")}
    ragged = comm.ragged_all_to_all(ROW, torch.float32, max_count=MAX_COUNT,
                                    backend="factorized")
    sparse = comm.sparse_all_to_all(ROW, torch.float32, max_count=MAX_COUNT,
                                    density=0.5)
    rng = np.random.default_rng(5)
    counts = torch.from_numpy((rng.integers(1, MAX_COUNT + 1, (n, n))
                               * (rng.random((n, n)) < 0.5))
                              .astype(np.int32)[rank])
    payload = torch.randn((n, MAX_COUNT) + ROW, generator=gen)

    def run_all():
        outs = []
        for plan in plans.values():
            outs += [plan.forward(x), plan.reverse(x), plan.tiled(t, 1, 0),
                     plan.overlap(x, lambda c, _i: 2 * c + 1)]
        for plan in (ragged, sparse):
            recv, rc = plan.forward(payload, counts)
            back, _ = plan.reverse(recv[:, :MAX_COUNT], rc)
            outs += [recv, rc, back]
        return outs

    calls, undo = _counted(("pack_round", "unpack_round", "repack_round"))
    tr = telemetry.get_tracer()
    try:
        untraced = run_all()
        untraced_calls = list(calls)
        spans_off = len(tr.spans())
        calls.clear()
        telemetry.enable_tracing()
        traced = run_all()
        traced_calls = list(calls)
    finally:
        telemetry.disable_tracing()
        undo()
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    tree = [(s.name, None if s.parent_id is None
             else by_id[s.parent_id].name,
             {k: s.attrs.get(k) for k in ("kind", "backend", "axis",
                                          "round", "timing")})
            for s in sorted(spans, key=lambda s: s.start)]
    doc_path = f"{trace_dir}/rank{rank}.json"
    tr.export_chrome_trace(doc_path)
    drift = sorted(telemetry.drift_detector().summary())
    n_traced = telemetry.metrics().snapshot().get("plan.traced_executions")

    # a slow second round of each factorized call shows as that round's
    # drift (the injector fires inside the round span)
    telemetry.reset_telemetry()
    plan = plans["factorized"]
    inj = FaultInjector([FaultSpec("slow", every=2, delay_seconds=0.2,
                                   label="a2a.round")], seed=0)
    inj.install(plan)
    telemetry.enable_tracing()
    try:
        faulted = [plan.forward(x) for _ in range(3)]
    finally:
        telemetry.disable_tracing()
        inj.uninstall(plan)
    summary = telemetry.drift_detector().summary()
    key = plan._drift_key()
    rounds = {a: summary[f"{key}:axis={a}"]["measured_seconds"]
              for a in ("i", "j")}
    return {
        "equal": all(torch.equal(a, b) for a, b in zip(untraced, traced)),
        "faulted_equal": all(torch.equal(f, untraced[4]) for f in faulted),
        "calls": (untraced_calls, traced_calls), "spans_off": spans_off,
        "tree": tree, "drift": drift, "trace": doc_path,
        "slow_rounds": rounds, "fired": inj.fired,
        "traced_executions": n_traced,
        "planmod_tracer": planmod._TRACER is tr,
        "interleave": _interleave(rank, n)}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traced")
    return run_world(_traced_rank, 4, tmp, str(tmp))


def test_traced_calls_run_what_untraced_calls_run(traced):
    for r in traced:
        assert r["equal"] and r["faulted_equal"] and r["planmod_tracer"]
        untraced, traced_calls = r["calls"]
        assert untraced == traced_calls and len(untraced) > 0
        assert r["spans_off"] == 0


def test_span_tree_is_the_references(traced):
    tree = traced[0]["tree"]
    execs = [(parent, attrs) for name, parent, attrs in tree
             if name == "plan.execute"]
    rounds = [(parent, attrs) for name, parent, attrs in tree
              if name == "plan.round"]
    # per dense plan: forward, reverse, tiled, overlap = 4 executes;
    # ragged: 2 of its own + 2 of its data plan; sparse: 2
    kinds = [a["kind"] for _, a in execs]
    assert kinds.count("dense") == 3 * 4 + 2
    assert kinds.count("ragged") == 2 and kinds.count("sparse") == 2
    assert all(p is None for p, a in execs if a["kind"] != "dense")
    # factorized: one round span per active round, in round order;
    # direct / overlap: one fused span each
    # (factorized: forward, reverse, tiled and the ragged data plan's
    # two calls step; its overlap() call is one fused pipeline)
    fact = [a for p, a in rounds if a["axis"] != "*"]
    fused = [a for p, a in rounds if a["axis"] == "*"]
    assert len(fact) == 2 * (3 + 2) and len(fused) == 4 + 4 + 1
    assert all(a["timing"] == "fused" for a in fused)
    assert [a["axis"] for a in fact[:2]] == ["i", "j"]
    assert all(p == "plan.execute" for p, _ in rounds)
    counts = [p for name, p, _ in tree if name == "ragged.counts"]
    assert counts == ["plan.execute", "plan.execute"]
    assert all(r["tree"] == tree for r in traced)
    assert traced[0]["traced_executions"] == 3 * 4 + 2   # dense calls


def test_drift_keys_and_chrome_trace(traced):
    drift = traced[0]["drift"]
    assert "dense[i,j]2x2:factorized:256" in drift
    assert "dense[i,j]2x2:factorized:256:axis=i" in drift
    assert "dense[i,j]2x2:overlap:256:overlap" in drift
    assert "ragged[i,j]2x2:factorized:b8" in drift
    assert "sparse[i,j]2x2:b8:rho0.5" in drift
    doc = json.loads(open(traced[0]["trace"]).read())
    assert doc["otherData"]["exporter"] == "repro_torch.core.telemetry"
    assert len(doc["traceEvents"]) == len(traced[0]["tree"])
    for ev in doc["traceEvents"]:
        assert set(ev) == {"name", "ph", "ts", "dur", "pid", "tid", "cat",
                           "args"}
        assert ev["ph"] == "X" and ev["dur"] >= 0.0


def test_fault_injected_slow_round_is_per_round_drift(traced):
    for r in traced:
        # every second guarded round: calls 2, 4, 6 are the j rounds
        assert r["fired"] == [("slow", "a2a.round", 2),
                              ("slow", "a2a.round", 4),
                              ("slow", "a2a.round", 6)]
        assert r["slow_rounds"]["j"] >= 0.2 > r["slow_rounds"]["i"]


def test_interleave_report_overlap_vs_factorized(traced):
    for r in traced:
        rep = r["interleave"]
        assert rep["factorized"]["interleaved"] == 0
        assert rep["factorized"]["computes"] == 1
        assert rep["overlap"]["computes"] == 2
        assert rep["overlap"]["interleaved"] > 0
        assert rep["overlap"]["collective_runs"] \
            > rep["factorized"]["collective_runs"]
        assert rep["overlap"]["collectives"] \
            == 2 * rep["factorized"]["collectives"]
        assert rep["dy"] < 1e-4


def test_interleave_report_reads_host_events_only():
    """On a card the profiler repeats each ``record_function`` span as a
    device annotation of the same name, at the device's time; the report
    classifies the host's events only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from repro_torch.core.profile_inspect import (COLLECTIVE_OP,
                                                  EXPERT_SPAN,
                                                  interleave_report)

    def ev(name, start, device=DeviceType.CPU):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start))
    events = [ev(COLLECTIVE_OP, 0), ev(COLLECTIVE_OP, 1), ev(EXPERT_SPAN, 2),
              ev(EXPERT_SPAN, 3.5, DeviceType.CUDA), ev(COLLECTIVE_OP, 3),
              ev(COLLECTIVE_OP, 4), ev("aten::mm", 2.5)]
    rep = interleave_report(events)
    assert [c for c, _ in rep.events] == ["collective"] * 2 + ["compute"] \
        + ["collective"] * 2
    assert rep.interleaved_collectives == 0 and rep.collective_runs == 2
