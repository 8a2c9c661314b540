"""Disaggregated serving of the port (``repro_torch.runtime.serving``:
``KVRowCodec``, ``PrefillWorker``, ``AdmissionController``,
``ServingTopology``, ``DisaggregatedServer``; ``core.plan
.KVMigrationPlan``, ``TorusComm.kv_migration``, the simulator's KV
oracle; ``launch.serve --disaggregate``) against the JAX package.

The model is the tiny f32 dense model of ``tests/test_serving.py``; its
parameters go through ``convert.params_from_jax`` and its caches through
``convert.caches_from_jax``, so the codec's rows must equal the
reference's bit for bit.  The dims-tuple server (one process, the exact
host path) must give the reference's ``done``, ticks, migrations and
migrated rows.  The mesh-backed server runs in gloo worlds of 4 and 6
ranks (one world per size, spawned once per module, every case in it):
every rank's ``done`` must equal the reference's, and with one decode
rank the ticks and migration counts too (with more, the port places by
the lowest free decode slot, ``runtime.serving``'s docstring).
"""

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.core import comm as jax_comm
from repro.core import plan as jax_plan
from repro.core import simulator as jax_sim
from repro.core import torus_comm as jax_torus_comm
from repro.core.cache import free_all as jax_free_all
from repro.core.tuning import DCN as JAX_DCN
from repro.core.tuning import ICI as JAX_ICI
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.runtime import serving as jax_serving
from repro_torch.configs import get_config
from repro_torch.core import cache, comm, plan, simulator
from repro_torch.core.tuning import DCN, ICI
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.runtime import serving
from torch_dist import run_world
from torch_serving import BASE, MAX_SEQ, SCRIPTS, as_numpy, requests, \
    world_cases


@pytest.fixture(autouse=True)
def _fresh_registries():
    def clear():
        for mod in (plan, jax_plan):
            mod.free_plans()
        cache.free_all()
        jax_free_all()
        comm.free_comms()
        jax_comm.free_comms()
    clear()
    yield
    clear()


_MODELS: dict = {}


def _models(window=None):
    """(jax model, jax params, port model, port params) of the tiny
    model, made once per window."""
    if window not in _MODELS:
        jmodel = jax_build_model(JaxModelConfig(**BASE, window=window))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = ModelConfig(**BASE, window=window)
        params = params_from_jax(as_numpy(jparams), cfg, "cpu")
        _MODELS[window] = (jmodel, jparams, build_model(cfg), params)
    return _MODELS[window]


_STEPS: dict = {}


def _jax_step(window=None):
    """One jitted reference decode step per window, shared by every
    reference worker and batcher (as the reference's launcher shares
    its ``serve_step``), so each batch shape compiles once."""
    if window not in _STEPS:
        jmodel = _models(window)[0]
        _STEPS[window] = jax.jit(
            lambda params, toks, caches: jmodel.decode_step(params, toks,
                                                            caches))
    return _STEPS[window]


def _reference(window, script, dims, **kw):
    """The reference server on a dims-tuple comm, with ``rebuild=(tick,
    p')`` as its own rebuild test does; returns it after ``run()``."""
    jmodel, jparams, _, _ = _models(window)
    rebuild = kw.pop("rebuild", None)
    jcomm = jax_torus_comm(dims, tuple(f"s{i}" for i in range(len(dims))))
    srv = jax_serving.DisaggregatedServer(jmodel, jparams, jcomm,
                                          max_seq=MAX_SEQ,
                                          serve_step=_jax_step(window), **kw)
    for req in requests(jax_serving, script):
        srv.submit(req)
    if rebuild is not None:
        for _ in range(rebuild[0]):
            srv.tick()
        srv.rebuild(rebuild[1], n_prefill=rebuild[2])
    srv.run()
    return srv


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def _filled_caches(window, feed):
    """The reference's caches after ``feed`` (a (B, T) token array) and
    the same caches in the port's layout."""
    jmodel, jparams, _, _ = _models(window)
    B = len(feed)
    caches = jmodel.init_caches(B, 16)
    for t in range(len(feed[0])):
        toks = jax.numpy.asarray([[row[t]] for row in feed], np.int32)
        _, caches = _jax_step(window)(jparams, toks, caches)
    np_caches = jax.tree.map(np.asarray, caches)
    cfg = ModelConfig(**BASE, window=window)
    return jmodel, caches, caches_from_jax(np_caches, cfg, "cpu")


@pytest.mark.parametrize("window,n_tokens", [(None, 5), (None, 9), (6, 4),
                                             (6, 9)])
def test_codec_pack_equals_reference_bit_for_bit(window, n_tokens):
    # window 6 after 9 tokens: the ring buffer has wrapped
    feed = np.random.default_rng(n_tokens).integers(0, 64, (2, n_tokens))
    jmodel, jcaches, caches = _filled_caches(window, feed.tolist())
    _, _, model, _ = _models(window)
    want_codec = jax_serving.KVRowCodec(jmodel, 16)
    codec = serving.KVRowCodec(model, 16)
    assert codec._specs == want_codec._specs
    assert (codec.seq_slots, codec.row_features, codec.row_shape) == \
        (want_codec.seq_slots, want_codec.row_features, want_codec.row_shape)
    n = codec.rows_for(n_tokens)
    assert n == want_codec.rows_for(n_tokens)
    for b in range(2):
        got = codec.pack(caches["states"], b, n)
        want = want_codec.pack(jcaches["states"], b, n)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_codec_feature_order_is_the_references():
    # k, slot_pos, v within a position (sorted keys), not the port's
    # insertion order k, v, slot_pos
    _, _, model, _ = _models()
    caches = model.init_caches(1, 16, "cpu")
    st = caches["states"]["pos0"]
    n_sb, _, hkv, _, hd = st["k"].shape
    st["k"].fill_(1.0)
    st["slot_pos"].fill_(2)
    st["v"].fill_(3.0)
    row = serving.KVRowCodec(model, 16).pack(caches["states"], 0, 1)[0]
    kv = n_sb * hkv * hd
    assert row.tolist() == [1.0] * kv + [2.0] * n_sb + [3.0] * kv


@pytest.mark.parametrize("window", [None, 6])
def test_codec_unpack_inverts_pack(window):
    feed = np.random.default_rng(3).integers(0, 64, (2, 9))
    _, _, caches = _filled_caches(window, feed.tolist())
    _, _, model, _ = _models(window)
    codec = serving.KVRowCodec(model, 16)
    n = codec.rows_for(9)
    rows = codec.pack(caches["states"], 0, n)
    fresh = model.init_caches(2, 16, "cpu")
    out = codec.unpack(fresh["states"], 1, rows)
    assert out is fresh["states"]                       # in place
    for key in ("k", "v", "slot_pos"):
        got = fresh["states"]["pos0"][key][:, 1]
        want = caches["states"]["pos0"][key][:, 0]
        assert torch.equal(got, want), key
        assert not fresh["states"]["pos0"][key][:, 0].ne(
            model.init_caches(2, 16, "cpu")["states"]["pos0"][key][:, 0]
        ).any()
    assert torch.equal(codec.pack(fresh["states"], 1, n), rows)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_codec_refuses_recurrent_state(arch):
    with pytest.raises(ValueError) as want:
        jax_serving.KVRowCodec(
            jax_build_model(jax_get_config(arch, smoke=True)), 16)
    with pytest.raises(ValueError) as got:
        serving.KVRowCodec(build_model(get_config(arch, smoke=True)), 16)
    assert str(got.value) == str(want.value)
    assert "seq_sp" in str(got.value)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # the golden case of tests/test_core_plan.py
    dict(dims=(4, 2), row=(16,), max_count=12, avg_count=6.0, n_prefill=3,
         migrations_per_tick=2.0, backend="ragged", variant="paper",
         round_order=(1, 0), links=True),
    # its tuned case
    dict(dims=(4, 2), row=(16,), max_count=8, n_prefill=3,
         migrations_per_tick=2.0, links=True),
    dict(dims=(2, 3), row=(4,), max_count=5, n_prefill=2,
         backend="sparse"),
    dict(dims=(2, 2), row=(4098,), max_count=112, n_prefill=2,
         migrations_per_tick=4.0, backend="factorized"),
]


def _kv_plan(mod, links, case):
    kw = dict(case)
    dims, row = kw.pop("dims"), kw.pop("row")
    if kw.pop("links", False):
        kw["links"] = links
    return mod.plan_kv_migration(dims, ("i", "j"), row, "float32", **kw)


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_describe_matches_reference(case):
    got = _kv_plan(plan, (ICI, DCN), PLAN_CASES[case])
    want = _kv_plan(jax_plan, (JAX_ICI, JAX_DCN), PLAN_CASES[case])
    assert got.describe() == want.describe()
    assert repr(got) == repr(want)
    assert got.kind == "kv_migrate"
    assert _kv_plan(plan, (ICI, DCN), PLAN_CASES[case]) is got
    assert got.describe()["cache"] == "hit"


def test_plan_registry_identity_and_inner_sharing():
    a = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), "float32",
                               max_count=5, n_prefill=2, backend="ragged")
    b = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), "float32",
                               max_count=5, n_prefill=2, backend="ragged")
    assert a is b and b.describe()["cache"] == "hit"
    assert isinstance(a.inner, plan.RaggedA2APlan)
    c = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), "float32",
                               max_count=5, n_prefill=4, backend="ragged")
    assert c is not a and c.inner is a.inner
    r = plan.plan_ragged_all_to_all((2, 3), ("i", "j"), (4,), "float32",
                                    max_count=5, backend="tuned")
    assert r is a.inner
    s = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), "float32",
                               max_count=5, n_prefill=2, backend="sparse")
    assert s.inner_kind == "sparse"
    assert isinstance(s.inner, plan.SparseA2APlan)
    # dropping a kv plan drops its inner plan unless another still owns it
    plan._drop_plan(c._registry_key)
    assert a.inner._registry_key in plan._PLANS
    plan._drop_plan(a._registry_key)
    assert a.inner._registry_key not in plan._PLANS


@pytest.mark.parametrize("pairs", [{(3, 4): 1}, {(0, 1): 1}, {(0, 3): 6},
                                   {(0, 3): -1}])
def test_pair_counts_raises_the_references_errors(pairs):
    args = ((2, 3), ("i", "j"), (4,), "float32")
    got = plan.plan_kv_migration(*args, max_count=5, n_prefill=2)
    want = jax_plan.plan_kv_migration(*args, max_count=5, n_prefill=2)
    with pytest.raises(ValueError) as w:
        want.pair_counts(pairs)
    with pytest.raises(ValueError) as g:
        got.pair_counts(pairs)
    assert str(g.value) == str(w.value)
    ok = {(0, 3): 2, (1, 5): 5}
    np.testing.assert_array_equal(got.pair_counts(ok), want.pair_counts(ok))


@pytest.mark.parametrize("kw,match", [
    (dict(n_prefill=0), "n_prefill"), (dict(n_prefill=4), "n_prefill"),
    (dict(n_prefill=2, migrations_per_tick=0.0), "migrations_per_tick")])
def test_plan_validation_matches_reference(kw, match):
    for mod in (plan, jax_plan):
        with pytest.raises(ValueError, match=match):
            mod.plan_kv_migration((2, 2), ("i", "j"), (4,), "float32",
                                  max_count=4, **kw)


@pytest.mark.parametrize("backend", ["ragged", "sparse", "factorized"])
@pytest.mark.parametrize("dims,n_prefill", [((2, 3), 2), ((2, 2, 2), 3)])
def test_exact_and_oracle_match_reference(dims, n_prefill, backend):
    rng = np.random.default_rng(sum(dims) + n_prefill)
    p = int(np.prod(dims))
    names = tuple("ijk"[:len(dims)])
    lengths = {(s, d): int(rng.integers(0, 5))
               for s in range(n_prefill) for d in range(n_prefill, p)
               if rng.random() < 0.6}
    kw = dict(max_count=4, n_prefill=n_prefill, backend=backend)
    got = plan.plan_kv_migration(dims, names, (3,), "float32", **kw)
    want = jax_plan.plan_kv_migration(dims, names, (3,), "float32", **kw)
    rows = [[rng.standard_normal((lengths.get((s, d), 0), 3))
             .astype(np.float32) for d in range(p)] for s in range(p)]
    g_recv, g_counts = got.exact(rows)
    w_recv, w_counts = want.exact(rows)
    assert np.asarray(g_counts).tolist() == np.asarray(w_counts).tolist()
    for r in range(p):
        for s in range(p):
            np.testing.assert_array_equal(g_recv[r][s], w_recv[r][s])
            np.testing.assert_array_equal(g_recv[r][s], rows[s][r])
    assert got.describe() == want.describe()
    g_oracle, g_vol = simulator.simulate_kv_migration(dims, n_prefill,
                                                      lengths)
    w_oracle, w_vol = jax_sim.simulate_kv_migration(dims, n_prefill,
                                                    lengths)
    assert g_oracle == w_oracle
    assert g_vol.elements_sent_per_round == w_vol.elements_sent_per_round
    for bad in ({(n_prefill, 0): 1}, {(0, 0): 1}, {(0, p - 1): -1}):
        with pytest.raises(ValueError) as w:
            jax_sim.simulate_kv_migration(dims, n_prefill, bad)
        with pytest.raises(ValueError) as g:
            simulator.simulate_kv_migration(dims, n_prefill, bad)
        assert str(g.value) == str(w.value)


def test_kv_migration_factory_notes_plan():
    c = comm.torus_comm((2, 3), ("i", "j"))
    p = c.kv_migration((4,), max_count=5, n_prefill=2)
    assert p.kind == "kv_migrate" and p.n_prefill == 2
    assert p._registry_key in c._plan_keys
    again = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), max_count=5,
                                   n_prefill=2)
    assert again is p
    c.free()
    fresh = plan.plan_kv_migration((2, 3), ("i", "j"), (4,), max_count=5,
                                   n_prefill=2)
    assert fresh is not p


# ---------------------------------------------------------------------------
# Scheduling (tests/test_serving.py's scripts on both packages)
# ---------------------------------------------------------------------------


def test_requeue_inflight_folds_generated_once():
    jmodel, jparams, model, params = _models()
    prompt, max_new = [1, 2, 3], 6
    jb = jax_serving.ContinuousBatcher(jmodel, jparams, max_batch=2,
                                       max_seq=MAX_SEQ,
                                       serve_step=_jax_step())
    jb.submit(jax_serving.Request(0, list(prompt), max_new))
    ref = jb.run()[0]
    b = serving.ContinuousBatcher(model, params, max_batch=2,
                                  max_seq=MAX_SEQ, device="cpu")
    b.submit(serving.Request(0, list(prompt), max_new))
    for _ in range(len(prompt) + 2):
        b.step()
    req = next(s for s in b.slots if s is not None)
    g = list(req.generated)
    assert len(g) == 3
    assert b.requeue_inflight() == 1
    assert b.queue[0].prompt == prompt + g and b.queue[0].folded == len(g)
    b.step()
    assert b.requeue_inflight() == 1
    assert b.queue[0].prompt == prompt + g and b.queue[0].folded == len(g)
    assert b.run()[0] == ref
    # rebuild() requeues and re-initialises the caches
    b2 = serving.ContinuousBatcher(model, params, max_batch=2,
                                   max_seq=MAX_SEQ, device="cpu")
    b2.submit(serving.Request(1, list(prompt), max_new))
    for _ in range(4):
        b2.step()
    assert b2.rebuild(params=params) == 1
    assert b2.run()[1] == ref


def test_admission_round_robin_fifo_and_quota():
    got, want = [], []
    for mod, log in ((serving, got), (jax_serving, want)):
        a = mod.AdmissionController(quotas={"A": 2})
        for i in range(4):
            a.submit(mod.Request(i, [1], 1, tenant="A"))
        for i in range(3):
            a.submit(mod.Request(10 + i, [1], 1, tenant="B"))
        log.append([r.rid for r in a.admit(4)])
        log.append([r.rid for r in a.admit(4)])
        a.release(mod.Request(0, [1], 1, tenant="A"))
        log.append([r.rid for r in a.admit(4)])
        log.append(a.pending)
        a.requeue_front([mod.Request(99, [1], 1, tenant="A")])
        log.append([r.rid for r in a.queues["A"]])
    assert got == want == [[0, 10, 1, 11], [12], [2], 1, [99, 3]]


def _fairness_run(mod, model, params, dims_comm, **kw):
    srv = mod.DisaggregatedServer(model, params, dims_comm, max_seq=MAX_SEQ,
                                  decode_batch=2, prefill_batch=2,
                                  n_prefill=2, default_quota=1, **kw)
    for i in range(3):
        srv.submit(mod.Request(i, [1 + i, 2 + i], 3, tenant="A"))
        srv.submit(mod.Request(10 + i, [5 + i], 3, tenant="B"))
    order, inflight = [], []
    while srv.tick():
        inflight.append(dict(srv.admission.inflight))
        assert (srv._decode_pending() if mod is serving
                else srv.batcher.pending) + len(srv.staged) \
            + sum(w.active for w in srv.workers) <= 2
        order.extend(r for r in srv.done if r not in order)
    return srv, order, inflight


def test_tenant_fairness_under_full_decode_batch():
    jmodel, jparams, model, params = _models()
    want, w_order, w_inflight = _fairness_run(
        jax_serving, jmodel, jparams, jax_torus_comm((2, 2), ("x", "y")),
        serve_step=_jax_step())
    got, order, inflight = _fairness_run(
        serving, model, params, comm.torus_comm((2, 2), ("x", "y")),
        device="cpu")
    assert all(v <= 1 for d in inflight for v in d.values())
    assert got.done == want.done and len(got.done) == 6
    assert order == w_order and inflight == w_inflight
    assert any(r < 10 for r in order[:3]) and any(r >= 10 for r in order[:3])
    assert got.ticks == want.ticks


def test_batcher_stats_surface_a2a_comm_stats():
    _, _, model, params = _models()
    b = serving.ContinuousBatcher(model, params, max_batch=2,
                                  max_seq=MAX_SEQ, device="cpu")
    b.submit(serving.Request(0, [1, 2], 2))
    b.run()
    st = b.stats()
    assert st["done"] == 1 and st["ticks"] == b.ticks
    assert "plans" in st["a2a_comm_stats"]
    c = comm.torus_comm((1, 2), ("x", "y"))
    bc = serving.ContinuousBatcher(model, params, max_batch=2,
                                   max_seq=MAX_SEQ, device="cpu", comm=c)
    assert bc.stats()["a2a_comm_stats"]["comm"]["axes"] == ["x", "y"]
    c.free()


# ---------------------------------------------------------------------------
# The server on a dims-tuple comm (one process, the exact host path)
# ---------------------------------------------------------------------------


def _port_server(window, script, dims, rebuild=None, **kw):
    _, _, model, params = _models(window)
    c = comm.torus_comm(dims, tuple(f"s{i}" for i in range(len(dims))))
    srv = serving.DisaggregatedServer(model, params, c, max_seq=MAX_SEQ,
                                      device="cpu", **kw)
    for req in requests(serving, script):
        srv.submit(req)
    if rebuild is not None:
        for _ in range(rebuild[0]):
            srv.tick()
        assert srv.rebuild(rebuild[1], n_prefill=rebuild[2]) > 0
    srv.run()
    return srv


def _colocated(window, script):
    jmodel, jparams, _, _ = _models(window)
    b = jax_serving.ContinuousBatcher(jmodel, jparams, max_batch=2,
                                      max_seq=MAX_SEQ,
                                      serve_step=_jax_step(window))
    for req in requests(jax_serving, script, tenants=False):
        b.submit(req)
    return b.run()


def _same_schedule(got, want):
    assert got.done == want.done
    assert (got.ticks, got.topology.migrations,
            got.topology.migrated_rows) == \
        (want.ticks, want.topology.migrations, want.topology.migrated_rows)
    assert got.stats()["topology"] == want.stats()["topology"]


@pytest.mark.parametrize("dims,n_prefill", [((2, 2), None), ((2, 2), 3),
                                            ((2, 3), None), ((2, 3), 1)])
@pytest.mark.parametrize("window", [None, 6])
def test_disaggregated_matches_reference(window, dims, n_prefill):
    kw = dict(decode_batch=2, n_prefill=n_prefill)
    got = _port_server(window, "five", dims, **kw)
    want = _reference(window, "five", dims, **kw)
    _same_schedule(got, want)
    assert got.done == _colocated(window, "five")
    assert got.topology.migrations > 0 and got.topology.migrated_rows > 0
    assert got.stats()["topology"]["plan"]["kind"] == "kv_migrate"


def test_disaggregated_rebuild_drops_nothing():
    kw = dict(decode_batch=2)
    got = _port_server(None, "six", (2, 3), rebuild=(6, 4, None), **kw)
    want = _reference(None, "six", (2, 3), rebuild=(6, 4, None), **kw)
    _same_schedule(got, want)
    assert set(got.done) == set(range(6))
    assert got.done == _colocated(None, "six")
    assert got.stats()["topology"]["comm"]["rebuilt_from"]["p"] == 6


def test_rebuild_folds_staged_first_tokens():
    # one prefill rank, two decode ranks: three prompts complete in the
    # first tick and the third's round-robin destination repeats the
    # first's (src, dst) pair, so it stays staged; a rebuild right then
    # must replay it without generating its first token a second time
    # (the reference replays staged entries unfolded)
    _, _, model, params = _models()
    srv = serving.DisaggregatedServer(
        model, params, comm.torus_comm((1, 3), ("s0", "s1")),
        max_seq=MAX_SEQ, decode_batch=3, prefill_batch=4, n_prefill=1,
        chunk=8, device="cpu")
    for req in requests(serving, "five"):
        srv.submit(req)
    srv.tick()
    assert len(srv.staged) == 1 and srv.staged[0][1].generated
    assert srv.rebuild(2, n_prefill=1) > 0
    assert srv.run() == _colocated(None, "five")


def test_server_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, model, params = _models()
    with pytest.raises(RuntimeError, match="cuda"):
        serving.DisaggregatedServer(model, params,
                                    comm.torus_comm((2, 2), ("x", "y")),
                                    max_seq=MAX_SEQ, decode_batch=2)


# ---------------------------------------------------------------------------
# The server on mesh-backed comms (gloo worlds)
# ---------------------------------------------------------------------------

WORLDS = {
    4: {f"np{npf}-{backend}": dict(dims=(2, 2), names=("x", "y"),
                                   n_prefill=npf, backend=backend,
                                   decode_batch=2, script="five")
        for npf in (2, 3) for backend in ("ragged", "sparse", "factorized")},
    6: {"split": dict(dims=(2, 3), names=("x", "y"), n_prefill=None,
                      backend="tuned", decode_batch=2, script="six",
                      window=6),
        "rebuild": dict(dims=(2, 3), names=("x", "y"), n_prefill=None,
                        backend="tuned", decode_batch=2, script="six",
                        rebuild=(6, [0, 1, 2, 3], None))},
}
_RESULTS: dict = {}


def _world(n, tmp_path_factory):
    if n not in _RESULTS:
        params = {w: as_numpy(_models(w)[1]) for w in (None, 6)}
        _RESULTS[n] = run_world(world_cases, n,
                                tmp_path_factory.mktemp("serving"),
                                WORLDS[n], params, timeout=240.0)
    return _RESULTS[n]


@pytest.mark.parametrize("n,name", [(n, name) for n in sorted(WORLDS)
                                    for name in WORLDS[n]])
def test_mesh_server_matches_reference(n, name, tmp_path_factory):
    case = WORLDS[n][name]
    results = [r[name] for r in _world(n, tmp_path_factory)]
    kw = dict(decode_batch=case["decode_batch"],
              n_prefill=case["n_prefill"], backend=case["backend"])
    rebuild = case.get("rebuild")
    if rebuild is not None:
        kw["rebuild"] = (rebuild[0], len(rebuild[1]), rebuild[2])
    want = _reference(case.get("window"), case["script"], case["dims"], **kw)
    survivors = range(n) if rebuild is None else rebuild[1]
    for rank, r in enumerate(results):
        assert r["lost"] == (rank not in survivors)
        if rank in survivors:
            assert r["done"] == want.done, f"rank {rank}"
            assert r["kind"] == "kv_migrate"
            assert r["migrations"] > 0
    assert want.done == _colocated(case.get("window"), case["script"])
    live = [results[r] for r in survivors]
    assert all(r == live[0] for r in live)          # every decision alike
    if rebuild is None:
        assert live[0]["inner_kind"] == want.topology.plan.inner_kind
    else:
        assert live[0]["requeued"] > 0
    if want.topology.n_decode == 1:
        assert live[0]["n_decode"] == 1
        assert (live[0]["ticks"], live[0]["migrations"],
                live[0]["migrated_rows"]) == \
            (want.ticks, want.topology.migrations,
             want.topology.migrated_rows)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_serve_main_disaggregated_gives_colocated_tokens():
    args = ["--arch", "phi3.5-moe-42b", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "5", "--gen", "4"]
    colocated = serve.main(args)
    for extra in ([], ["--torus-p", "4", "--n-prefill", "3"]):
        out = serve.main(args + ["--disaggregate"] + extra)
        assert torch.equal(out, colocated)
