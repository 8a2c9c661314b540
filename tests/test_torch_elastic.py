"""The port's elastic path (repro_torch) against the JAX reference:
``TorusComm.rebuild`` / ``partition``, the elastic ``Trainer`` (retry,
recover after a hang or a device loss, abort) and its recovery onto the
survivors of a 4-rank gloo world.

* Rebuild and partition, in process on dims-tuple comms (no world): the
  cases of ``tests/test_elastic.py::TestRebuild``, each against the JAX
  package's ``rebuild`` on the same case (dims, axis names,
  ``rebuilt_from``, ``describe()``, the error messages), with the
  registry invariants (own plan slice freed, a co-resident comm's plan
  kept as the same object, the registry balanced after ``free``); and
  ``partition`` for several ``n_first`` and ``d``.
* The elastic loop in one process under scripted step times: each
  package's trainer module gets a ``StepTimer`` that reports the script
  and a clock that advances by it (and by every backoff asked for), so no
  test depends on how fast the box is.  A stub train step (``w += x``)
  and a stub data stream run in both; the action sequences, backoffs,
  watchdog events, logged steps, the checkpoint before ``FaultError`` and
  the final state must match, and ``train_step`` runs once per committed
  step.
* A 4-rank gloo world on the EP tests' model (2-layer MoE, d 32, 4
  experts, f32, mesh ``(model=1, data=2, pod=2)``), in order: (i) a hang
  at step 7 of scripted step times recovers (a synchronous checkpoint on
  the 4 ranks, ``rebuild_fn`` re-factorizing the same ranks at d = 1, a
  restore of the live state); (ii) one loss and backward under the
  ``collectives`` remat policy issues exactly each MoE layer's forward
  and reverse exchange fewer than under ``nothing`` (counted by a
  zero-delay ``slow`` FaultInjector on the plan), with bit-equal
  gradients; (iii) a ``device_loss`` of ranks 2 and 3 at step 5 of 6
  (checkpoint every 3): ranks 2 and 3 leave, the survivors rebuild their
  mesh (``launch.mesh.survivor_mesh``) and finish; the step-3
  checkpoint, written on 4 ranks, restores onto the 2 survivors and onto
  one process to the same global arrays, bit for bit.  Their final
  parameters equal, bit for bit, the port's direct restore of the step-3
  checkpoint onto the survivor mesh followed by the same 3 steps, and
  match within 2e-4 per leaf (the EP tests' tolerance) the reference's
  ``Trainer(elastic=True)`` in process on one device with the same
  weights, batches and fault schedule (its ``rebuild_fn`` returns None);
  ``inj.fired``, ``recoveries_done``, the watchdog event kinds and the
  logged steps match too.
"""

import types

import numpy as np
import pytest
import torch

from torch_dist import run_world

STEP_S = 0.1                       # a scripted ordinary step
GB, SEQ, LR = 8, 16, 1e-3
MESH = ((1, 2, 2), ("model", "data", "pod"))       # fastest digit first
LOST = (2, 3)


# ---------------------------------------------------------------------------
# rebuild / partition, in process
# ---------------------------------------------------------------------------

@pytest.fixture
def registries():
    from repro.core.cache import free_all as jax_free_all
    from repro.core.comm import free_comms as jax_free_comms
    from repro.core.plan import free_plans as jax_free_plans
    from repro_torch.core.cache import free_all
    from repro_torch.core.comm import free_comms
    from repro_torch.core.plan import free_plans

    def clear():
        for fn in (free_comms, free_plans, free_all, jax_free_comms,
                   jax_free_plans, jax_free_all):
            fn()
    clear()
    yield
    clear()


def _both(dims, names):
    from repro.core.comm import torus_comm as jax_torus_comm
    from repro_torch.core.comm import torus_comm
    return jax_torus_comm(dims, names), torus_comm(dims, names)


@pytest.mark.parametrize("dims,surviving,d", [((4, 2), 6, None),
                                              ((4, 2), 8, 3),
                                              ((2, 3), 4, None)],
                         ids=["8to6", "8to8-d3", "6to4"])
def test_rebuild_matches_reference(registries, dims, surviving, d):
    ref, port = _both(dims, ("i", "j"))
    want, got = ref.rebuild(surviving, d=d), port.rebuild(surviving, d=d)
    assert (got.dims, got.axis_names, got.p) == (want.dims, want.axis_names,
                                                 want.p)
    assert got.rebuilt_from == want.rebuilt_from
    assert got.describe() == want.describe()
    assert port._freed and not got._freed


@pytest.mark.parametrize("surviving,match", [(0, "no surviving"),
                                             (8, "changed device set")])
def test_rebuild_rejections_match_reference(registries, surviving, match):
    ref, port = _both((4, 2), ("i", "j"))
    with pytest.raises(ValueError, match=match) as want:
        ref.rebuild(surviving)
    with pytest.raises(ValueError, match=match) as got:
        port.rebuild(surviving)
    assert str(got.value) == str(want.value)


def test_rebuild_frees_its_own_plan_slice_only(registries):
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.plan import plan_cache_stats
    comm = torus_comm((4, 2), ("i", "j"))
    comm.all_to_all((4,), "float32", backend="direct")
    comm.all_to_all((8,), "float32", backend="factorized")
    other = torus_comm((3,), ("k",))
    kept = other.all_to_all((4,), "float32", backend="direct")
    assert plan_cache_stats()["size"] == 3
    fresh = comm.rebuild(6)
    assert plan_cache_stats()["size"] == 1
    assert other.all_to_all((4,), "float32", backend="direct") is kept
    fresh.all_to_all((4,), "float32", backend="direct")
    assert plan_cache_stats()["size"] == 2
    assert fresh.describe()["tuning_migrated"] == 0


def test_rebuild_registry_stays_balanced(registries):
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.plan import plan_cache_stats
    comm = torus_comm((2, 3), ("i", "j"))
    comm.all_to_all((4,), "float32", backend="direct")
    fresh = comm.rebuild(4)
    fresh.all_to_all((4,), "float32", backend="direct")
    fresh.free()
    assert plan_cache_stats()["size"] == 0
    assert torus_comm((2, 3), ("i", "j")) is not comm
    assert torus_comm((2, 2), ("i", "j")) is not fresh


@pytest.mark.parametrize("dims,n_first,d", [((3, 2), 1, None),
                                            ((3, 2), 2, 1),
                                            ((3, 2), 3, 2),
                                            ((2, 2, 2), 3, None),
                                            ((2, 2, 2), 6, 3)],
                         ids=["6-1", "6-2-d1", "6-3-d2", "8-3", "8-6-d3"])
def test_partition_matches_reference(registries, dims, n_first, d):
    names = tuple("abc"[:len(dims)])
    ref, port = _both(dims, names)
    want, got = ref.partition(n_first, d=d), port.partition(n_first, d=d)
    assert [c.describe() for c in got] == [c.describe() for c in want]
    assert port.partition(n_first, d=d) == got          # cached on the comm
    port.free()
    assert all(c._freed for c in got)


def test_partition_rejections_match_reference(registries):
    ref, port = _both((3, 2), ("a", "b"))
    for args, kw in (((0,), {}), ((6,), {}),
                     ((2,), {"prefixes": ("x", "x")})):
        with pytest.raises(ValueError) as want:
            ref.partition(*args, **kw)
        with pytest.raises(ValueError) as got:
            port.partition(*args, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the elastic loop in one process, scripted step times
# ---------------------------------------------------------------------------

class _Script:
    """A clock and step times from a script: ``timer()`` is a StepTimer
    whose step takes the next scripted time (the clock advances by it),
    ``sleep`` records the backoff and advances the clock."""

    def __init__(self, times):
        self.times, self.i, self.now, self.sleeps = list(times), 0, 100.0, []
        script = self

        class Timer:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.seconds = script.times[min(script.i,
                                                len(script.times) - 1)]
                script.i += 1
                script.now += self.seconds
                return False
        self.timer = Timer
        self.time = types.SimpleNamespace(
            monotonic=lambda: self.now, time=lambda: 0.0, sleep=self.sleep)

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


class _Counter:
    """Stub data: batch ``x`` = the step number, a resumable cursor."""

    def __init__(self, to):
        self.step, self.to = 0, to

    def next(self):
        self.step += 1
        return {"x": self.to(np.full(3, self.step, np.float32))}

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])


def _run_elastic(pkg, tmp, times, *, total, watchdog=None, fault_at=None,
                 ckpt_every=100):
    """One package's elastic run on the stub step; returns what the two
    packages must agree on."""
    import importlib
    trainer_mod = importlib.import_module(f"{pkg}.runtime.trainer")
    watchdog_mod = importlib.import_module(f"{pkg}.runtime.watchdog")
    faults = importlib.import_module(f"{pkg}.core.faults")
    if pkg == "repro":
        import jax.numpy as jnp
        to = jnp.asarray
    else:
        to = torch.from_numpy
    script = _Script(times)
    calls, rebuilds = [], []

    def step(params, opt, batch):
        calls.append(int(opt["n"]) + 1)
        w = params["w"] + batch["x"]
        return {"w": w}, {"n": opt["n"] + 1}, {"total_loss": w.sum()}

    def rebuild_fn(trainer, err):
        rebuilds.append((trainer.step, None if err is None
                         else tuple(err.devices)))
        return None

    inj = faults.FaultInjector((faults.FaultSpec(
        "device_loss", at_call=fault_at, devices=LOST),))
    tr = trainer_mod.Trainer(
        trainer_mod.TrainerConfig(total_steps=total, checkpoint_dir=str(tmp),
                                  checkpoint_every=ckpt_every, log_every=1,
                                  async_checkpoint=False, elastic=True),
        inj.wrap(step, "train_step") if fault_at else step,
        _Counter(to), {"w": to(np.zeros(3, np.float32))},
        {"n": to(np.zeros((), np.int32))},
        watchdog=watchdog or watchdog_mod.StragglerWatchdog(),
        rebuild_fn=rebuild_fn)
    patches = [(trainer_mod, "StepTimer", script.timer),
               (trainer_mod, "time", script.time),
               (watchdog_mod, "time", script.time)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    for m, k, v in patches:
        setattr(m, k, v)
    try:
        try:
            status = tr.run()
        except faults.FaultError as e:
            status = f"FaultError: {e}"
    finally:
        for m, k, v in saved:
            setattr(m, k, v)
    return {"status": status, "step": tr.step, "calls": calls,
            "rebuilds": rebuilds, "sleeps": script.sleeps,
            "transitions": list(tr.watchdog.escalation.transitions),
            "events": [e[:2] for e in tr.watchdog.events],
            "logged": [(r["step"], r["verdict"]) for r in tr.metrics_log],
            "recoveries": tr.recoveries_done, "fired": inj.fired,
            "latest": tr.ckpt.latest(),
            "w": np.array(tr.params["w"].tolist(), np.float32)}


def _watchdogs(**escalation):
    from repro.runtime.watchdog import EscalationPolicy as JaxEscalation
    from repro.runtime.watchdog import StragglerWatchdog as JaxWatchdog
    from repro_torch.runtime.watchdog import (EscalationPolicy,
                                              StragglerWatchdog)
    return (JaxWatchdog(escalation=JaxEscalation(**escalation)),
            StragglerWatchdog(escalation=EscalationPolicy(**escalation)))


SCENARIOS = {
    # two stragglers retried with backoff, then an ordinary step
    "retry": dict(times=[STEP_S] * 6 + [0.3, 0.3] + [STEP_S] * 2, total=10),
    # a third straggler in a row escalates to a hang: recover
    "straggler-recover": dict(times=[STEP_S] * 6 + [0.3] * 3 + [STEP_S],
                              total=10),
    # a hang recovers (checkpoint now, rebuild, restore) and goes on
    "hang-recover": dict(times=[STEP_S] * 6 + [50.0] + [STEP_S] * 2,
                         total=9),
    # a hang with no recovery budget aborts after a checkpoint
    "abort-budget": dict(times=[STEP_S] * 6 + [50.0], total=9,
                         escalation={"max_recoveries": 0}),
    # stragglers past the incident timeout abort
    "abort-timeout": dict(times=[STEP_S] * 6 + [0.3] * 3, total=9,
                          escalation={"max_retries": 5,
                                      "incident_timeout": 0.5}),
    # a device loss at step 5 restores the step-3 checkpoint
    "device-loss": dict(times=[STEP_S] * 8, total=6, fault_at=5,
                        ckpt_every=3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_loop_matches_reference(tmp_path, name):
    kw = dict(SCENARIOS[name])
    escalation = kw.pop("escalation", None)
    dogs = _watchdogs(**escalation) if escalation else (None, None)
    want = _run_elastic("repro", tmp_path / "ref", watchdog=dogs[0], **kw)
    got = _run_elastic("repro_torch", tmp_path / "port", watchdog=dogs[1],
                       **kw)
    w_want, w_got = want.pop("w"), got.pop("w")
    assert got == want
    np.testing.assert_array_equal(w_got, w_want)
    # a retry never re-runs a step: one call per committed step, and a
    # device loss's rolled-back steps run again after the restore
    committed = [s for s, _ in got["logged"]]
    if name == "device-loss":
        assert got["calls"] == [1, 2, 3, 4, 4, 5, 6]
        assert got["rebuilds"] == [(4, LOST)] and got["latest"] == 6
    elif name.startswith("abort"):
        assert got["status"].startswith("FaultError: watchdog abort")
        assert got["latest"] == got["step"] == got["calls"][-1]
    else:
        assert got["calls"] == list(range(1, kw["total"] + 1))
    if name == "retry":
        assert got["sleeps"] == [0.05, 0.1] and got["recoveries"] == 0
        assert committed == list(range(1, 11))
    if name.endswith("recover"):
        assert got["recoveries"] == 1 and got["rebuilds"][0][1] is None


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------

def _cfg(module, policy="nothing"):
    return module.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=4, top_k=2,
        capacity_factor=8.0, param_dtype="float32", compute_dtype="float32",
        a2a_backend="factorized", remat=True, remat_policy=policy)


def _dcfg():
    from repro_torch.data import CopyTaskConfig
    return CopyTaskConfig(vocab=100, seq_len=SEQ, global_batch=GB)


def _fixed_timer(times):
    it = iter(times)

    class Timer:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.seconds = next(it, STEP_S)
            return False
    return Timer


def _flat(tree):
    from repro_torch.models.common import tree_leaves
    return {p: t.detach().numpy().copy() for p, t in tree_leaves(tree)}


def _trainer(mesh, jparams, tmp, total, every, policy="nothing"):
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, config, make_train_step
    from repro_torch.models.common import param_shardings, tree_map
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = _cfg(config, policy)
    model = build_model(cfg)
    opt = AdamW(AdamWConfig(lr=LR))
    params = params_from_jax(jparams, cfg, "cpu", mesh=mesh)
    tree_map(lambda t: t.requires_grad_(True), params)
    return Trainer(
        TrainerConfig(total_steps=total, checkpoint_dir=str(tmp),
                      checkpoint_every=every, log_every=1,
                      async_checkpoint=False, elastic=True),
        make_train_step(model, opt, mesh),
        SyntheticLM(_dcfg(), mesh=mesh, task="copy", device="cpu"),
        params, opt.init(params),
        sharding=param_shardings(model.specs(), mesh))


def _hang_recover(mesh, jparams, tmp):
    """(i): a scripted hang at step 7 recovers onto the same ranks."""
    from repro_torch.parallel.sharding import ep_comm
    from repro_torch.runtime import trainer as trainer_mod
    tr = _trainer(mesh, jparams, tmp, total=7, every=100)
    seen = {}

    def rebuild_fn(trainer, err):
        fresh = ep_comm(mesh).rebuild(mesh.mesh.flatten().tolist(), d=1)
        seen.update(err=err, dims=fresh.dims, live=_flat(trainer._state_tree()),
                    latest=trainer.ckpt.latest())
        return trainer.sharding
    tr.rebuild_fn = rebuild_fn
    trainer_mod.StepTimer = _fixed_timer([STEP_S] * 6 + [50.0])
    status = tr.run()
    same = all(np.array_equal(seen["live"][p], v)
               for p, v in _flat(tr._state_tree()).items())
    return {"status": status, "step": tr.step, "err": seen["err"],
            "dims": seen["dims"], "latest": seen["latest"], "same": same,
            "recoveries": tr.recoveries_done,
            "events": [e[0] for e in tr.watchdog.events]}


def _exchanges(mesh, jparams):
    """(ii): the MoE plan calls of one loss + backward per policy, and
    the gradients."""
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, config, make_loss_fn
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.convert import params_from_jax
    out = {}
    batch = SyntheticLM(_dcfg(), mesh=mesh, task="copy", device="cpu").next()
    for policy in ("nothing", "collectives"):
        cfg = _cfg(config, policy)
        model = build_model(cfg)
        params = params_from_jax(jparams, cfg, "cpu", mesh=mesh)
        tree_map(lambda t: t.requires_grad_(True), params)
        axes, G, E_loc, _ = moe._group_geometry(cfg, mesh)
        C = moe._capacity(cfg, batch["tokens"].numel(),
                          max(cfg.n_experts, G))
        plan = moe.moe_a2a_plan(cfg, mesh, axes, E_loc, C)
        inj = FaultInjector((FaultSpec("slow", every=1,
                                       delay_seconds=0.0),))
        inj.install(plan)
        leaves = tree_leaves(params)
        total, _ = make_loss_fn(model, mesh)(params, batch)
        forward = inj.calls.get("a2a", 0)
        grads = torch.autograd.grad(total, [t for _, t in leaves])
        inj.uninstall(plan)
        out[policy] = {"forward": forward, "total": inj.calls["a2a"],
                       "grads": [g.numpy() for g in grads]}
    return out


def _device_loss(rank, mesh, jparams, tmp):
    """(iii): device loss of ranks 2, 3 at step 5 of 6; the survivors'
    result and the direct-restore check."""
    from repro_torch.core.cache import cart_create
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import survivor_mesh
    from repro_torch.models import build_model, config, make_train_step
    from repro_torch.models.common import param_shardings, tree_map
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import trainer as trainer_mod
    trainer_mod.StepTimer = _fixed_timer([])
    tr = _trainer(mesh, jparams, tmp, total=6, every=3)
    inj = FaultInjector((FaultSpec("device_loss", at_call=5, devices=LOST),))
    tr.train_step = inj.wrap(tr.train_step, "train_step")
    cfg = _cfg(config)
    built = {}

    def rebuild_fn(trainer, err):
        mesh_b = survivor_mesh(mesh, err.devices)
        model = build_model(cfg)
        trainer.train_step = make_train_step(model, AdamW(AdamWConfig(lr=LR)),
                                             mesh_b)
        trainer.data = SyntheticLM(_dcfg(), mesh=mesh_b, task="copy",
                                   device="cpu")
        built.update(mesh=mesh_b, step=trainer.train_step)
        return param_shardings(model.specs(), mesh_b)

    tr.rebuild_fn = rebuild_fn
    status = tr.run()
    if status == "lost":
        # a lost rank takes no part in the survivors' mesh: it is refused
        # before any group is created
        try:
            cart_create([r for r in range(4) if r not in LOST], (2,),
                        ("s",), device_type="cpu")
            refused = False
        except ValueError:
            refused = True
        return {"status": status, "step": tr.step, "refused": refused}
    # the direct restore of the step-3 checkpoint onto the survivor mesh,
    # then the same 3 steps
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.models.common import tree_leaves
    mesh_b = built["mesh"]
    sh = tr.sharding
    mgr = CheckpointManager(tmp, sharding=tr._state_sharding())
    tree, extra, _ = mgr.restore(tr._state_tree(), step=3)
    # the 4-rank checkpoint restored onto the 2 survivors (gathered) and
    # onto one process: the same global arrays, bit for bit
    glob = tr._state_sharding().gather_tree(tree)
    whole, _, _ = restore_checkpoint(tmp, 3, glob)
    onto_2_and_1 = all(np.array_equal(a.numpy(), b.numpy()) for (_, a), (_, b)
                       in zip(tree_leaves(glob), tree_leaves(whole)))
    params, opt_state = tree["params"], tree["opt_state"]
    tree_map(lambda t: t.requires_grad_(True), params)
    data = SyntheticLM(_dcfg(), mesh=mesh_b, task="copy", device="cpu")
    data.load_state_dict(extra["data"])
    for _ in range(3):
        params, opt_state, _ = built["step"](params, opt_state, data.next())
    live = _flat(tr._state_tree())
    direct = _flat({"params": params, "opt_state": opt_state})
    out = {"status": status, "step": tr.step, "fired": inj.fired,
           "recoveries": tr.recoveries_done,
           "events": [e[0] for e in tr.watchdog.events],
           "logged": [r["step"] for r in tr.metrics_log],
           "mesh": [int(r) for r in mesh_b.mesh.flatten().tolist()],
           "direct_equal": all(np.array_equal(live[p], direct[p])
                               for p in live),
           "onto_2_and_1": onto_2_and_1,
           "writer": sh.writer}
    glob = _flat(sh.gather_tree(tr.params))
    if rank == 0:
        out["params"] = glob
    return out


def _ranks(rank, n, jparams, tmp):
    from pathlib import Path
    from repro_torch.core.cache import cart_create
    mesh = cart_create(n, *MESH, device_type="cpu")
    tmp = Path(tmp)
    return {"hang": _hang_recover(mesh, jparams, tmp / "hang"),
            "exchanges": _exchanges(mesh, jparams),
            "loss": _device_loss(rank, mesh, jparams, tmp / "loss")}


class _NumpyData:
    """The port's global copy-task batches for the reference's trainer."""

    def __init__(self):
        self.step = 0

    def next(self):
        import jax.numpy as jnp
        from repro_torch.data import make_copy_task_batch
        b = make_copy_task_batch(_dcfg(), self.step, "cpu")
        self.step += 1
        return {k: jnp.asarray(v.numpy()) for k, v in b.items()}

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])


def _reference_run(jparams, tmp, monkeypatch):
    """The reference's elastic Trainer in process on one device: the same
    weights, batches and fault schedule; its rebuild_fn returns None."""
    import jax
    from repro import models as jax_models
    from repro.core.faults import FaultInjector, FaultSpec
    from repro.optim import AdamW, AdamWConfig
    from repro.runtime import trainer as jax_trainer
    monkeypatch.setattr(jax_trainer, "StepTimer", _fixed_timer([]))
    cfg = _cfg(jax_models.config).replace(attention_impl="xla")
    opt = AdamW(AdamWConfig(lr=LR))
    step = jax.jit(jax_models.make_train_step(jax_models.build_model(cfg),
                                              opt))
    inj = FaultInjector((FaultSpec("device_loss", at_call=5, devices=LOST),))
    tr = jax_trainer.Trainer(
        jax_trainer.TrainerConfig(total_steps=6, checkpoint_dir=str(tmp),
                                  checkpoint_every=3, log_every=1,
                                  async_checkpoint=False, elastic=True),
        inj.wrap(step, "train_step"), _NumpyData(), jparams,
        opt.init(jparams), rebuild_fn=lambda trainer, err: None)
    assert tr.run() == "done"
    from repro_torch.models.common import tree_leaves
    return tr, inj, dict(tree_leaves(jax.tree.map(np.asarray, tr.params)))


def test_elastic_trainer_on_a_gloo_world(tmp_path, monkeypatch):
    import jax
    from repro import models as jax_models
    jparams = jax_models.build_model(_cfg(jax_models.config)).init(
        jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    results = run_world(_ranks, 4, tmp_path, host, str(tmp_path),
                        timeout=240)

    # (i) hang -> recover on the same ranks
    for r in results:
        h = r["hang"]
        assert h["status"] == "done" and h["step"] == 7, h
        assert h["err"] is None and h["dims"] == (4,) and h["latest"] == 7
        assert h["same"] and h["recoveries"] == 1
        assert h["events"] == ["hang", "action:recover"]

    # (ii) collectives: each layer's forward and reverse exchange fewer
    for r in results:
        ex = r["exchanges"]
        n_layers = 2
        assert ex["nothing"]["forward"] == ex["collectives"]["forward"] \
            == 2 * n_layers
        assert ex["nothing"]["total"] == 4 * n_layers
        assert ex["nothing"]["total"] - ex["collectives"]["total"] \
            == 2 * n_layers
        for a, b in zip(ex["nothing"]["grads"], ex["collectives"]["grads"]):
            np.testing.assert_array_equal(a, b)

    # (iii) device loss: ranks 2, 3 leave, the survivors finish
    assert [r["loss"]["status"] for r in results] == \
        ["done", "done", "lost", "lost"]
    assert [r["loss"]["step"] for r in results[2:]] == [4, 4]
    assert all(r["loss"]["refused"] for r in results[2:])
    tr, inj, want = _reference_run(jparams, tmp_path / "ref", monkeypatch)
    ref_events = [e[0] for e in tr.watchdog.events]
    for r in results[:2]:
        got = r["loss"]
        assert got["step"] == 6 and got["mesh"] == [0, 1]
        assert got["direct_equal"] and got["onto_2_and_1"]
        assert got["fired"] == inj.fired == [("device_loss", "train_step",
                                              5)]
        assert got["recoveries"] == tr.recoveries_done == 1
        assert got["events"] == ref_events
        assert "device_loss" in ref_events and "action:recover" in ref_events
        assert got["logged"] == [row["step"] for row in tr.metrics_log]
    assert [r["loss"]["writer"] for r in results[:2]] == [True, False]
    got = results[0]["loss"]["params"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=2e-4, atol=2e-4,
                                   err_msg=p)
