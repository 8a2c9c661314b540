"""The port's fault injector (repro_torch.core.faults) and the persistence
faults it produces, against the JAX package's.

The reference's cases (tests/test_elastic.py: the injector, tuning-record
migration, the tuning DB's lock timeout and corruption, the checkpoint's
fall back to the next newest) run on the port, the checkpoint ones on
the port's store.  ``FaultInjector`` with the same specs, seed and call
sequence fires the same faults as the reference's; ``install`` shadows a
plan's execution methods (the port's plans have no ``host_fn``) and
``uninstall`` restores them.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro_torch.checkpoint.store import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.core import faults, telemetry
from repro_torch.core.autotune import (
    TuningDB,
    fingerprint_digest,
    migrate_records,
    plan_db_key,
)
from repro_torch.core.faults import (
    DeviceLossError,
    FaultInjector,
    FaultSpec,
    corrupt_checkpoint_leaf,
    corrupt_tuning_db,
    hold_tuning_db_lock,
)
from repro_torch.core.plan import (free_plans, plan_all_to_all,
                                   plan_ragged_all_to_all)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(tmp_path / "db.json"))
    free_plans()
    telemetry.reset_telemetry()
    yield
    free_plans()
    telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

class TestFaultInjector:
    def test_at_call_device_loss(self):
        inj = FaultInjector((FaultSpec("device_loss", at_call=3,
                                       devices=(8, 9)),))
        inj.check()
        inj.check()
        with pytest.raises(DeviceLossError) as ei:
            inj.check()
        assert ei.value.devices == (8, 9)
        assert inj.fired == [("device_loss", "a2a", 3)]
        inj.check()                     # call 4: fires no more

    def test_every_and_label_filtering(self):
        inj = FaultInjector((FaultSpec("slow", every=2,
                                       delay_seconds=0.0, label="x"),))
        for _ in range(4):
            inj.check("x")
        for _ in range(4):
            inj.check("y")              # other label: never fires
        assert inj.fired == [("slow", "x", 2), ("slow", "x", 4)]

    def test_probability_is_seed_deterministic(self):
        def run(seed):
            inj = FaultInjector((FaultSpec("slow", probability=0.3,
                                           delay_seconds=0.0),), seed=seed)
            for _ in range(50):
                inj.check()
            return [c for _, _, c in inj.fired]
        assert run(7) == run(7)
        assert run(7) != run(8)

    def test_install_uninstall_on_plan(self):
        # a dims-only plan: the methods run the guard first, and without
        # process groups the untraced call then raises its ValueError
        plan = plan_all_to_all((2, 2), ("i", "j"), (4,), "float32",
                               backend="factorized")
        inj = FaultInjector((FaultSpec("device_loss", at_call=2,
                                       devices=(0,)),
                             FaultSpec("slow", every=1, label="a2a.round")))
        inj.install(plan, "a2a")
        inj.install(plan, "a2a")        # idempotent
        x = torch.zeros(4, 4)
        with pytest.raises(ValueError, match="DeviceMesh"):
            plan.forward(x)             # call 1: no fault
        for run in (plan.reverse, lambda y: plan.tiled(y, 0, 0),
                    plan.overlap):
            with pytest.raises((DeviceLossError, ValueError)):
                run(x)
        assert inj.fired == [("device_loss", "a2a", 2)]
        assert inj.calls == {"a2a": 4}
        plan._round_fault_check()
        assert inj.fired[-1] == ("slow", "a2a.round", 1)
        inj.uninstall(plan)
        for m in ("forward", "reverse", "tiled", "overlap",
                  "_round_fault_check"):
            assert m not in plan.__dict__
        with pytest.raises(ValueError, match="DeviceMesh"):
            plan.forward(x)
        assert inj.calls == {"a2a": 4, "a2a.round": 1}

    def test_install_on_ragged_plan(self):
        plan = plan_ragged_all_to_all((2, 2), ("i", "j"), (4,), "float32",
                                      max_count=4)
        inj = FaultInjector((FaultSpec("device_loss", at_call=1),))
        inj.install(plan, "ragged")
        assert set(inj._installed[id(plan)][1]) == {"forward", "reverse"}
        with pytest.raises(DeviceLossError):
            plan.forward(torch.zeros(4, 4, 4), torch.zeros(4))
        inj.uninstall()
        assert "forward" not in plan.__dict__

    def test_bad_spec_kind(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultSpec("meteor")

    def test_fired_sequence_matches_reference(self):
        specs = [("slow", dict(every=3, label="x")),
                 ("slow", dict(probability=0.25)),
                 ("hang", dict(at_call=5, label="a2a.round")),
                 ("device_loss", dict(at_call=7, devices=(3,)))]
        labels = ["x", "a2a", "a2a.round", "x", "a2a"] * 4
        got = []
        for mod in (jax_faults, faults):
            inj = mod.FaultInjector([mod.FaultSpec(k, **kw)
                                     for k, kw in specs], seed=11)
            lost = []
            for label in labels:
                try:
                    inj.check(label)
                except mod.DeviceLossError as e:
                    lost.append(e.devices)
            with inj.guard("step"):
                pass
            inj.wrap(lambda: None, "x")()
            got.append((inj.fired, inj.calls, lost))
        assert got[0] == got[1]
        assert got[0][2] == [(3,), (3,)] and len(got[0][0]) > 3


# ---------------------------------------------------------------------------
# Tuning-record migration
# ---------------------------------------------------------------------------

def _record(axes, dims):
    return {"version": 1,
            "winner": {"backend": "factorized", "round_order": [0],
                       "n_chunks": 1, "median_us": 10.0},
            "axis_names": list(axes), "dims": list(dims)}


class TestMigrateRecords:
    def test_migrates_only_surviving_extents(self, tmp_path):
        db = TuningDB(tmp_path / "t.json")
        old_key, new_key = ((0, "cpu"), (1, "cpu")), ((0, "cpu"),)
        new_dims, new_axes = (2, 4), ("i", "j")
        # axis j kept extent 4 across the rebuild -> migrates
        db.put(plan_db_key(old_key, (4,), ("j",), (8,), "float32",
                           "natural"), _record(("j",), (4,)))
        # axis i changed extent (4 -> 2) -> stays behind
        db.put(plan_db_key(old_key, (4,), ("i",), (8,), "float32",
                           "natural"), _record(("i",), (4,)))
        # full-torus record over the old shape -> stays behind
        db.put(plan_db_key(old_key, (4, 2), ("i", "j"), (8,), "float32",
                           "natural"), _record(("i", "j"), (4, 2)))
        n = migrate_records(db, old_key, new_key, new_dims, new_axes)
        assert n == 1
        rec = db.get(plan_db_key(new_key, (4,), ("j",), (8,), "float32",
                                 "natural"))
        assert rec is not None and rec["migrated"] is True
        assert rec["winner"]["backend"] == "factorized"
        assert db.get(plan_db_key(new_key, (4,), ("i",), (8,), "float32",
                                  "natural")) is None

    def test_noop_for_same_or_deviceless_fingerprints(self, tmp_path):
        db = TuningDB(tmp_path / "t.json")
        key = ((0, "cpu"),)
        assert migrate_records(db, key, key, (2,), ("i",)) == 0
        assert migrate_records(db, None, key, (2,), ("i",)) == 0
        assert fingerprint_digest(None) == "none"


# ---------------------------------------------------------------------------
# TuningDB faults: a wedged lock, a corrupt file
# ---------------------------------------------------------------------------

class TestTuningLockTimeout:
    def test_wedged_lock_degrades_to_in_memory(self, tmp_path):
        db = TuningDB(tmp_path / "t.json", lock_timeout=0.2)
        assert db.put("k0", {"v": 0})
        gen = db.generation()
        with hold_tuning_db_lock(db):
            with pytest.warns(UserWarning, match="in-memory"):
                ok = db.put("k1", {"v": 1})
            assert not ok
            # degraded, not lost: this handle still reads the record,
            # and cached autotune plans re-resolve (generation bumped)
            assert db.get("k1") == {"v": 1}
            assert db.generation() == gen + 1
            on_disk = json.loads((tmp_path / "t.json").read_text())
            assert "k1" not in on_disk["entries"]
        # holder gone: the next successful put flushes the overlay
        assert db.put("k2", {"v": 2})
        on_disk = json.loads((tmp_path / "t.json").read_text())
        assert set(on_disk["entries"]) == {"k0", "k1", "k2"}
        assert db._overlay == {}

    @pytest.mark.parametrize("mode", ["garbage", "truncate"])
    def test_corrupt_db_loads_empty_with_warning(self, tmp_path, mode):
        db = TuningDB(tmp_path / "t.json")
        db.put("k", {"v": 1})
        corrupt_tuning_db(db, mode=mode)
        with pytest.warns(UserWarning, match="corrupt|unreadable"):
            assert db.load() == {}

    def test_corrupt_default_db_falls_back_to_the_model(self):
        key = plan_db_key(None, (2, 2), ("i", "j"), (8,), "float32",
                          "natural")
        TuningDB().put(key, {"version": 1, "winner": {
            "backend": "direct", "round_order": [0, 1], "n_chunks": 1}})
        assert plan_all_to_all((2, 2), ("i", "j"), (8,), "float32",
                               backend="autotune").tuned_from == "measured"
        # garbage written under the same generation: a fresh resolution
        # (free the registry) reads it as empty and uses the model
        corrupt_tuning_db(TuningDB(), seed=3)
        free_plans()
        with pytest.warns(UserWarning, match="tuning DB"):
            p = plan_all_to_all((2, 2), ("i", "j"), (8,), "float32",
                                backend="autotune")
        assert p.tuned_from == "model"

    def test_same_garbage_as_reference(self, tmp_path):
        a = corrupt_tuning_db(tmp_path / "a.json", seed=5)
        b = jax_faults.corrupt_tuning_db(tmp_path / "b.json", seed=5)
        assert a.read_bytes() == b.read_bytes()


# ---------------------------------------------------------------------------
# Checkpoint corrupt-leaf fallback (the port's store)
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((4, 4))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((4,))
                                  .astype(np.float32))}


class TestCheckpointFallback:
    def test_falls_back_to_next_newest(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree(1), {"step": 1})
        save_checkpoint(tmp_path, 2, _tree(2), {"step": 2})
        corrupt_checkpoint_leaf(tmp_path, step=2)
        with pytest.warns(RuntimeWarning,
                          match="skipping checkpoint step 2"):
            tree, extra, step = restore_checkpoint(tmp_path, None,
                                                   _tree(0))
        assert step == 1 and extra["step"] == 1
        assert torch.equal(tree["w"], _tree(1)["w"])

    def test_latest_is_corrupted_by_default(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        for s in (1, 2):
            mgr.save_sync(s, _tree(s), {"step": s})
        path = corrupt_checkpoint_leaf(tmp_path, leaf_index=1, seed=4)
        assert path.parent.name == "step_00000002"
        with pytest.warns(RuntimeWarning):
            assert mgr.restore(_tree(0))[2] == 1

    def test_explicit_step_still_raises(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree(1), {})
        save_checkpoint(tmp_path, 2, _tree(2), {})
        corrupt_checkpoint_leaf(tmp_path, step=2)
        with pytest.raises(Exception):
            restore_checkpoint(tmp_path, 2, _tree(0))

    def test_all_corrupt_raises_ioerror(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree(1), {})
        save_checkpoint(tmp_path, 2, _tree(2), {})
        corrupt_checkpoint_leaf(tmp_path, step=1)
        corrupt_checkpoint_leaf(tmp_path, step=2)
        with pytest.warns(RuntimeWarning):
            with pytest.raises(IOError, match="unusable"):
                restore_checkpoint(tmp_path, None, _tree(0))

    def test_save_and_restore_spans(self, tmp_path):
        telemetry.enable_tracing()
        save_checkpoint(tmp_path, 1, _tree(1), {})
        restore_checkpoint(tmp_path, None, _tree(0))
        spans = [(s.name, s.attrs["step"]) for s in
                 telemetry.get_tracer().spans()]
        assert spans == [("checkpoint.save", 1), ("checkpoint.restore", 1)]
        snap = telemetry.metrics().snapshot()
        assert snap["checkpoint.saves"] == snap["checkpoint.restores"] == 1
