"""The port's checkpoint store, watchdog, trainer and train launcher
(repro_torch), the counterparts of the reference's substrate tests
(``tests/test_substrates.py``), on the CPU at a tiny size."""

import json
import time
import types

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import (CheckpointManager, all_steps,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import CopyTaskConfig, SyntheticLM
from repro_torch.launch import train as train_launch
from repro_torch.models import ModelConfig, build_model, make_train_step
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamW, AdamWConfig, cosine_with_warmup
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.watchdog import (Action, EscalationPolicy,
                                          StragglerWatchdog)

ARCH = "phi3.5-moe-42b"


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, tree, {"step": s}, keep=2)
    assert latest_step(tmp_path) == 4 and all_steps(tmp_path) == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))
    out, extra, step = restore_checkpoint(tmp_path, None, tree)
    assert step == 4 and extra["step"] == 4
    for (path, a), (_, b) in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_bf16_bits_roundtrip(tmp_path):
    # every bf16 bit pattern but the NaNs, through save and restore
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32) \
        .to(torch.int16).view(torch.bfloat16)
    bits = bits[~torch.isnan(bits)]
    save_checkpoint(tmp_path, 1, {"w": bits})
    out, _, _ = restore_checkpoint(tmp_path, 1, {"w": bits})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), bits.view(torch.int16))


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.ones(8)}
    path = save_checkpoint(tmp_path, 1, tree)
    leaf = next(path.glob("leaf_*"))
    leaf.write_bytes(np.zeros(8, np.float32).tobytes())
    with pytest.raises(IOError, match="corrupt"):
        restore_checkpoint(tmp_path, 1, tree)


def test_checkpoint_corrupt_latest_falls_back(tmp_path):
    tree = {"a": torch.ones(8)}
    save_checkpoint(tmp_path, 1, tree)
    path = save_checkpoint(tmp_path, 2, {"a": torch.full((8,), 2.0)})
    next(path.glob("leaf_*")).write_bytes(b"\0" * 5)
    with pytest.warns(RuntimeWarning, match="skipping checkpoint step 2"):
        out, _, step = restore_checkpoint(tmp_path, None, tree)
    assert step == 1 and torch.equal(out["a"], tree["a"])


def test_checkpoint_missing_leaf_detected(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="missing leaf zz"):
        restore_checkpoint(tmp_path, 1, {"zz": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, {"a": torch.ones(3)})


def test_checkpoint_async_manager(tmp_path):
    m = CheckpointManager(tmp_path)
    x = torch.arange(3.0)
    m.save_async(5, {"x": x}, {"step": 5})
    x += 100                  # the save snapshot was taken before this
    m.wait()
    assert m.latest() == 5
    out, extra, _ = m.restore({"x": x})
    assert extra == {"step": 5} and torch.equal(out["x"], torch.arange(3.0))


def test_checkpoint_async_error_raises_on_wait(tmp_path):
    (tmp_path / "f").write_text("")
    m = CheckpointManager(tmp_path / "f" / "sub")    # a file as parent
    m.save_async(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        m.wait()


def test_checkpoint_leaf_keys_and_values_match_the_reference_store(
        tmp_path):
    # the same tree through both stores gives the same leaf keys and
    # values (the files differ: compressed leaves there, raw ones here)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.float32)}}
    jax_save(tmp_path / "ref", 1, tree)
    ref, _, _ = jax_restore(tmp_path / "ref", 1, tree)
    save_checkpoint(tmp_path / "port", 1,
                    tree_map(torch.from_numpy, tree))
    manifest = json.loads((tmp_path / "port" / "step_00000001" /
                           "manifest.json").read_text())
    assert sorted(manifest["leaves"]) == ["a", "b/c"]
    out, _, _ = restore_checkpoint(tmp_path / "port", 1,
                                   {"a": torch.zeros(2, 3),
                                    "b": {"c": torch.zeros(4)}})
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(ref["a"]))
    np.testing.assert_array_equal(out["b"]["c"].numpy(),
                                  np.asarray(ref["b"]["c"]))


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_classification():
    w = StragglerWatchdog(min_samples=5)
    for i in range(20):
        assert w.observe(i, 0.1 + 0.001 * (i % 3)) == "ok"
    assert w.observe(20, 0.4) == "straggler"
    assert w.observe(21, 5.0) == "hang"
    assert [e[0] for e in w.events] == ["straggler", "hang"]


def test_escalation_policy():
    p = EscalationPolicy(max_retries=1, max_recoveries=1)
    assert p.decide("straggler", now=0.0) == Action(
        "retry", backoff=0.05, reason="straggler retry 1/1")
    assert p.decide("straggler", now=1.0).kind == "recover"
    assert p.decide("hang", now=2.0).kind == "abort"
    assert p.decide("ok", now=3.0).kind == "continue"
    assert p.decide("drift").kind == "retune"
    with pytest.raises(ValueError):
        p.decide("bogus")


def test_watchdog_check_drift_waits_for_the_detector():
    # the drift detector is ported: a drifted key yields one advisory
    # "retune" per episode, as the reference's watchdog does
    from repro.core.telemetry import DriftDetector as JaxDrift
    from repro.runtime.watchdog import StragglerWatchdog as JaxWatchdog
    from repro_torch.core.telemetry import DriftDetector
    got = []
    for det, wd in ((DriftDetector(), StragglerWatchdog()),
                    (JaxDrift(), JaxWatchdog())):
        for ratio in (1.0, 3.0, 3.0, 3.0):
            det.observe("dense[x]4:factorized:64", 0.001, 0.001 * ratio)
        first = [(k, a.kind) for k, a in wd.check_drift(det, step=7)]
        got.append((first, wd.check_drift(det, step=8), wd.last_verdict,
                    [e for e in wd.events if e[0] == "drift"]))
    assert got[0] == got[1]
    assert got[0][:3] == ([("dense[x]4:factorized:64", "retune")], [],
                          "drift")


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """Pin torch's intra-op pool to one thread for the test.  The trainer's
    watchdog judges each step by its wall time against the median; with a
    full pool per process, parallel test workers oversubscribe the cores
    and one step can stall past the hang verdict.  Restores the count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny_cfg(n_layers=1, d_model=32, d_ff=64):
    return ModelConfig(name="tiny", family="dense", n_layers=n_layers,
                       d_model=d_model, n_heads=4, n_kv_heads=4, d_ff=d_ff,
                       vocab=64, param_dtype="float32",
                       compute_dtype="float32", remat=False)


def _data(batch=8, seq=16):
    return SyntheticLM(CopyTaskConfig(vocab=64, seq_len=seq,
                                      global_batch=batch), task="copy",
                       device="cpu")


def _tiny_setup(tmpdir, total=60, ckpt_every=20):
    model = build_model(_tiny_cfg())
    opt = AdamW(AdamWConfig(lr=1e-3, weight_decay=0.0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    step = make_train_step(model, opt)
    tr = Trainer(TrainerConfig(total_steps=total, checkpoint_dir=str(tmpdir),
                               checkpoint_every=ckpt_every, log_every=10,
                               async_checkpoint=False),
                 step, _data(), params, opt.init(params))
    return opt, step, tr


def test_trainer_learns_copy_task(tmp_path, one_thread):
    model = build_model(_tiny_cfg(n_layers=2, d_model=64, d_ff=128))
    opt = AdamW(AdamWConfig(lr=cosine_with_warmup(3e-3, 20, 300),
                            weight_decay=0.0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    tr = Trainer(TrainerConfig(total_steps=300, checkpoint_dir=str(tmp_path),
                               checkpoint_every=1000, log_every=50,
                               async_checkpoint=False),
                 make_train_step(model, opt), _data(batch=16, seq=32),
                 params, opt.init(params))
    assert tr.run() == "done"
    losses = [r["ce_loss"] for r in tr.metrics_log]
    assert losses[-1] < 0.5 * losses[0], losses


def test_trainer_bit_exact_restart(tmp_path, one_thread):
    opt, step, tr = _tiny_setup(tmp_path, total=40, ckpt_every=20)
    tr.run()
    # a fresh trainer restores the step-20 checkpoint and replays to 40
    tree, extra, _ = tr.ckpt.restore(tr._state_tree(), step=20)
    tr2 = Trainer(TrainerConfig(total_steps=40,
                                checkpoint_dir=str(tmp_path) + "_x",
                                checkpoint_every=100, log_every=10,
                                async_checkpoint=False),
                  step, _data(), tree_map(lambda t: t.requires_grad_(True),
                                          tree["params"]),
                  tree["opt_state"], step=20)
    tr2.data.load_state_dict(extra["data"])
    tr2.run()
    for (path, a), (_, b) in zip(tree_leaves(tr._state_tree()),
                                 tree_leaves(tr2._state_tree())):
        assert torch.equal(a, b), path


def test_trainer_try_restore_resumes(tmp_path, one_thread):
    opt, step, tr = _tiny_setup(tmp_path, total=10, ckpt_every=5)
    tr.config.async_checkpoint = True
    tr.run()
    _, _, fresh = _tiny_setup(tmp_path, total=10, ckpt_every=5)
    assert fresh.try_restore() and fresh.step == 10
    assert fresh.data.step == tr.data.step == 10
    for (path, a), (_, b) in zip(tree_leaves(tr._state_tree()),
                                 tree_leaves(fresh._state_tree())):
        assert torch.equal(a, b), path
    assert all(t.requires_grad for _, t in tree_leaves(fresh.params))


def test_trainer_hang_aborts_with_checkpoint(tmp_path, one_thread):
    opt, step, tr = _tiny_setup(tmp_path, total=60, ckpt_every=1000)
    calls = {"n": 0}

    def slow_step(p, o, b):
        calls["n"] += 1
        out = step(p, o, b)
        if calls["n"] == 30:
            time.sleep(1.5)
        return out

    tr.train_step = slow_step
    with pytest.raises(RuntimeError, match="hang"):
        tr.run()
    assert tr.ckpt.latest() == 30   # checkpointed at the abort


def test_trainer_preemption_checkpoints_and_stops(tmp_path, one_thread):
    opt, step, tr = _tiny_setup(tmp_path, total=60, ckpt_every=1000)

    def preempted_step(p, o, b):
        out = step(p, o, b)
        tr._preempted = tr.step + 1 == 7     # SIGTERM during step 7
        return out

    tr.train_step = preempted_step
    assert tr.run() == "preempted"
    assert tr.step == 7 and tr.ckpt.latest() == 7


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_train_main_on_cpu(tmp_path, capsys):
    tr = train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "4", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    assert tr.step == 4 and tr.ckpt.latest() == 4
    row = json.loads(capsys.readouterr().out.splitlines()[0])
    assert np.isfinite(row["total_loss"]) and row["step"] == 4
    # --resume picks the run up at its last checkpoint
    tr = train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "6", "--ckpt-dir", str(tmp_path),
                            "--resume"])
    assert tr.step == 6
    assert "resumed from step 4" in capsys.readouterr().out


def test_train_default_device_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train_launch.main(["--arch", ARCH, "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    # the debug mesh trains under 8 ranks (tests/test_torch_tp.py);
    # without a world of that size the launcher refuses and says so
    with pytest.raises(SystemExit, match="needs 8 ranks"):
        train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--mesh", "debug"])
    # a mesh with a "model" dim (the reference's debug mesh's shape; a
    # stand-in object, since a DeviceMesh needs a process group of 8):
    # the launcher's check accepts Ulysses over "model" on it (its 4
    # query heads divide model = 4; tests/test_torch_tp.py trains it)
    debug = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  mesh=torch.empty(2, 4))
    cfg = get_config(ARCH, smoke=True).replace(use_ulysses=True)
    train_launch.check_trainable(debug, cfg)


def test_trainer_traces_steps_and_checkpoints(tmp_path, one_thread):
    """Traced, ``Trainer.run`` records one ``train.step`` span per step
    and the checkpoint one ``checkpoint.save`` / ``checkpoint.restore``
    span per save and restore (the reference's spans); untraced,
    nothing."""
    from repro_torch.core import telemetry
    _, _, tr = _tiny_setup(tmp_path, total=4, ckpt_every=2)
    telemetry.reset_telemetry()
    tracer = telemetry.enable_tracing()
    try:
        assert tr.run() == "done"
        assert tr.try_restore()
    finally:
        telemetry.disable_tracing()
    spans = [(s.name, s.attrs["step"]) for s in tracer.spans()]
    telemetry.reset_telemetry()
    assert spans == [("train.step", 1), ("train.step", 2),
                     ("checkpoint.save", 2), ("train.step", 3),
                     ("train.step", 4), ("checkpoint.save", 4),
                     ("checkpoint.restore", 4)]
    assert tr.retune_log == []
    _, _, tr = _tiny_setup(tmp_path / "off", total=2, ckpt_every=2)
    tr.run()
    assert tracer.spans() == []
