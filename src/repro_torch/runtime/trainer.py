"""Fault-tolerant trainer: checkpoint / restart, preemption and the
elastic loop (port of ``repro.runtime.trainer``).

All state (params, optimizer state, data cursor, step) round-trips through
the checkpoint, so ``Trainer.run()`` after a crash resumes bit-exact.
SIGTERM triggers a final synchronous checkpoint before ``run`` returns
"preempted".  The straggler watchdog classifies each step; a presumed hang
with ``abort_on_hang`` checkpoints synchronously and raises.  Each step
ends in a host read of ``total_loss``, the counterpart of the reference's
``block_until_ready``, so a step's time is the device's.

Each step runs under a ``train.step`` tracer span (``core.telemetry``;
nothing is recorded while tracing is off).

With ``TrainerConfig.elastic`` the loop drives on the watchdog's escalation
:class:`~repro_torch.runtime.watchdog.Action` — detect, degrade, rebuild,
resume, as the reference does:

* ``retry`` (straggler): the step already committed, so a retry is a
  backoff sleep, never a re-execution.
* ``recover`` after a hang: checkpoint now, then ``rebuild_fn``
  re-factorizes the communicator (``TorusComm.rebuild``) and the trainer
  restores onto the layout it returns.
* ``recover`` after a device loss (:class:`DeviceLossError` out of the
  step): the step never committed and the lost ranks' state is gone, so
  nothing is saved; the last durable checkpoint is restored onto the
  survivors.
* ``abort``: checkpoint and raise :class:`FaultError`.

After each step ``StragglerWatchdog.check_drift`` feeds ``retune_log``.

On a mesh (``sharding``, the parameters' ``ExpertSharding``), every rank
runs the loop: checkpoints hold global arrays (``checkpoint.store``:
gathered on every rank, written by one), and where the reference reads a
global array, a step's time (``block_until_ready`` on it waits for every
device) and the preemption flag, the ranks agree through one all-reduce
(the max) per step, so every rank takes the same watchdog verdict and
saves at the same step.  The elastic loop keeps three rules of its own:

* **Every rank takes the same action.**  The escalation policy also reads
  a clock (its incident timeout); the elastic step's all-reduce carries
  each rank's ``time.monotonic()`` beside the step time and the flag, and
  the policy decides on the maximum.  A device loss is decided on the
  clock the last step agreed on, since the old group has lost ranks.
* **A lost rank leaves.**  On the ranks a ``DeviceLossError`` names,
  ``run`` returns ``"lost"`` at once and they make no further collective
  call; the survivors recover without them: ``rebuild_fn`` builds their
  mesh (``core.cache`` creates its groups with the survivors alone) and
  returns the parameters' layout on it, onto which ``try_restore``
  restores; the checkpoint's writer is then the survivor at mesh
  coordinate 0.
* **``retune_log`` is advisory per rank**: drift is measured per rank, so
  its entries may differ between ranks; they never change control flow.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.core import telemetry
from repro_torch.core.faults import DeviceLossError, FaultError
from repro_torch.models.common import tree_map
from repro_torch.parallel.sharding import collective_device
from repro_torch.runtime.watchdog import StepTimer, StragglerWatchdog


@dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_dir: str
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    async_checkpoint: bool = True
    abort_on_hang: bool = True
    # drive the escalation policy (retry / recover / abort) instead of the
    # hang-abort; the recover path needs rebuild_fn
    elastic: bool = False


_SAME = object()    # try_restore's default: the layout the state has now


@dataclass
class Trainer:
    config: TrainerConfig
    train_step: Callable                 # (params, opt, batch) -> (...)
    data: Any                            # SyntheticLM-like
    params: Any
    opt_state: Any
    step: int = 0
    metrics_log: list = field(default_factory=list)
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)
    # elastic recovery hook: (trainer, error_or_None) rebuilds the
    # communicator / mesh on the survivors, swaps train_step / data as
    # needed, and returns the parameters' layout there (an ExpertSharding;
    # None: one device) for the restore
    rebuild_fn: Callable | None = None
    recoveries_done: int = 0
    # drift-retune advisories from the telemetry DriftDetector, routed
    # through the watchdog: list of (step, drift_key, Action)
    retune_log: list = field(default_factory=list)
    # on a mesh: the parameters' ExpertSharding (None: one device)
    sharding: Any = None
    _preempted: bool = False
    # the clock the ranks last agreed on (the elastic policy's ``now``)
    _now: float | None = None

    def __post_init__(self):
        self.ckpt = CheckpointManager(self.config.checkpoint_dir,
                                      self.config.keep_checkpoints,
                                      self._state_sharding())

    # ---- checkpoint plumbing ----
    def _state_tree(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _state_sharding(self):
        """The state tree's layout: the parameters' and, leaf for leaf,
        the AdamW moments'."""
        sh = self.sharding
        if sh is None:
            return None
        return sh.prefixed("params").merged(sh.prefixed("opt_state/mu"),
                                            sh.prefixed("opt_state/nu"))

    def _agree(self, seconds: float, now: float | None = None):
        """On a mesh, ``(seconds, now)`` agreed by one all-reduce (the
        max): the slowest rank's step time and, with ``now`` (the elastic
        loop), the latest clock; it also sets the preemption flag if any
        rank was signalled."""
        group = None if self.sharding is None else self.sharding.group
        if group is None:
            return seconds, now
        vals = [seconds, float(self._preempted)]
        if now is not None:
            vals.append(now)
        t = torch.tensor(vals, dtype=torch.float64,
                         device=collective_device(group.pg))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
        self._preempted = bool(t[1].item())
        return float(t[0].item()), None if now is None \
            else float(t[2].item())

    def save(self, sync=False):
        extra = {"step": self.step, "data": self.data.state_dict(),
                 "wall": time.time()}
        if sync or not self.config.async_checkpoint:
            self.ckpt.save_sync(self.step, self._state_tree(), extra)
        else:
            self.ckpt.save_async(self.step, self._state_tree(), extra)

    def try_restore(self, sharding=_SAME) -> bool:
        """Restore the latest checkpoint onto the devices the params and
        optimizer state live on; False if there is none.  On a mesh
        every rank calls it (the pending save is waited for first).
        ``sharding``: the parameters' layout to restore onto (a rebuilt
        mesh's, from ``rebuild_fn``; None: one device), which the trainer
        and its checkpoints keep from then on; the pending save is then
        agreed on the new layout's group, so no lost rank is waited for."""
        held = self.ckpt.sharding
        if sharding is not _SAME:
            self.sharding = sharding
            self.ckpt.sharding = self._state_sharding()
        self.ckpt.wait()
        if self.ckpt.latest() is None:
            return False
        tree, extra, _ = restore_checkpoint(self.ckpt.directory, None,
                                            self._state_tree(),
                                            self.ckpt.sharding, held)
        self.params = tree["params"]
        tree_map(lambda t: t.requires_grad_(True), self.params)
        self.opt_state = tree["opt_state"]
        self.step = int(extra["step"])
        self.data.load_state_dict(extra["data"])
        return True

    # ---- preemption ----
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    # ---- elastic recovery ----
    def _recover(self, error: Exception | None, reason: str) -> None:
        """Checkpoint now (hang only), rebuild, restore, resume."""
        if error is None:
            # hang: the live state is intact, make it durable first
            self.save(sync=True)
        if self.rebuild_fn is None:
            raise FaultError(f"recovery requested ({reason}) but no "
                             f"rebuild_fn is configured")
        sharding = self.rebuild_fn(self, error)
        if not self.try_restore(sharding):
            raise FaultError(f"recovery ({reason}): no durable "
                             f"checkpoint to restore from")
        self.recoveries_done += 1

    def _lost(self, err: DeviceLossError) -> bool:
        """Whether this rank is one the device loss took out."""
        return self.sharding is not None and dist.is_initialized() \
            and dist.get_rank() in err.devices

    # ---- main loop ----
    def run(self, max_steps: int | None = None):
        """Train to ``total_steps`` (or ``max_steps`` more); returns
        "done", "preempted", or, on a rank a device loss took out, "lost"
        (it then makes no further collective call)."""
        cfg = self.config
        end = min(cfg.total_steps,
                  self.step + (max_steps or cfg.total_steps))
        while self.step < end:
            batch = self.data.next()
            try:
                with StepTimer() as t, telemetry.get_tracer().span(
                        "train.step", cat="trainer", step=self.step + 1):
                    self.params, self.opt_state, metrics = \
                        self.train_step(self.params, self.opt_state, batch)
                    total = float(metrics["total_loss"])   # waits for the card
            except DeviceLossError as err:
                if not cfg.elastic:
                    raise
                if self._lost(err):
                    return "lost"
                # the step never committed: params / opt / step / data
                # cursor roll back to the last checkpoint in the recovery
                action = self.watchdog.policy(self.step + 1, t.seconds,
                                              verdict="device_loss",
                                              now=self._now)
                if action.kind == "recover":
                    self._recover(err, action.reason)
                    continue
                raise FaultError(f"device loss at step {self.step + 1}: "
                                 f"{action.reason}") from err
            self.step += 1

            if cfg.elastic:
                seconds, self._now = self._agree(t.seconds, time.monotonic())
                action = self.watchdog.policy(self.step, seconds,
                                              now=self._now)
                verdict = self.watchdog.last_verdict
                if action.kind == "retry":
                    # the slow step still committed: backoff, then go on
                    time.sleep(action.backoff)
                elif action.kind == "recover":
                    self._recover(None, action.reason)
                    continue
                elif action.kind == "abort":
                    self.save(sync=True)
                    raise FaultError(f"watchdog abort at step "
                                     f"{self.step}: {action.reason}")
                # advisory lane: drift -> "retune" (never changes the loop)
                for key, act in self.watchdog.check_drift(step=self.step):
                    self.retune_log.append((self.step, key, act))
            else:
                seconds, _ = self._agree(t.seconds)
                verdict = self.watchdog.observe(self.step, seconds)
                if verdict == "hang" and cfg.abort_on_hang:
                    self.save(sync=True)
                    raise RuntimeError(
                        f"watchdog: presumed hang at step {self.step} "
                        f"({seconds:.3f}s vs median "
                        f"{self.watchdog.median:.3f}s); checkpointed for "
                        f"restart")

            if self.step % cfg.log_every == 0 or self.step == end:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(total_loss=total, step=self.step,
                           seconds=seconds, verdict=verdict)
                self.metrics_log.append(row)

            if self.step % cfg.checkpoint_every == 0:
                self.save()
            if self._preempted:
                self.save(sync=True)
                return "preempted"
        self.ckpt.wait()
        return "done"

