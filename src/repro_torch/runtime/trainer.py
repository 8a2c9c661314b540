"""Fault-tolerant trainer: checkpoint / restart and preemption (port of
``repro.runtime.trainer``, the non-elastic loop).

All state (params, optimizer state, data cursor, step) round-trips through
the checkpoint, so ``Trainer.run()`` after a crash resumes bit-exact.
SIGTERM triggers a final synchronous checkpoint before ``run`` returns
"preempted".  The straggler watchdog classifies each step; a presumed hang
with ``abort_on_hang`` checkpoints synchronously and raises.  Each step
ends in a host read of ``total_loss``, the counterpart of the reference's
``block_until_ready``, so a step's time is the device's.

Each step runs under a ``train.step`` tracer span (``core.telemetry``;
nothing is recorded while tracing is off).  ``retune_log`` is the
reference's field for the drift detector's re-tune advisories, which the
reference's elastic loop routes through ``StragglerWatchdog.check_drift``
after each step.

On a mesh (``sharding``, the parameters' ``ExpertSharding``), every rank
runs the loop: checkpoints hold global arrays (``checkpoint.store``:
gathered on every rank, written by one), and where the reference reads a
global array, a step's time (``block_until_ready`` on it waits for every
device) and the preemption flag, the ranks agree through one all-reduce
(the max) per step, so every rank takes the same watchdog verdict and
saves at the same step.

Not ported yet (ROADMAP.md): the elastic loop (``elastic=True``: the
escalation policy's retry / recover / abort with ``comm.rebuild``, and
the ``check_drift`` call inside it), so ``retune_log`` stays empty.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import telemetry
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
    elastic: bool = False


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
    # drift-retune advisories from the telemetry DriftDetector, routed
    # through the watchdog: list of (step, drift_key, Action)
    retune_log: list = field(default_factory=list)
    # on a mesh: the parameters' ExpertSharding (None: one device)
    sharding: Any = None
    _preempted: bool = False

    def __post_init__(self):
        if self.config.elastic:
            raise NotImplementedError(
                "the elastic trainer (retry / recover / abort through "
                "comm.rebuild and core/faults.py) is not ported to "
                "repro_torch yet; ROADMAP.md lists it")
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

    def _agree(self, seconds: float) -> float:
        """On a mesh, the slowest rank's step time; also sets the
        preemption flag if any rank was signalled (one all-reduce)."""
        group = None if self.sharding is None else self.sharding.group
        if group is None:
            return seconds
        t = torch.tensor([seconds, float(self._preempted)],
                         dtype=torch.float64,
                         device=collective_device(group.pg))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
        self._preempted = bool(t[1].item())
        return float(t[0].item())

    def save(self, sync=False):
        extra = {"step": self.step, "data": self.data.state_dict(),
                 "wall": time.time()}
        if sync or not self.config.async_checkpoint:
            self.ckpt.save_sync(self.step, self._state_tree(), extra)
        else:
            self.ckpt.save_async(self.step, self._state_tree(), extra)

    def try_restore(self) -> bool:
        """Restore the latest checkpoint onto the devices the params and
        optimizer state live on; False if there is none.  On a mesh
        every rank calls it (the pending save is waited for first)."""
        self.ckpt.wait()
        if self.ckpt.latest() is None:
            return False
        tree, extra, _ = self.ckpt.restore(self._state_tree())
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

    # ---- main loop ----
    def run(self, max_steps: int | None = None):
        cfg = self.config
        end = min(cfg.total_steps,
                  self.step + (max_steps or cfg.total_steps))
        while self.step < end:
            batch = self.data.next()
            with StepTimer() as t, telemetry.get_tracer().span(
                    "train.step", cat="trainer", step=self.step + 1):
                self.params, self.opt_state, metrics = \
                    self.train_step(self.params, self.opt_state, batch)
                total = float(metrics["total_loss"])   # waits for the card
            self.step += 1
            seconds = self._agree(t.seconds)
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

