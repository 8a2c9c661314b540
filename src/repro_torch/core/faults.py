"""Deterministic fault injection (port of ``repro.core.faults``; stdlib
only, with a lazy ``checkpoint.store`` import).

Every failure mode a detect → degrade → recover loop must handle can be
produced on demand, deterministically, from a seed, so the recovery paths
are exercised by ordinary tests instead of waiting for hardware to die:

* **device loss** — :class:`DeviceLossError` raised at a chosen guarded
  call, naming the dead device ids.
* **slow / hung rounds** — a deterministic ``time.sleep`` around a
  guarded execution, sized to trip the watchdog's straggler or hang
  thresholds.
* **corrupted checkpoint leaves** — flip one byte of a stored leaf file
  (:func:`corrupt_checkpoint_leaf`), exercising the ``checkpoint.store``
  sha256 check and its fall back to the next newest.
* **corrupted / contended tuning-DB files** —
  :func:`corrupt_tuning_db` writes deterministic garbage;
  :func:`hold_tuning_db_lock` holds the advisory flock so a writer must
  time out and degrade to in-memory tuning.

Injectors hook a plan's execution methods (``forward`` / ``reverse`` and,
on a dense plan, ``tiled`` / ``overlap``: :meth:`FaultInjector.install`),
or any callable via :meth:`FaultInjector.wrap` /
:meth:`FaultInjector.guard`.  Faults fire on the host between calls,
never inside a kernel, so an injected failure looks like a runtime fault
(an exception or a stalled wall clock).
"""

from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field
from pathlib import Path


class FaultError(RuntimeError):
    """Base class for injected (and, in production, detected) faults."""


class DeviceLossError(FaultError):
    """A device subset became unreachable mid-collective.

    ``devices`` is the tuple of dead device ids (global ranks in the
    port); the surviving set is the complement, what
    ``TorusComm.rebuild`` takes.
    """

    def __init__(self, devices=(), message: str | None = None):
        self.devices = tuple(devices)
        super().__init__(message or
                         f"device loss: devices {list(self.devices)} "
                         f"unreachable")


FAULT_KINDS = ("device_loss", "slow", "hang")


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: *what* fires and *when*.

    Firing condition (evaluated per guarded call, in order):
      ``at_call`` — fire on exactly the Nth call (1-based) of the
      matching label; ``every`` — fire on every Nth call;
      ``probability`` — fire when the injector's seeded RNG draws below
      it.  Conditions compose with OR; all-default specs never fire.
    """

    kind: str                          # "device_loss" | "slow" | "hang"
    at_call: int | None = None
    every: int | None = None
    probability: float = 0.0
    delay_seconds: float = 0.0         # sleep for slow/hang kinds
    devices: tuple[int, ...] = ()      # dead device ids for device_loss
    label: str | None = None           # restrict to one guard label

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    def _fires(self, call: int, rng: random.Random) -> bool:
        if self.at_call is not None and call == self.at_call:
            return True
        if self.every is not None and self.every > 0 \
                and call % self.every == 0:
            return True
        return self.probability > 0.0 and rng.random() < self.probability


@dataclass
class FaultInjector:
    """Seeded, replayable fault schedule over labeled guard points.

    The same ``(specs, seed)`` pair always produces the same fault
    sequence — probabilistic specs draw from one ``random.Random(seed)``
    in call order, so a failing fuzz run is reproducible from its seed
    alone.  ``fired`` records every injected fault as ``(kind, label,
    call_index)``.
    """

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0
    calls: dict = field(default_factory=dict)      # label -> call count
    fired: list = field(default_factory=list)      # (kind, label, call)

    def __post_init__(self):
        self.specs = tuple(self.specs)
        self._rng = random.Random(self.seed)
        self._installed: dict[int, tuple] = {}

    # -- the guard points ---------------------------------------------------

    def check(self, label: str = "a2a") -> None:
        """One guarded call: bump the label's counter and fire any spec
        whose condition matches (sleep for slow/hang, raise for
        device_loss)."""
        call = self.calls.get(label, 0) + 1
        self.calls[label] = call
        for spec in self.specs:
            if spec.label is not None and spec.label != label:
                continue
            if not spec._fires(call, self._rng):
                continue
            self.fired.append((spec.kind, label, call))
            if spec.kind in ("slow", "hang"):
                time.sleep(max(0.0, spec.delay_seconds))
            else:
                raise DeviceLossError(spec.devices)

    @contextlib.contextmanager
    def guard(self, label: str = "a2a"):
        """Context-manager guard around an arbitrary region (a train
        step, a serving tick): the fault fires on entry."""
        self.check(label)
        yield

    def wrap(self, fn, label: str = "a2a"):
        """Wrap any callable so each invocation is a guarded call."""
        def guarded(*args, **kwargs):
            self.check(label)
            return fn(*args, **kwargs)
        return guarded

    # -- plan installation --------------------------------------------------

    def install(self, plan, label: str = "a2a"):
        """Install the injector around a plan's execution methods: each
        call of ``forward`` / ``reverse`` (and ``tiled`` / ``overlap``
        where the plan has them) is a guarded call.  Works for every plan
        kind.  Idempotent per plan; undo with :meth:`uninstall`."""
        if id(plan) in self._installed:
            return plan
        names = tuple(m for m in _EXECUTION_METHODS if hasattr(plan, m))
        for m in names:
            # instance attributes shadow the methods
            setattr(plan, m, self.wrap(getattr(plan, m), label))
        self._installed[id(plan)] = (plan, names)
        # Telemetry hook: when the tracer steps a factorized plan
        # round-by-round, each round calls this check *inside* its span,
        # so an injected slow round shows up as per-round drift (the
        # method wrappers above fire before the span opens and would be
        # invisible to round timing).  Distinct label — round-level specs
        # target "<label>.round" without perturbing outer call counts.
        plan._round_fault_check = lambda: self.check(f"{label}.round")
        return plan

    def uninstall(self, plan=None) -> None:
        """Remove the injector from one plan (or all installed plans)."""
        items = [self._installed.pop(id(plan))] if plan is not None \
            else [self._installed.pop(k) for k in list(self._installed)]
        for target, names in items:
            for m in names:
                target.__dict__.pop(m, None)
            target.__dict__.pop("_round_fault_check", None)


_EXECUTION_METHODS = ("forward", "reverse", "tiled", "overlap")


# ---------------------------------------------------------------------------
# Persistence faults: checkpoint leaves and the tuning DB
# ---------------------------------------------------------------------------


def corrupt_checkpoint_leaf(directory, step: int | None = None,
                            leaf_index: int = 0, seed: int = 0) -> Path:
    """Flip one byte of a stored checkpoint leaf file (deterministic from
    ``seed``), so restore hits either a sha256 mismatch or a codec
    decompression error — both of which ``checkpoint.store`` must treat
    as "this checkpoint is unusable, fall back to the next-newest".

    Returns the corrupted file's path.
    """
    import json
    directory = Path(directory)
    if step is None:
        from repro_torch.checkpoint.store import latest_step
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    base = directory / f"step_{step:08d}"
    with open(base / "manifest.json") as f:
        manifest = json.load(f)
    files = sorted(info["file"] for info in manifest["leaves"].values())
    target = base / files[leaf_index % len(files)]
    data = bytearray(target.read_bytes())
    if not data:
        raise ValueError(f"empty leaf file {target}")
    pos = random.Random(seed).randrange(len(data))
    data[pos] ^= 0xFF
    target.write_bytes(bytes(data))
    return target


def corrupt_tuning_db(db_or_path, seed: int = 0,
                      mode: str = "garbage") -> Path:
    """Corrupt a TuningDB file in place: ``"garbage"`` overwrites it with
    deterministic non-JSON bytes, ``"truncate"`` cuts it mid-document.
    The DB's robustness contract is that both load as empty with a
    warning — plan construction must never crash on tuning state."""
    path = Path(getattr(db_or_path, "path", db_or_path))
    if mode == "truncate":
        raw = path.read_bytes() if path.exists() else b'{"version": 1'
        path.write_bytes(raw[:max(1, len(raw) // 2)])
    elif mode == "garbage":
        rng = random.Random(seed)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(bytes(rng.randrange(256) for _ in range(64)))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path


@contextlib.contextmanager
def hold_tuning_db_lock(db):
    """Hold the TuningDB's advisory flock for the duration of the block
    (a wedged lock-holder): any concurrent ``put``/``clear`` must hit its
    acquisition timeout and degrade to in-memory tuning instead of
    hanging the trainer.  No-op (still yields) where flock is
    unavailable."""
    try:
        import fcntl
    except ImportError:                       # non-POSIX: nothing to hold
        yield None
        return
    lockfile = db.path.with_name(db.path.name + ".lock")
    lockfile.parent.mkdir(parents=True, exist_ok=True)
    with open(lockfile, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield lockfile
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


__all__ = [
    "FAULT_KINDS",
    "DeviceLossError",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "corrupt_checkpoint_leaf",
    "corrupt_tuning_db",
    "hold_tuning_db_lock",
]
