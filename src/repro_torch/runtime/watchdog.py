"""Straggler / hang detection and the escalation policy (port of
``repro.runtime.watchdog``).

:class:`StragglerWatchdog` keeps a robust running estimate of the step
time (median and MAD over a window) and classifies each step as "ok",
"straggler" or "hang".  :class:`EscalationPolicy` turns verdicts into an
:class:`Action` (bounded retry with backoff, recovery, abort), which the
elastic trainer drives on (the non-elastic one uses only the hang
verdict); :meth:`StragglerWatchdog.check_drift` routes the telemetry drift
detector's re-tune recommendations through the policy as advisory
"retune" actions.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core import telemetry

VERDICTS = ("ok", "straggler", "hang", "device_loss", "drift")
ACTIONS = ("continue", "retry", "recover", "abort", "retune")


@dataclass(frozen=True)
class Action:
    """One escalation decision: "continue", "retry" (after ``backoff``
    seconds), "recover" (checkpoint now, rebuild, restore, resume),
    "abort" (checkpoint and raise) or "retune" (advisory)."""

    kind: str
    backoff: float = 0.0
    reason: str = ""

    def __post_init__(self):
        if self.kind not in ACTIONS:
            raise ValueError(f"unknown action {self.kind!r}")


@dataclass
class EscalationPolicy:
    """Bounded-retry escalation: verdicts in, :class:`Action` out.

    ``ok`` closes an open incident; ``straggler`` retries with exponential
    backoff up to ``max_retries`` times in a row, then counts as a hang;
    ``hang`` / ``device_loss`` recover up to ``max_recoveries`` times per
    run, then abort; an incident open longer than ``incident_timeout``
    seconds aborts; ``drift`` is advisory ("retune").  ``decide`` takes an
    optional ``now`` (monotonic seconds) for deterministic tests.
    """

    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    max_recoveries: int = 2
    incident_timeout: float = 300.0
    retries: int = 0
    recoveries: int = 0
    transitions: deque = field(default_factory=lambda: deque(maxlen=256))
    _incident_start: float | None = None

    def decide(self, verdict, now: float | None = None) -> Action:
        kind = str(verdict)
        if kind not in VERDICTS:
            raise ValueError(f"unknown verdict {kind!r}; "
                             f"expected one of {VERDICTS}")
        now = time.monotonic() if now is None else now
        action = self._decide(kind, now)
        self.transitions.append((kind, action.kind))
        return action

    def _decide(self, kind: str, now: float) -> Action:
        if kind == "ok":
            self.retries = 0
            self._incident_start = None
            return Action("continue")
        if kind == "drift":
            return Action("retune",
                          reason="measured/model drift above threshold")
        if self._incident_start is None:
            self._incident_start = now
        open_for = now - self._incident_start
        if open_for > self.incident_timeout:
            return Action("abort",
                          reason=f"incident open {open_for:.1f}s > "
                                 f"timeout {self.incident_timeout}s")
        if kind == "straggler":
            if self.retries < self.max_retries:
                self.retries += 1
                backoff = self.backoff_base \
                    * self.backoff_factor ** (self.retries - 1)
                return Action("retry", backoff=backoff,
                              reason=f"straggler retry "
                                     f"{self.retries}/{self.max_retries}")
            kind = "hang"   # persistent straggler: escalate
        if self.recoveries < self.max_recoveries:
            self.recoveries += 1
            self.retries = 0
            return Action("recover",
                          reason=f"{kind}: recovery "
                                 f"{self.recoveries}/{self.max_recoveries}")
        return Action("abort",
                      reason=f"{kind}: recovery budget "
                             f"({self.max_recoveries}) exhausted")

    def reset(self) -> None:
        """Forget all streaks and budgets (a fresh run)."""
        self.retries = 0
        self.recoveries = 0
        self._incident_start = None


@dataclass
class StragglerWatchdog:
    window: int = 50
    slow_factor: float = 2.5       # step > factor * median -> straggler
    hang_factor: float = 10.0      # step > factor * median -> presumed hang
    # absolute floor for the (fatal) hang verdict, so that scheduling
    # jitter on a millisecond-scale median is never taken for a hang
    hang_floor_seconds: float = 1.0
    min_samples: int = 5
    # anomalous-step events are bounded; overflow is counted, not kept
    max_events: int = 512
    events_dropped: int = 0
    last_verdict: str = "ok"
    escalation: EscalationPolicy = field(default_factory=EscalationPolicy)
    _times: deque = field(default_factory=lambda: deque(maxlen=256))
    events: deque = None

    def __post_init__(self):
        if self.events is None:
            self.events = deque(maxlen=self.max_events)

    def _record(self, event: tuple) -> None:
        if len(self.events) == self.events.maxlen:
            self.events_dropped += 1
            telemetry.metrics().counter("watchdog.events_dropped").inc()
            telemetry.warn_once(
                self, "_warned_events_dropped",
                f"watchdog event window full (max_events="
                f"{self.events.maxlen}); oldest anomaly events are being "
                f"dropped — see watchdog.events_dropped for the count")
        self.events.append(event)

    def observe(self, step: int, seconds: float) -> str:
        """Classify a step: 'ok' | 'straggler' | 'hang'."""
        history = list(self._times)[-self.window:]
        self._times.append(seconds)
        if len(history) < self.min_samples:
            return "ok"
        med = statistics.median(history)
        mad = statistics.median([abs(t - med) for t in history]) or 1e-9
        if seconds > max(self.hang_factor * med, med + 20 * mad) \
                and seconds >= self.hang_floor_seconds:
            self._record(("hang", step, seconds, med))
            return "hang"
        if seconds > max(self.slow_factor * med, med + 8 * mad):
            self._record(("straggler", step, seconds, med))
            return "straggler"
        return "ok"

    def policy(self, step: int, seconds: float, *,
               verdict: str | None = None,
               now: float | None = None) -> Action:
        """Classify the step (or take an externally detected ``verdict``)
        and run it through the escalation policy."""
        if verdict is None:
            verdict = self.observe(step, seconds)
        elif verdict != "ok":
            self._record((verdict, step, seconds, self.median))
        self.last_verdict = verdict
        action = self.escalation.decide(verdict, now=now)
        if action.kind != "continue":
            self._record((f"action:{action.kind}", step, seconds,
                          action.reason))
        return action

    def check_drift(self, detector=None, step: int | None = None):
        """Poll the telemetry :class:`~repro_torch.core.telemetry
        .DriftDetector` for fresh re-tune recommendations and route each
        through the escalation policy as a "drift" verdict (→ "retune"
        action, advisory — no retry/recovery budget is consumed).

        Returns a list of ``(drift_key, Action)`` pairs, one per newly
        recommended key (empty when nothing drifted — the common case;
        cheap enough to call every step).
        """
        detector = telemetry.drift_detector() if detector is None \
            else detector
        out = []
        for rec in detector.recommendations():
            self._record(("drift", step, rec["ratio"], rec["key"]))
            action = self.escalation.decide("drift")
            self.last_verdict = "drift"
            out.append((rec["key"], action))
        return out

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
