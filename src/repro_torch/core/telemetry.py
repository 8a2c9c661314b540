"""Tracing, metrics and drift detection (port of ``repro.core.telemetry``;
stdlib only, so every layer imports it without cycles).

* :class:`Tracer` — spans on the monotonic clock with nesting, a bounded
  ring buffer and thread safety.  **Off by default**: ``tracer.span()``
  then returns a shared no-op context manager, and the plans' execution
  methods (``core.plan``) pay one attribute load and a branch.  On, a
  plan call runs under a ``plan.execute`` span with ``plan.round``
  children (the factorized plan's rounds one by one, the same reorder
  passes and exchanges as the untraced call; every other backend one
  fused span), each ending in a device synchronise.
* :class:`MetricsRegistry` — namespaced counters, gauges and histograms,
  plus registered *stats providers* (``cache_stats``,
  ``plan_cache_stats``, ``autotune_stats``, the comm registry) folded
  into one flat :func:`metrics_snapshot`, which
  ``TorusComm.unified_stats()`` reports under ``"telemetry"``.
* :meth:`Tracer.export_chrome_trace` — Chrome ``trace_event`` JSON
  (Perfetto), to set beside a ``torch.profiler`` trace.
* :class:`DriftDetector` — measured-over-model ratios per plan and per
  torus axis, fed by the traced execution; a ratio above ``threshold``
  yields one re-tune recommendation, which
  ``runtime.watchdog.StragglerWatchdog.check_drift`` routes through its
  escalation policy (``Action(kind="retune")``).

The rest of the port registers providers with, and emits spans into, the
module singletons (:func:`get_tracer`, :func:`metrics`,
:func:`drift_detector`).
"""

from __future__ import annotations

import json
import math
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "DriftDetector",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "disable_tracing",
    "drift_detector",
    "enable_tracing",
    "get_tracer",
    "metrics",
    "metrics_snapshot",
    "register_stats_provider",
    "reset_telemetry",
]


# ---------------------------------------------------------------------------
# Spans + Tracer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Span:
    """One completed span: ``[start, start + duration)`` on the
    ``time.perf_counter`` clock, with the attributes set during the
    span's body.  ``parent_id`` is the enclosing span on the same thread
    (``None`` at top level), giving the export a proper nesting tree."""

    name: str
    start: float                   # perf_counter seconds
    duration: float                # seconds
    span_id: int
    parent_id: int | None
    thread_id: int
    attrs: dict


class _NullSpan:
    """The disabled-tracer span: a shared, stateless no-op context
    manager — entering, exiting, and ``set()`` all cost one method
    dispatch and allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _ActiveSpan:
    """A live span (enabled tracer): records itself into the ring buffer
    on exit.  Exceptions propagate — the span still closes, tagged with
    the exception type so the trace shows *where* a run died."""

    __slots__ = ("_tracer", "name", "attrs", "start", "span_id",
                 "parent_id", "thread_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = tr._next_id()
        self.thread_id = threading.get_ident()
        stack.append(self.span_id)
        self.start = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. a result size known only
        after the body ran)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs["exception"] = exc_type.__name__
        self._tracer._record(Span(self.name, self.start, end - self.start,
                                  self.span_id, self.parent_id,
                                  self.thread_id, dict(self.attrs)))
        return False


class Tracer:
    """Span recorder over a bounded ring buffer.

    ``enabled`` gates everything: when ``False`` (the default),
    :meth:`span` returns the shared :data:`_NULL_SPAN` and no state is
    touched, and a plan call with tracing off records nothing and never
    enters the traced path (``tests/test_torch_telemetry.py``).  The
    ring buffer (``capacity`` completed spans) makes a week-long run
    safe to trace: overflow evicts the oldest span and bumps
    ``dropped`` instead of growing without bound.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = False):
        self.enabled = bool(enabled)
        self.dropped = 0
        self._buf: deque[Span] = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._id = 0
        self._epoch = time.perf_counter()

    # -- internals ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(self, span: Span) -> None:
        with self._lock:
            if self._buf.maxlen is not None \
                    and len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    # -- public surface ----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def span(self, name: str, **attrs):
        """Open a span context manager; a no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _ActiveSpan(self, name, attrs)

    def spans(self) -> list[Span]:
        """Snapshot of the completed spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "spans": len(self._buf),
                    "capacity": self._buf.maxlen or 0,
                    "dropped": self.dropped}

    def export_chrome_trace(self, path=None) -> dict:
        """The spans as a Chrome ``trace_event`` document (Perfetto /
        ``chrome://tracing`` loadable).  Complete spans map to ``"X"``
        (duration) events; timestamps are microseconds since the
        tracer's epoch so the timeline starts near zero.  Writes JSON to
        ``path`` when given; always returns the document."""
        events = []
        for s in self.spans():
            args = {k: v for k, v in s.attrs.items()
                    if isinstance(v, (str, int, float, bool, type(None)))}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": (s.start - self._epoch) * 1e6,
                "dur": s.duration * 1e6,
                "pid": 1,
                "tid": s.thread_id % (1 << 31),
                "cat": str(s.attrs.get("cat", s.name.split(".")[0])),
                "args": args,
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"exporter": "repro_torch.core.telemetry",
                             "dropped_spans": self.dropped}}
        if path is not None:
            Path(path).write_text(json.dumps(doc, indent=1))
        return doc


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter.  Mutation holds the registry lock — metric
    updates happen at host-level events (plan execute, watchdog verdict,
    serving tick), never inside a kernel."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = None

    def set(self, v) -> None:
        with self._lock:
            self.value = v


class Histogram:
    """Streaming summary: count / total / min / max / last (no buckets —
    the snapshot is for dashboards and regression gates, not quantile
    estimation)."""

    __slots__ = ("_lock", "count", "total", "min", "max", "last")

    def __init__(self, lock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.last = v

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {"count": self.count, "total": self.total,
                    "mean": self.total / self.count,
                    "min": self.min, "max": self.max, "last": self.last}


class MetricsRegistry:
    """Namespaced metric store: ``registry.counter("plan.exec").inc()``.

    Names are dotted namespaces (``watchdog.events_dropped``,
    ``serving.admitted``); :meth:`snapshot` returns the flat
    ``{name: value}`` dict (histograms expand to summary sub-dicts).
    Re-requesting a name returns the same metric; requesting it as a
    different type raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self._lock)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in sorted(items):
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# Stat providers: fold the pre-existing scattered stats dicts in
# ---------------------------------------------------------------------------


_PROVIDERS: dict[str, object] = {}
_PROVIDERS_LOCK = threading.Lock()


def register_stats_provider(namespace: str, fn) -> None:
    """Register ``fn() -> dict`` so its flat keys appear in
    :func:`metrics_snapshot` as ``<namespace>.<key>``.  Later
    registrations under the same namespace replace earlier ones
    (module reload safety)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[str(namespace)] = fn


def metrics_snapshot() -> dict:
    """The unified namespaced snapshot: every registered provider's dict
    flattened under its namespace, merged with the live registry.
    Scalar provider values keep ``ns.key``; nested dicts flatten one
    more level (``ns.key.subkey``).  A crashing provider contributes an
    ``ns.error`` string instead of taking the snapshot down."""
    with _PROVIDERS_LOCK:
        providers = list(_PROVIDERS.items())
    out = {}
    for ns, fn in sorted(providers):
        try:
            stats = fn()
        except Exception as e:                      # pragma: no cover
            out[f"{ns}.error"] = f"{type(e).__name__}: {e}"
            continue
        for k, v in stats.items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    out[f"{ns}.{k}.{k2}"] = v2
            else:
                out[f"{ns}.{k}"] = v
    out.update(metrics().snapshot())
    return out


# ---------------------------------------------------------------------------
# Drift detection: measured vs model
# ---------------------------------------------------------------------------


class DriftDetector:
    """Measured-vs-model drift per key (a plan, or one plan axis).

    :meth:`observe` records ``measured / predicted`` ratios into a
    per-key window; the key's ``drift_ratio`` is the *median* ratio once
    ``min_samples`` have arrived (median, not mean — one GC pause must
    not flag a re-tune).  A key whose ratio crosses ``threshold``
    becomes *drifted* and yields exactly one re-tune recommendation via
    :meth:`recommendations` until it recovers below threshold (then it
    re-arms), so the watchdog isn't spammed every step while the
    condition persists.
    """

    def __init__(self, threshold: float = 1.5, window: int = 32,
                 min_samples: int = 3):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._ratios: dict[str, deque] = {}
        self._last: dict[str, tuple] = {}       # key -> (pred, meas)
        self._recommended: set[str] = set()

    def observe(self, key: str, predicted_seconds: float,
                measured_seconds: float) -> float | None:
        """Record one execution; returns the key's current drift ratio
        (``None`` until ``min_samples``).  Non-positive predictions are
        ignored — an unfitted model must not divide by zero."""
        if predicted_seconds is None or predicted_seconds <= 0.0:
            return None
        key = str(key)
        ratio = float(measured_seconds) / float(predicted_seconds)
        with self._lock:
            dq = self._ratios.get(key)
            if dq is None:
                dq = self._ratios[key] = deque(maxlen=self.window)
            dq.append(ratio)
            self._last[key] = (float(predicted_seconds),
                               float(measured_seconds))
        metrics().counter("drift.observations").inc()
        return self.drift_ratio(key)

    def drift_ratio(self, key: str) -> float | None:
        """Median measured/predicted ratio, or ``None`` below
        ``min_samples``."""
        with self._lock:
            dq = self._ratios.get(str(key))
            if dq is None or len(dq) < self.min_samples:
                return None
            ratios = sorted(dq)
        n = len(ratios)
        mid = n // 2
        return ratios[mid] if n % 2 else 0.5 * (ratios[mid - 1]
                                                + ratios[mid])

    def drifted(self, key: str) -> bool:
        r = self.drift_ratio(key)
        return r is not None and r > self.threshold

    def summary(self) -> dict:
        """``{key: {ratio, samples, drifted, predicted_seconds,
        measured_seconds}}`` for every observed key."""
        with self._lock:
            keys = list(self._ratios)
        out = {}
        for key in sorted(keys):
            r = self.drift_ratio(key)
            with self._lock:
                dq = self._ratios.get(key) or ()
                pred, meas = self._last.get(key, (None, None))
            out[key] = {"ratio": r, "samples": len(dq),
                        "drifted": r is not None and r > self.threshold,
                        "predicted_seconds": pred,
                        "measured_seconds": meas}
        return out

    def recommendations(self) -> list[dict]:
        """Drain newly drifted keys as re-tune recommendations:
        ``[{key, ratio, threshold, action: "retune"}]``.  Each key
        recommends once per drift episode; a ratio back under threshold
        re-arms it."""
        out = []
        for key, info in self.summary().items():
            with self._lock:
                if info["drifted"] and key not in self._recommended:
                    self._recommended.add(key)
                    fresh = True
                elif not info["drifted"]:
                    self._recommended.discard(key)
                    fresh = False
                else:
                    fresh = False
            if fresh:
                out.append({"key": key, "ratio": info["ratio"],
                            "threshold": self.threshold,
                            "action": "retune"})
                metrics().counter("drift.retune_recommendations").inc()
        return out

    def clear(self) -> None:
        with self._lock:
            self._ratios.clear()
            self._last.clear()
            self._recommended.clear()


# ---------------------------------------------------------------------------
# Module singletons
# ---------------------------------------------------------------------------


_TRACER = Tracer()
_METRICS = MetricsRegistry()
_DRIFT = DriftDetector()


def get_tracer() -> Tracer:
    return _TRACER


def metrics() -> MetricsRegistry:
    return _METRICS


def drift_detector() -> DriftDetector:
    return _DRIFT


def enable_tracing(capacity: int | None = None) -> Tracer:
    """Turn the global tracer on (optionally resizing the ring buffer);
    returns it."""
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER._buf = deque(_TRACER._buf, maxlen=int(capacity))
    _TRACER.enabled = True
    return _TRACER


def disable_tracing() -> Tracer:
    _TRACER.enabled = False
    return _TRACER


def reset_telemetry() -> None:
    """Clear spans, metrics, and drift state (providers stay registered)
    — test isolation."""
    _TRACER.enabled = False
    _TRACER.clear()
    _METRICS.reset()
    _DRIFT.clear()


def warn_once(flag_holder, flag: str, message: str) -> None:
    """Emit ``message`` as a ``RuntimeWarning`` the first time
    ``flag_holder``'s ``flag`` attribute is falsy, then latch it — the
    one-time-warning idiom for bounded-loss pathologies (ring-buffer /
    event-deque overflow)."""
    if not getattr(flag_holder, flag, False):
        try:
            setattr(flag_holder, flag, True)
        except AttributeError:      # frozen dataclass etc.: warn anyway
            pass
        warnings.warn(message, RuntimeWarning, stacklevel=3)
