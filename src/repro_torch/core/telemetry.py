"""Metrics registry (the counter part of ``repro.core.telemetry``).

Only what the serving path uses is ported: :class:`Counter`,
:class:`MetricsRegistry` (counters only) and the process-wide
:func:`metrics`.  The tracer, gauges, histograms, snapshots and the drift
detector wait for the slices that use them (ROADMAP).
"""

from __future__ import annotations

import threading


class Counter:
    """Monotonic counter.  Mutation holds the registry lock — metric
    updates happen at host-level events (a serving tick), never inside a
    kernel."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class MetricsRegistry:
    """Namespaced metric store: ``registry.counter("serving.x").inc()``.

    Re-requesting a name returns the same counter.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(self._lock)
        return m


_METRICS = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _METRICS
