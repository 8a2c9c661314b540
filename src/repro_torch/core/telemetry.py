"""Metrics registry (the counter part of ``repro.core.telemetry``).

Ported so far: :class:`Counter`, :class:`MetricsRegistry` (counters
only), the process-wide :func:`metrics`, and the stats providers that
fold the factorization, plan and communicator registries into
:func:`metrics_snapshot`.  The tracer, gauges, histograms and the drift
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


    def snapshot(self) -> dict:
        with self._lock:
            return {name: m.value for name, m in sorted(self._metrics.items())}


_METRICS = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _METRICS


_PROVIDERS: dict = {}


def register_stats_provider(namespace: str, fn) -> None:
    """Register ``fn() -> dict`` so its keys appear in
    :func:`metrics_snapshot` as ``<namespace>.<key>``; a later
    registration under the same namespace replaces the earlier one."""
    _PROVIDERS[str(namespace)] = fn


def metrics_snapshot() -> dict:
    """Every registered provider's dict flattened under its namespace,
    merged with the registry's counters."""
    out = {}
    for ns, fn in sorted(_PROVIDERS.items()):
        for k, v in fn().items():
            out[f"{ns}.{k}"] = v
    out.update(metrics().snapshot())
    return out
