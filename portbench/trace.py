"""The device trace of a traced run: ``torch.profiler`` over a bounded
steady window, exported as a Chrome trace into the checkout's
``.portbench/`` folder, read back and deleted.

A :class:`Trace` keeps the device operations (kernels, copies, sets), the
host's launch calls, its ops and the benchmark's own ``record_function``
ranges, and answers what the per-layer readers ask: device time by
kernel name, device time of what was launched inside a range, the busy
union on the device, the largest device operations and the longest idle
gaps with what the host was doing in each.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
SCRATCH = Path(__file__).resolve().parents[1] / ".portbench"


@dataclass
class Trace:
    window_s: float
    device: list = field(default_factory=list)   # (name, ts_us, dur_us, corr)
    host: list = field(default_factory=list)     # (name, ts_us, dur_us, tid)

    # -- device time --------------------------------------------------------
    def device_seconds(self, patterns=None) -> float:
        """Device seconds of the operations whose name holds any of
        ``patterns`` (all operations with None)."""
        return sum(d for n, _, d, _ in self.device
                   if patterns is None or any(p in n for p in patterns)) \
            / 1e6

    def busy_intervals(self) -> list:
        iv = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    # -- breakdown ----------------------------------------------------------
    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, dur, _ in self.device:
            by[name] = by.get(name, 0.0) + dur / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device work, each named by the
        innermost host op running at its middle."""
        iv = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])),
                      reverse=True)[:n]
        out = []
        for length, a, b in gaps:
            mid = (a + b) / 2
            inner = [(dur, name) for name, ts, dur, _ in self.host
                     if ts <= mid < ts + dur]
            what = min(inner)[1] if inner else "host: outside any op"
            out.append([what[:160], length / 1e6])
        return out


def _events(path: Path):
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", data) if isinstance(data, dict) else data


def read_chrome_trace(path: Path, window_s: float) -> Trace:
    tr = Trace(window_s=window_s)
    for ev in _events(path):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name, ts, dur = ev.get("name", ""), float(ev.get("ts", 0)), \
            float(ev.get("dur", 0))
        args = ev.get("args", {}) or {}
        if cat in DEVICE_CATS:
            tr.device.append((name, ts, dur, args.get("correlation")))
        elif cat in HOST_CATS:
            tr.host.append((name, ts, dur, ev.get("tid")))
    return tr


def capture(fn, synchronize, tag: str = "0") -> tuple:
    """Run ``fn()`` under ``torch.profiler`` (host and device) and return
    ``(fn's result, Trace)``; the window is ``fn`` and the synchronise
    after it, on the host's clock."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if synchronize is not None:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if synchronize is not None:
            synchronize()
        window = time.perf_counter() - t0
    SCRATCH.mkdir(exist_ok=True)
    path = SCRATCH / f"trace-{os.getpid()}-{tag}.json"
    try:
        prof.export_chrome_trace(str(path))
        return out, read_chrome_trace(path, window)
    finally:
        path.unlink(missing_ok=True)
