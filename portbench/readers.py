"""What the per-layer metric files (``metrics/<name>.py``) share: each
file names the kernels or the work it reads and calls one of these.  A
reader that finds nothing to read returns None, and the metric is left
out of the result line."""

from __future__ import annotations

from . import work


def roofline(ctx, patterns, work_key: str):
    """Share (%) of the least time the work needs (``ctx.work[work_key]``,
    seconds) in the device time of the kernels named by ``patterns``."""
    t = ctx.trace.device_seconds(patterns) if ctx.trace else 0.0
    need = ctx.work.get(work_key)
    if not t or need is None:
        return None
    return 100.0 * need / t


def mfu(ctx):
    flops = ctx.work.get("model_flops")
    if not flops or not ctx.window_s:
        return None
    return work.mfu(flops, ctx.window_s)


def idle(ctx):
    """Share (%) of the traced window in which no device operation ran."""
    if not ctx.trace or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
