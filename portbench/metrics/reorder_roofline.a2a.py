"""The reorder kernels' share (%) of their roofline: every launched
pack / unpack / repack pass reads its input once and writes its output
once, against the device time of the row-map kernel, over every rank."""

from portbench import work

KERNELS = ("row_map_kernel",)


def read(ctx):
    n = ctx.work.get("reorder_bytes")
    t = ctx.trace.device_seconds(KERNELS) if ctx.trace else 0.0
    if not n or not t:
        return None
    return 100.0 * work.reorder_bound_s(n) / t
