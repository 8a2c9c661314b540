"""The prefill requests' model FLOPs (the kept expert rows, attention's
causal half, the head at the one position returned) over the traced
window, as a share (%) of the bf16 peak."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
