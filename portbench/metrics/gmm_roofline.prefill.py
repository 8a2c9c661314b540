"""The grouped matmul's share (%) of its roofline in prefill: the least
time of the rows the router keeps (forward products), in the device time
of the gmm kernels."""

from portbench.readers import roofline

KERNELS = ("gmm_",)


def read(ctx):
    return roofline(ctx, KERNELS, "gmm_bound_s")
