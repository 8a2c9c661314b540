"""Distributed workloads built on the torus collectives (port of
``repro.workloads``).

The pencil-decomposition FFT (``workloads.fft``): every global transpose
of the multidimensional FFT is a cached
:class:`~repro_torch.core.plan.TransposePlan`, the paper's factorized
all-to-all carrying one contiguous pencil chunk per peer.
"""

from .fft import PencilFFT, pencil_fft

__all__ = ["PencilFFT", "pencil_fft"]
