"""Grouped (per-expert) matmul: the MoE expert FFN's kernel.

Port of ``repro.kernels.moe_gmm.grouped_matmul`` (Pallas) to a CUDA C++
kernel for Hopper (``csrc/grouped_matmul.cu``, which says what bounds it
and how it is built).  :func:`grouped_matmul` launches that kernel on a
CUDA tensor and takes :func:`grouped_matmul_plain` on a CPU tensor; there
is no other fallback.  :class:`GroupedMatmulFn` makes it differentiable:
its backward is two more grouped matmuls through the same wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ref_gmm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def grouped_matmul_plain(lhs, rhs):
    """The plain version: (E, C, K) @ (E, K, N) -> (E, C, N), summed in
    f32, in lhs's dtype."""
    return ref_gmm(lhs, rhs)


def _check(lhs, rhs):
    if lhs.dim() != 3 or rhs.dim() != 3:
        raise ValueError(f"grouped_matmul takes (E, C, K) @ (E, K, N); got "
                         f"{tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    E, C, K = lhs.shape
    if rhs.shape[:2] != (E, K):
        raise ValueError(f"shape mismatch {tuple(lhs.shape)} @ "
                         f"{tuple(rhs.shape)}")
    if lhs.dtype not in _DTYPES or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul takes float32 or bfloat16 operands "
                        f"of one dtype; got {lhs.dtype} and {rhs.dtype}")
    if rhs.device != lhs.device:
        raise ValueError(f"operands on {lhs.device} and {rhs.device}")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_matmul takes contiguous operands")
    if max(lhs.numel(), rhs.numel(), E * C * rhs.shape[2]) >= 2 ** 31:
        raise ValueError("grouped_matmul indexes each expert's slice "
                         "with 32-bit ints")


def grouped_matmul(lhs, rhs):
    """(E, C, K) @ (E, K, N) -> (E, C, N), one independent product per
    expert, f32 sums, output in the operands' dtype.

    On a CUDA tensor this launches the Hopper kernel (and counts the
    launch in ``grouped_matmul.launches``); on a CPU tensor it returns the
    plain version."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, "
                         f"not {lhs.device}")
    _check(lhs, rhs)
    E, C, K = lhs.shape
    N = rhs.shape[2]
    out = torch.empty((E, C, N), dtype=lhs.dtype, device=lhs.device)
    fn = build.load("grouped_matmul").repro_grouped_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = fn(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), E, C, K, N,
                 _DTYPES[lhs.dtype], stream)
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA "
                           f"error {err}")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` with its gradient through the same kernel:
    ``dlhs = gmm(dout, rhs^T)`` and ``drhs = gmm(lhs^T, dout)``, the
    transposes made contiguous.  (The JAX model differentiates its
    ``ref_gmm``, the reference has no backward kernel.)  Apply as
    ``GroupedMatmulFn.apply(lhs, rhs)``."""

    @staticmethod
    def forward(ctx, lhs, rhs):
        ctx.save_for_backward(lhs, rhs)
        return grouped_matmul(lhs, rhs)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_matmul(dout, rhs.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            drhs = grouped_matmul(lhs.transpose(1, 2).contiguous(), dout)
        return dlhs, drhs
