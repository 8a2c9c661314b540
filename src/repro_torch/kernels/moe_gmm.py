"""Grouped (per-expert) matmul: the MoE expert FFN's kernel.

Port of ``repro.kernels.moe_gmm.grouped_matmul`` (Pallas) to CUDA C++ for
Hopper (``csrc/grouped_matmul.cu``, which says what bounds it and how it
is built).  :func:`grouped_matmul` launches that kernel on a CUDA tensor
and takes :func:`grouped_matmul_plain` on a CPU tensor; there is no other
fallback.  :class:`GroupedMatmulFn` makes it differentiable: its backward
is two more grouped matmuls through the same wrapper, on transposed views.

The kernel has three variants, chosen by :func:`variant` from the shapes,
dtype and operand layouts (an explicit dispatch between hand-written
kernels, each counted in ``grouped_matmul.variant_launches``):

* ``"wgmma"``: bf16 with K and N (and C, for a C-major lhs) multiples of
  8 and 16-byte aligned bases: TMA loads and wgmma on the tensor cores;
* ``"decode"``: the same, with C <= 16 and both operands in their natural
  layout: a bandwidth path with mma.sync;
* ``"simt"``: everything else (f32, unaligned shapes or bases): f32 FMA.

Each operand is read in one of two layouts and nothing else: lhs
``(E, C, K)`` row-major (``"k"``, K contiguous) or the view ``x^T`` of a
row-major ``(E, K, C)`` (``"mn"``); rhs ``(E, K, N)`` row-major (``"mn"``,
N contiguous) or the view ``w^T`` of a row-major ``(E, N, K)`` (``"k"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ref_gmm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
VARIANTS = ("simt", "wgmma", "decode")
DECODE_ROWS = 16          # C at or below which the decode variant runs
INT_MAX = 2 ** 31 - 1     # E, C, K, N cross the C interface as int
GRID_YZ_MAX = 65535       # CUDA's limit on a grid's y and z dims
TMA_STRIDE_LIMIT = 2 ** 40  # cuTensorMapEncodeTiled: a stride's bytes


def grouped_matmul_plain(lhs, rhs):
    """The plain version: (E, C, K) @ (E, K, N) -> (E, C, N), summed in
    f32, in lhs's dtype."""
    return ref_gmm(lhs, rhs)


def _major(t, name: str, natural: str, transposed: str) -> str:
    if t.is_contiguous():
        return natural
    if t.transpose(1, 2).is_contiguous():
        return transposed
    raise ValueError(f"grouped_matmul reads {name} {tuple(t.shape)} row-major "
                     f"or as the transpose of a row-major tensor; got strides "
                     f"{t.stride()}")


def _check(lhs, rhs) -> tuple[str, str]:
    """Validate the operands; return their layouts ``(lhs, rhs)``, each
    ``"k"`` (the contraction dim contiguous) or ``"mn"``."""
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
    if max(E, C, K, rhs.shape[2]) > INT_MAX:
        raise ValueError(f"grouped_matmul passes E, C, K and N as 32-bit "
                         f"ints; got {tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    return (_major(lhs, "lhs", "k", "mn"), _major(rhs, "rhs", "mn", "k"))


def _check_launch(E: int, C: int, K: int, N: int, which: str) -> None:
    """Refuse a call that the variant ``which`` cannot launch: a grid's y
    or z dimension past the CUDA limit, or (wgmma) a TMA tensor map whose
    per-expert stride reaches 2^40 bytes.  Element offsets are 64-bit in
    every variant, so no element count is limited."""
    if which == "wgmma":
        grid_yz = (-(-N // 256), E)
        if 2 * max(C * K, K * N) >= TMA_STRIDE_LIMIT:
            raise ValueError(f"grouped_matmul (wgmma): an expert's slice of "
                             f"(E={E}, C={C}, K={K}, N={N}) reaches "
                             f"the TMA stride limit of 2^40 bytes")
    elif which == "decode":
        grid_yz = (E,)
    else:
        grid_yz = (-(-C // (8 if C <= 8 else 128)), E)
    if max(grid_yz) > GRID_YZ_MAX:
        raise ValueError(f"grouped_matmul ({which}): grid dims {grid_yz} of "
                         f"(E={E}, C={C}, K={K}, N={N}) exceed the CUDA "
                         f"limit {GRID_YZ_MAX}")


def variant(E: int, C: int, K: int, N: int, dtype,
            layouts: tuple[str, str] = ("k", "mn"),
            aligned: bool = True) -> str:
    """The kernel variant a call of these shapes, dtype and operand
    layouts takes (``aligned``: both bases 16-byte aligned)."""
    if dtype != torch.bfloat16 or not aligned or K == 0 or K % 8 or N % 8:
        return "simt"
    if C <= DECODE_ROWS and layouts == ("k", "mn"):
        return "decode"
    if layouts[0] == "mn" and C % 8:
        return "simt"
    return "wgmma"


def grouped_matmul(lhs, rhs, *, force: str | None = None):
    """(E, C, K) @ (E, K, N) -> (E, C, N), one independent product per
    expert, f32 sums, output in the operands' dtype.

    On a CUDA tensor this launches the Hopper kernel's :func:`variant`, or
    the variant ``force`` names (a check on the card compares variants; the
    kernel refuses one that cannot take the call), and counts the launch in
    ``grouped_matmul.launches`` and ``grouped_matmul.variant_launches``; on
    a CPU tensor it returns the plain version."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, "
                         f"not {lhs.device}")
    layouts = _check(lhs, rhs)
    E, C, K = lhs.shape
    N = rhs.shape[2]
    which = force or variant(E, C, K, N, lhs.dtype, layouts, aligned=all(
        t.data_ptr() % 16 == 0 for t in (lhs, rhs)))
    _check_launch(E, C, K, N, which)
    out = torch.empty((E, C, N), dtype=lhs.dtype, device=lhs.device)
    fn = build.load("grouped_matmul").repro_grouped_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = fn(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), E, C, K, N,
                 int(layouts[0] == "mn"), int(layouts[1] == "k"),
                 _DTYPES[lhs.dtype], VARIANTS.index(which), stream)
    if err:
        raise RuntimeError(f"grouped_matmul kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    grouped_matmul.launches += 1
    grouped_matmul.variant_launches[which] += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.variant_launches = dict.fromkeys(VARIANTS, 0)


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` with its gradient through the same kernel:
    ``dlhs = gmm(dout, rhs^T)`` and ``drhs = gmm(lhs^T, dout)``, the
    transposes passed as views (the kernel reads both layouts; nothing is
    copied).  (The JAX model differentiates its ``ref_gmm``, the reference
    has no backward kernel.)  Apply as ``GroupedMatmulFn.apply(lhs,
    rhs)``."""

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
            dlhs = grouped_matmul(dout, rhs.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            drhs = grouped_matmul(lhs.transpose(1, 2), dout)
        return dlhs, drhs
