"""Flash-attention forward: the full-sequence prefill's attention kernel.

Port of ``repro.kernels.flash_attention.flash_attention`` (Pallas) to a
CUDA C++ kernel for Hopper (``csrc/flash_attention.cu``, which says what
bounds it and how it is built).  :func:`flash_attention` launches that
kernel on a CUDA tensor and takes :func:`flash_attention_plain` on a CPU
tensor; there is no other fallback.

The kernel has two variants, chosen by :func:`variant` from the head dim,
dtype and alignment (an explicit dispatch between hand-written kernels,
each counted in ``flash_attention.variant_launches``):

* ``"wgmma"``: bf16 at head dims 64, 80 and 128 with 16-byte aligned
  bases: TMA loads and wgmma on the tensor cores (head dim 80 in the
  128-column tile, its columns past 80 zero-filled; ``csrc/
  flash_attention.cu`` says how it keeps the softmax to the plain
  version's f32 arithmetic);
* ``"simt"``: everything else (f32, which the tensor cores would round to
  tf32; head dims 16 and 32; unaligned bases): f32 FMA throughout.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import ref_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)
VARIANTS = ("simt", "wgmma")
WGMMA_HEAD_DIMS = (64, 80, 128)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None, kv_offset: int = 0):
    """The plain version: the reference attention computed in f32 (as the
    kernel computes), output in q's dtype; fully masked rows give 0."""
    out = ref_attention(q.float(), k.float(), v.float(), causal=causal,
                        window=window, scale=scale, kv_offset=kv_offset)
    return out.to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, Dh) and k, v "
                         f"(B, Hkv, Skv, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[1]}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"not {Dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 inputs "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k and v")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention indexes with 32-bit ints")


def variant(Dh: int, dtype, aligned: bool = True) -> str:
    """The kernel variant a call with this head dim and dtype takes
    (``aligned``: q, k and v 16-byte aligned)."""
    if dtype == torch.bfloat16 and Dh in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "simt"


def choose(q, k, v, force: str | None = None) -> str:
    """The variant a call on q, k, v runs: :func:`variant`'s, or ``force``
    (checks on the card compare the variants).  A call with no kv row
    (every output row 0) takes SIMT, since the wgmma variant's tensor maps
    need one.  Raises ValueError for a ``force`` that names no variant or
    a variant that cannot take the call; the kernel refuses an unaligned
    wgmma call."""
    Dh, Skv = q.shape[-1], k.shape[2]
    if force is None:
        return variant(Dh, q.dtype, aligned=all(
            t.data_ptr() % 16 == 0 for t in (q, k, v))) if Skv else "simt"
    if force not in VARIANTS:
        raise ValueError(f"flash attention has variants {VARIANTS}, not "
                         f"{force!r}")
    if force == "wgmma" and (variant(Dh, q.dtype) != "wgmma" or not Skv):
        raise ValueError(f"the wgmma variant takes bfloat16 at head dims "
                         f"{WGMMA_HEAD_DIMS} and at least one kv row; got "
                         f"{q.dtype}, Dh {Dh}, Skv {Skv}")
    return force


def numerics() -> dict:
    """The wgmma variant's compile-time numerics, read from its library
    (so it builds the kernel: card only): ``p_parts``, the bf16 terms P
    enters P V in, and ``resum_min`` / ``resum_window``, the largest |x|
    from which a row's logits within ``resum_window`` of its running max
    are re-summed in order (``csrc/flash_attention.cu`` says why)."""
    fn = build.load("flash_attention").repro_flash_numerics
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 3, None
    parts, lo, window = ctypes.c_int(), ctypes.c_float(), ctypes.c_float()
    fn(ctypes.byref(parts), ctypes.byref(lo), ctypes.byref(window))
    return {"p_parts": parts.value, "resum_min": lo.value,
            "resum_window": window.value}


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    kv_offset: int = 0, force: str | None = None):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); Hq % Hkv == 0.

    Returns (B, Hq, Sq, Dh) attention output in q's dtype.  On a CUDA
    tensor this launches the Hopper kernel's :func:`variant`, or the one
    ``force`` names (:func:`choose`), and counts the launch in
    ``flash_attention.launches`` and ``flash_attention.variant_launches``;
    on a CPU tensor it returns the plain version (``force`` is still
    checked)."""
    if q.device.type == "cpu":
        if force is not None:
            choose(q, k, v, force)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    which = choose(q, k, v, force)
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    out = torch.empty_like(q)
    fn = build.load("flash_attention").repro_flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Sq, Skv, Dh, int(causal),
                 int(window is not None), int(window or 0), int(kv_offset),
                 float(scale), _DTYPES[q.dtype], VARIANTS.index(which),
                 stream)
    if err:
        raise RuntimeError(f"flash_attention kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.variant_launches[which] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
