"""Trainable flash attention: the forward that also returns ``lse``, the
FlashAttention-2 backward, and the ``torch.autograd.Function`` that joins
them.

Port of ``repro.kernels.flash_attention_bwd`` (Pallas ``_fwd_kernel``,
``_dq_kernel`` / ``_dkv_kernel`` and the ``custom_vjp``
``flash_attention_trainable``) to CUDA C++ for Hopper:

* :func:`flash_attention_fwd` launches the second entry point of
  ``csrc/flash_attention.cu``, the serving kernel that also writes
  ``lse = m + log(l)`` per row (``l == 0`` counts as 1), in the variant
  ``flash_attention.variant`` picks (``wgmma`` for bf16 at head dims 64,
  80 and 128, ``simt`` otherwise), counted per variant in
  ``flash_attention_fwd.variant_launches``;
* :func:`flash_attention_bwd` launches the dq and the dkv kernel of
  ``csrc/flash_attention_bwd.cu`` (tensor cores for bf16); the dkv kernel
  sums each kv head's group of query heads itself and writes dk / dv as
  ``(B, Hkv, Skv, Dh)``.  ``delta = rowsum(dO * O)`` stays a torch
  reduction in front of them, as it stays outside the Pallas calls.

Each takes its plain version on a CPU tensor and launches its kernel on a
CUDA tensor; there is no other fallback.  :class:`FlashAttentionFn` calls
the two wrappers, so on the CPU its backward is the plain FA2 equations.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .flash_attention import (_DTYPES, VARIANTS, _check, choose,
                              flash_attention_plain)

NEG_INF = -1e30
_ARGTYPES_FWD = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_ARGTYPES_BWD = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                 + [ctypes.c_float] + [ctypes.c_int, ctypes.c_void_p])


def _mask(Sq: int, Skv: int, *, causal, window, kv_offset, device):
    rows = torch.arange(Sq, device=device)[:, None] + kv_offset
    cols = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def _scores(q, k, scale):
    """f32 logits q.k * scale per query head: (B, Hq, Sq, Skv)."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None, kv_offset: int = 0):
    """The plain version: ``(out, lse)`` with out as
    :func:`flash_attention_plain` and ``lse = m + log(l)`` of the masked
    f32 logits, (B, Hq, Sq) f32; a fully masked row has ``l == 0``, counts
    it as 1 and gets ``lse = -1e30``, as the kernels do."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale, kv_offset=kv_offset)
    mask = _mask(q.shape[2], k.shape[2], causal=causal, window=window,
                 kv_offset=kv_offset, device=q.device)
    s = _scores(q, k, scale).masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    l = torch.where(mask, torch.exp(s - m[..., None]), 0.0).sum(-1)
    return out, m + torch.log(torch.where(l == 0, 1.0, l))


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None, kv_offset: int = 0):
    """The plain version: the FlashAttention-2 backward written out on
    full f32 matrices (not autograd of the forward): p recomputed from
    ``lse``, ``delta = rowsum(dO * O)``, ``ds = p * (dp - delta) * scale``;
    dk and dv per query head, summed over each kv head's group.  Returns
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    mask = _mask(Sq, Skv, causal=causal, window=window, kv_offset=kv_offset,
                 device=q.device)
    p = torch.where(mask, torch.exp(_scores(q, k, scale) - lse[..., None]),
                    0.0)
    dof = do.float()
    delta = (dof * out.float()).sum(-1)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dk = dk_h.reshape(B, Hkv, group, Skv, Dh).sum(2)
    dv = dv_h.reshape(B, Hkv, group, Skv, Dh).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _device_args(q, k, causal, window, scale, kv_offset):
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    return [B, Hq, Hkv, Sq, Skv, Dh, int(causal), int(window is not None),
            int(window or 0), int(kv_offset), float(scale),
            _DTYPES[q.dtype]]


def _launch(lib_fn, argtypes, q, *args):
    lib_fn.argtypes, lib_fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib_fn(*args, stream)
    if err:
        raise RuntimeError(f"{lib_fn.__name__} kernel launch failed: CUDA "
                           f"error {err}")


def _on_cuda(name: str, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return True


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        kv_offset: int = 0, force: str | None = None):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).  Returns ``(out,
    lse)``: the attention output in q's dtype and ``lse`` (B, Hq, Sq) f32.

    On a CUDA tensor this launches the Hopper kernel's variant (or the one
    ``force`` names; ``flash_attention.choose``) and counts the launch in
    ``flash_attention_fwd.launches`` and
    ``flash_attention_fwd.variant_launches``; on a CPU tensor it returns
    the plain version (``force`` is still checked)."""
    if not _on_cuda("flash_attention_fwd", q):
        if force is not None:
            choose(q, k, v, force)
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         kv_offset=kv_offset)
    _check(q, k, v)
    which = choose(q, k, v, force)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(build.load("flash_attention").repro_flash_attention_fwd_lse,
            _ARGTYPES_FWD, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *_device_args(q, k, causal, window, scale, kv_offset),
            VARIANTS.index(which))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.variant_launches[which] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        kv_offset: int = 0):
    """The FlashAttention-2 backward: ``(dq, dk, dv)`` in the inputs'
    dtypes, from the forward's ``out`` and ``lse`` and the output
    gradient ``do`` (like q).

    On a CUDA tensor this launches the dq and the dkv kernel (one count
    in ``flash_attention_bwd.launches`` per call); on a CPU tensor it
    returns the plain version."""
    if not _on_cuda("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         scale=scale, kv_offset=kv_offset)
    _check(q, k, v)
    B, Hq, Sq, _ = q.shape
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd takes a contiguous {name} "
                             f"like q {tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd takes a contiguous float32 "
                         f"lse of shape {(B, Hq, Sq)}; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    delta = (do.float() * out.float()).sum(-1)          # (B, Hq, Sq) f32
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch(build.load("flash_attention_bwd").repro_flash_attention_bwd,
            _ARGTYPES_BWD, q,
            *[t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk, dv)],
            *_device_args(q, k, causal, window, scale, kv_offset))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd.variant_launches = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash forward and the FA2 backward (the port of
    the ``custom_vjp`` ``flash_attention_trainable``): forward saves
    ``q, k, v, out, lse``, backward calls :func:`flash_attention_bwd`.
    Apply as ``FlashAttentionFn.apply(q, k, v, causal, window, scale,
    kv_offset)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, scale=None,
                kv_offset=0):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, scale=scale,
                                       kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        kv_offset=kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
