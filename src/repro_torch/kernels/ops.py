"""Kernel entry points of the model stack (port of ``repro.kernels.ops``).

With ``impl=None``, the only value the model passes, a CUDA tensor always
launches the Hopper kernel and a CPU tensor takes the kernel's plain
version: the choice follows the tensor's device.  ``impl="torch"`` selects
the plain version on any device; :func:`plain_versions` makes it the
default inside a ``with`` block, which is how a reference run on the card
is made to compare against (``chip_smoke.py``).  Nothing else selects it.

Training: when grad is enabled and an operand requires grad,
:func:`attention` applies ``FlashAttentionFn`` (the forward that keeps
``lse`` and the FA2 backward kernels) and :func:`expert_matmul` applies
``GroupedMatmulFn`` (its backward is two more grouped matmuls), the
counterpart of the reference's primal / ``custom_vjp`` split.  These
Functions are the only route from here to a kernel under autograd: a
wrapper's output alone has no ``grad_fn``.  The plain versions are
differentiated by autograd.
"""

from __future__ import annotations

import contextlib

import torch

from .block_reorder import (datatype_pack, datatype_pack_plain,
                            datatype_repack, datatype_repack_plain,
                            datatype_unpack, datatype_unpack_plain)
from .flash_attention import flash_attention, flash_attention_plain
from .flash_attention_bwd import FlashAttentionFn
from .moe_gmm import GroupedMatmulFn, grouped_matmul, grouped_matmul_plain

_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Run every op of this module as its plain PyTorch version."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def _plain(impl) -> bool:
    if impl is None:
        return _PLAIN
    if impl != "torch":
        raise ValueError(f"impl must be None or 'torch', not {impl!r}")
    return True


def _trains(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q, k, v, *, causal=True, window=None, kv_offset=0, impl=None):
    """Multi-head attention with GQA / causal / sliding-window masks;
    q: (B, Hq, Sq, Dh), k, v: (B, Hkv, Skv, Dh)."""
    if _plain(impl):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_offset=kv_offset)
    if _trains(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, None,
                                      kv_offset)
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_offset=kv_offset)


def expert_matmul(lhs, rhs, *, impl=None):
    """(E, C, K) @ (E, K, N) grouped matmul."""
    if _plain(impl):
        return grouped_matmul_plain(lhs, rhs)
    if _trains(lhs, rhs):
        return GroupedMatmulFn.apply(lhs, rhs)
    return grouped_matmul(lhs, rhs)


def pack_round(x, dims, k: int, *, variant: str = "paper", send_order=None,
               impl=None):
    """Round ``k``'s datatype pack of a contiguous ``(p, B)`` buffer."""
    fn = datatype_pack_plain if _plain(impl) else datatype_pack
    return fn(x, dims=dims, k=k, variant=variant, send_order=send_order)


def unpack_round(y, dims, k: int, *, variant: str = "paper",
                 recv_order=None, impl=None):
    """Inverse of :func:`pack_round`."""
    fn = datatype_unpack_plain if _plain(impl) else datatype_unpack
    return fn(y, dims=dims, k=k, variant=variant, recv_order=recv_order)


def repack_round(y, dims, k_unpack: int, k_pack: int, *,
                 variant: str = "paper", recv_order=None, send_order=None,
                 impl=None):
    """The boundary between two rounds in one pass:
    ``pack_round(unpack_round(y, dims, k_unpack), dims, k_pack)``."""
    fn = datatype_repack_plain if _plain(impl) else datatype_repack
    return fn(y, dims=dims, k_unpack=k_unpack, k_pack=k_pack,
              variant=variant, recv_order=recv_order, send_order=send_order)
