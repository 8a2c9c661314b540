"""Kernel entry points of the model stack (port of ``repro.kernels.ops``).

With ``impl=None``, the only value the model passes, a CUDA tensor always
launches the Hopper kernel and a CPU tensor takes the kernel's plain
version: the choice follows the tensor's device.  ``impl="torch"`` selects
the plain version on any device; :func:`plain_versions` makes it the
default inside a ``with`` block, which is how a reference run on the card
is made to compare against (``chip_smoke.py``).  Nothing else selects it.
"""

from __future__ import annotations

import contextlib

from .block_reorder import (datatype_pack, datatype_pack_plain,
                            datatype_unpack, datatype_unpack_plain)
from .flash_attention import flash_attention, flash_attention_plain
from .moe_gmm import grouped_matmul, grouped_matmul_plain

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


def attention(q, k, v, *, causal=True, window=None, kv_offset=0, impl=None):
    """Multi-head attention with GQA / causal / sliding-window masks;
    q: (B, Hq, Sq, Dh), k, v: (B, Hkv, Skv, Dh)."""
    fn = flash_attention_plain if _plain(impl) else flash_attention
    return fn(q, k, v, causal=causal, window=window, kv_offset=kv_offset)


def expert_matmul(lhs, rhs, *, impl=None):
    """(E, C, K) @ (E, K, N) grouped matmul."""
    fn = grouped_matmul_plain if _plain(impl) else grouped_matmul
    return fn(lhs, rhs)


def pack_round(x, dims, k: int, *, variant: str = "paper", impl=None):
    """Round ``k``'s datatype pack of a contiguous ``(p, B)`` buffer."""
    fn = datatype_pack_plain if _plain(impl) else datatype_pack
    return fn(x, dims=dims, k=k, variant=variant)


def unpack_round(y, dims, k: int, *, variant: str = "paper", impl=None):
    """Inverse of :func:`pack_round`."""
    fn = datatype_unpack_plain if _plain(impl) else datatype_unpack
    return fn(y, dims=dims, k=k, variant=variant)
