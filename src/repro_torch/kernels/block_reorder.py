"""Round-k derived-datatype pack and unpack: the block reorder around every
dimension-wise exchange of the factorized all-to-all.

Port of ``repro.kernels.block_reorder`` (Pallas ``datatype_pack`` /
``datatype_unpack``) to one CUDA C++ kernel for Hopper
(``csrc/block_reorder.cu``).  In JAX the kernel is only the explicit-copy
baseline: ``lax.all_to_all`` splits any axis in place.  Here
``all_to_all_single`` takes one contiguous buffer split along dim 0, so
every round packs before its exchange and unpacks after it.

On a ``(p, B)`` buffer, round ``k`` of the torus ``dims`` (dim 0 fastest)
moves tiles of ``sigma_k = prod(dims[:k])`` rows.  Peer ``j``'s message
is ``n_upper = p / (D_k sigma_k)`` tiles; tile ``u`` of it sits at tile
``j + f(u)`` of the buffer, with ``f(u)`` the mixed-radix digits of ``u``
over the upper dimensions re-linearised with their tile strides.  The
``variant`` fixes the order of the upper digits inside a message:

* ``"paper"`` — the datatype order of the paper (``i_{k+1}`` slowest,
  ``i_{d-1}`` fastest), ``simulator.round_datatype``'s positions;
* ``"natural"`` — ``i_{d-1}`` slowest, ``i_{k+1}`` fastest: the order of
  ``movedim(pos(k), 0)`` on the ``reversed(dims)`` block view, which is
  what JAX's in-place natural variant exchanges.

Both are bit-identical after the unpack.  :func:`datatype_pack` and
:func:`datatype_unpack` launch the kernel on a CUDA tensor and take the
plain versions on a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from repro_torch.core.simulator import round_datatype, strides

from . import build
from .ref import ref_block_reorder, ref_block_unreorder

VARIANTS = ("paper", "natural")
MAX_DIMS = 8                     # csrc/block_reorder.cu: kMaxUpper
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int]
             + [ctypes.POINTER(ctypes.c_longlong)] * 2
             + [ctypes.c_int, ctypes.c_void_p])


def round_tiles(dims: tuple[int, ...], k: int, variant: str = "paper"):
    """Round ``k``'s tile geometry: ``(sigma_k, D_k, sizes, tile_strides)``
    with the upper digits listed slowest first, as the kernel takes them."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    if not 0 <= k < len(dims):
        raise ValueError(f"round {k} outside 0..{len(dims) - 1}")
    sig = strides(dims)
    uppers = list(range(k + 1, len(dims)))
    if variant == "natural":
        uppers.reverse()
    return (sig[k], dims[k], tuple(dims[m] for m in uppers),
            tuple(sig[m] // sig[k] for m in uppers))


@functools.lru_cache(maxsize=256)
def round_positions(dims: tuple[int, ...], k: int,
                    variant: str = "paper") -> tuple[tuple[int, ...], int]:
    """Block offsets of peer 0's message in round ``k`` and the extent
    (``sigma_k``) that shifts them to peer ``j``'s."""
    if variant == "paper":
        positions, extent = round_datatype(dims, k)
        return tuple(positions), extent
    sigma, _, sizes, tile_strides = round_tiles(dims, k, variant)
    positions = []
    for idx in itertools.product(*[range(n) for n in sizes]):
        base = sigma * sum(i * s for i, s in zip(idx, tile_strides))
        positions.extend(range(base, base + sigma))
    return tuple(positions), sigma


def datatype_pack_plain(x, *, dims, k: int, variant: str = "paper"):
    """The plain version: ``ref_block_reorder`` on round ``k``'s
    positions, with the index built on ``x``'s device."""
    positions, extent = round_positions(tuple(dims), k, variant)
    return ref_block_reorder(x, positions, extent, dims[k])


def datatype_unpack_plain(y, *, dims, k: int, variant: str = "paper"):
    """The plain version of the unpack: ``ref_block_unreorder``."""
    positions, extent = round_positions(tuple(dims), k, variant)
    return ref_block_unreorder(y, positions, extent, dims[k])


def _check(x, dims, k, variant):
    if x.dim() != 2:
        raise ValueError(f"block reorder takes a (p, B) buffer; got shape "
                         f"{tuple(x.shape)}")
    if math.prod(dims) != x.shape[0]:
        raise ValueError(f"prod(dims)={math.prod(dims)} != p={x.shape[0]} "
                         f"(dims {tuple(dims)})")
    if len(dims) > MAX_DIMS:
        raise ValueError(f"block reorder takes at most {MAX_DIMS} dims, "
                         f"got {len(dims)}")
    if not x.is_contiguous():
        raise ValueError("block reorder takes a contiguous buffer")
    return round_tiles(tuple(dims), k, variant)


def _launch(x, dims, k, variant, unpack: bool):
    sigma, Dk, sizes, tile_strides = _check(x, dims, k, variant)
    out = torch.empty_like(x)
    tile_bytes = sigma * x.shape[1] * x.element_size()
    if tile_bytes == 0:
        return out, False
    n_up = len(sizes)
    size_arr = (ctypes.c_longlong * MAX_DIMS)(*sizes)
    stride_arr = (ctypes.c_longlong * MAX_DIMS)(*tile_strides)
    fn = build.load("block_reorder").repro_block_reorder
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), tile_bytes, Dk,
                 math.prod(sizes), n_up, size_arr, stride_arr, int(unpack),
                 stream)
    if err:
        raise RuntimeError(f"block reorder kernel launch failed: CUDA "
                           f"error {err}")
    return out, True


def _device_kind(x, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return x.device.type


def datatype_pack(x, *, dims, k: int, variant: str = "paper"):
    """Pack round ``k``'s composite messages contiguously: rows
    ``[j p/D_k, (j+1) p/D_k)`` of the result are peer ``j``'s message.

    x: contiguous ``(p, B)`` of any dtype.  On a CUDA tensor this
    launches the Hopper kernel (counted in ``datatype_pack.launches``);
    on a CPU tensor it returns the plain version."""
    if _device_kind(x, "datatype_pack") == "cpu":
        _check(x, dims, k, variant)
        return datatype_pack_plain(x, dims=dims, k=k, variant=variant)
    out, launched = _launch(x, tuple(dims), k, variant, unpack=False)
    datatype_pack.launches += launched
    return out


def datatype_unpack(y, *, dims, k: int, variant: str = "paper"):
    """Inverse of :func:`datatype_pack`: scatter the received messages
    back to their datatype positions (counted in
    ``datatype_unpack.launches`` on a CUDA tensor)."""
    if _device_kind(y, "datatype_unpack") == "cpu":
        _check(y, dims, k, variant)
        return datatype_unpack_plain(y, dims=dims, k=k, variant=variant)
    out, launched = _launch(y, tuple(dims), k, variant, unpack=True)
    datatype_unpack.launches += launched
    return out


datatype_pack.launches = 0
datatype_unpack.launches = 0
