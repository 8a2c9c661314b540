"""The derived-datatype block reorder around every dimension-wise exchange
of the factorized all-to-all: the round-k pack, the round-k unpack, and
the fused unpack(k) then pack(k') between two rounds.

Port of ``repro.kernels.block_reorder`` (Pallas ``datatype_pack`` /
``datatype_unpack``) to one CUDA C++ kernel for Hopper
(``csrc/block_reorder.cu``).  In JAX the kernel is only the explicit-copy
baseline: ``lax.all_to_all`` splits any axis in place.  Here
``all_to_all_single`` takes one contiguous buffer split along dim 0, so a
d-round call reorders once at each round boundary where the layout
changes (``core.factorized.round_schedule``).

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

Both are bit-identical after the unpack.  Every pass is a permutation of
the ``p`` rows, ``dst[r] = src[map[r]]`` (:func:`row_map`); the kernel
copies the map's runs (:func:`map_runs`).  A pass may also carry the
process group's rank order (``PeerGroup.order``) on the side it faces:
``send_order`` lays the packed messages out in group-rank order,
``recv_order`` reads the received ones from it.

:func:`datatype_pack`, :func:`datatype_unpack` and :func:`datatype_repack`
launch the kernel on a CUDA tensor (each counting its launches) and take
the plain versions on a CPU tensor; there is no other fallback.  The
launch path caches, per pass and buffer shape, the run table on the
device and the packed kernel arguments, so a call does one
``torch.empty_like``, one stream lookup and one ctypes call.
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
BLOCKS_PER_SM = 8                  # the grid (tools/reorder_tune.py)
CHUNK_BYTES = (4096, 32768)        # least and most bytes of one chunk


class _Plan(ctypes.Structure):
    """``RowMapPlan`` of ``csrc/block_reorder.cu``: one pass's launch
    arguments, packed once per pass and buffer shape."""
    _fields_ = [("run_src", ctypes.c_void_p), ("run_bytes", ctypes.c_longlong),
                ("n_runs", ctypes.c_int), ("chunk_bytes", ctypes.c_int),
                ("blocks", ctypes.c_int), ("device", ctypes.c_int)]


def round_tiles(dims: tuple[int, ...], k: int, variant: str = "paper"):
    """Round ``k``'s tile geometry: ``(sigma_k, D_k, sizes, tile_strides)``
    with the upper digits listed slowest first."""
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
        round_tiles(dims, k, variant)              # validates k
        positions, extent = round_datatype(dims, k)
        return tuple(positions), extent
    sigma, _, sizes, tile_strides = round_tiles(dims, k, variant)
    positions = []
    for idx in itertools.product(*[range(n) for n in sizes]):
        base = sigma * sum(i * s for i, s in zip(idx, tile_strides))
        positions.extend(range(base, base + sigma))
    return tuple(positions), sigma


def _check_order(order, n: int, side: str):
    if order is not None and sorted(order) != list(range(n)):
        raise ValueError(f"{side} {order} is not a permutation of "
                         f"0..{n - 1}")


@functools.lru_cache(maxsize=1024)
def row_map(dims: tuple[int, ...], k_unpack: int | None = None,
            k_pack: int | None = None, variant: str = "paper",
            recv_order: tuple[int, ...] | None = None,
            send_order: tuple[int, ...] | None = None) -> tuple[int, ...]:
    """The pass ``send(pack(k_pack, unpack(k_unpack, recv(src))))`` as a
    row map: ``dst[r] = src[map[r]]`` for the ``p`` rows.

    ``None`` for a round leaves that step out.  ``recv_order`` /
    ``send_order`` (the group rank of each torus member of round
    ``k_unpack``'s / ``k_pack``'s group) read the received messages from
    group-rank order and lay the packed ones out in it; without them the
    group order is the torus order."""
    dims = tuple(dims)
    p = math.prod(dims)
    idx = list(range(p))
    if send_order is not None:        # dst chunk g <- packed chunk t
        if k_pack is None:
            raise ValueError("send_order needs k_pack")
        _check_order(send_order, dims[k_pack], "send_order")
        c = p // len(send_order)
        torus = sorted(range(len(send_order)), key=send_order.__getitem__)
        idx = [torus[r // c] * c + r % c for r in idx]
    if k_pack is not None:
        positions, extent = round_positions(dims, k_pack, variant)
        pack = [pos + j * extent for j in range(dims[k_pack])
                for pos in positions]
        idx = [pack[r] for r in idx]
    if k_unpack is not None:
        positions, extent = round_positions(dims, k_unpack, variant)
        unpack = [0] * p
        for r, s in enumerate(pos + j * extent
                              for j in range(dims[k_unpack])
                              for pos in positions):
            unpack[s] = r
        idx = [unpack[r] for r in idx]
    if recv_order is not None:        # torus chunk t <- group chunk
        if k_unpack is None:
            raise ValueError("recv_order needs k_unpack")
        _check_order(recv_order, dims[k_unpack], "recv_order")
        c = p // len(recv_order)
        idx = [recv_order[r // c] * c + r % c for r in idx]
    return tuple(idx)


def is_identity(rmap) -> bool:
    return all(r == s for r, s in enumerate(rmap))


@functools.lru_cache(maxsize=1024)
def map_runs(rmap: tuple[int, ...]) -> tuple[int, tuple[int, ...]]:
    """The coarsest runs of a row map: ``(g, run_src)`` with ``g`` rows a
    run, contiguous in source and destination, and destination run ``r``
    read from source run ``run_src[r]`` (rows ``run_src[r] * g`` on).

    ``g`` is the gcd of the map's maximal run lengths; as the runs of a
    permutation tile both sides, every run starts at a multiple of ``g``
    rows on both."""
    p, g, start = len(rmap), 0, 0
    for r in range(1, p + 1):
        if r == p or rmap[r] != rmap[r - 1] + 1:
            g, start = math.gcd(g, r - start), r
    return g, tuple(rmap[r] // g for r in range(0, p, g))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


_INDEX: dict = {}      # (group order, inverse, device) -> index


def _chunk_index(order, inverse: bool, device):
    """``order`` (or its inverse) as an index on ``device``, made once."""
    key = (order, inverse, device)
    idx = _INDEX.get(key)
    if idx is None:
        idx = torch.tensor(order)
        idx = _INDEX[key] = (torch.argsort(idx) if inverse else idx) \
            .to(device)
    return idx


def to_group_order(x, order):
    """Chunk ``t`` of ``x``'s dim 0 (torus member ``t``) to chunk
    ``order[t]`` (its rank in the process group); ``None``: the same."""
    if order is None:
        return x
    idx = _chunk_index(tuple(order), True, x.device)
    return x.reshape(len(order), -1)[idx].reshape(x.shape)


def to_torus_order(y, order):
    """Inverse of :func:`to_group_order`."""
    if order is None:
        return y
    idx = _chunk_index(tuple(order), False, y.device)
    return y.reshape(len(order), -1)[idx].reshape(y.shape)


def datatype_pack_plain(x, *, dims, k: int, variant: str = "paper",
                        send_order=None):
    """The plain version: ``ref_block_reorder`` on round ``k``'s
    positions, with the index built on ``x``'s device."""
    positions, extent = round_positions(tuple(dims), k, variant)
    return to_group_order(ref_block_reorder(x, positions, extent, dims[k]),
                          send_order)


def datatype_unpack_plain(y, *, dims, k: int, variant: str = "paper",
                          recv_order=None):
    """The plain version of the unpack: ``ref_block_unreorder``."""
    positions, extent = round_positions(tuple(dims), k, variant)
    return ref_block_unreorder(to_torus_order(y, recv_order), positions,
                               extent, dims[k])


def datatype_repack_plain(x, *, dims, k_unpack: int, k_pack: int,
                          variant: str = "paper", recv_order=None,
                          send_order=None):
    """The plain version of the fused pass: the unpack's plain version,
    then the pack's."""
    y = datatype_unpack_plain(x, dims=dims, k=k_unpack, variant=variant,
                              recv_order=recv_order)
    return datatype_pack_plain(y, dims=dims, k=k_pack, variant=variant,
                               send_order=send_order)


# ---------------------------------------------------------------------------
# the kernel's launch path
# ---------------------------------------------------------------------------


def _check(x, dims, k, variant):
    if any(s < 1 for s in dims):
        raise ValueError(f"torus dims must be positive, got {tuple(dims)}")
    if x.dim() != 2:
        raise ValueError(f"block reorder takes a (p, B) buffer; got shape "
                         f"{tuple(x.shape)}")
    if math.prod(dims) != x.shape[0]:
        raise ValueError(f"prod(dims)={math.prod(dims)} != p={x.shape[0]} "
                         f"(dims {tuple(dims)})")
    if not x.is_contiguous():
        raise ValueError("block reorder takes a contiguous buffer")
    return round_tiles(tuple(dims), k, variant)


_KERNEL = None
_SMS: dict = {}
_PLANS: dict = {}      # (pass key, shape, dtype, device) -> launch plan
_EMPTY = object()      # a plan with no bytes to move


def _kernel():
    """The C entry point, resolved and typed once, and torch's lookup of a
    device index's current stream as a raw pointer."""
    global _KERNEL
    if _KERNEL is None:
        fn = build.load("block_reorder").repro_block_reorder
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
        _KERNEL = fn, torch._C._cuda_getCurrentRawStream
    return _KERNEL


def _plan(x, key):
    """Build and cache the launch plan of pass ``key`` on ``x``'s shape,
    dtype and device: the run table on the device and the packed
    ``RowMapPlan`` (kept alive together), and the plan's address."""
    dims, k_unpack, k_pack, variant, recv_order, send_order = key
    for k in (k_unpack, k_pack):
        if k is not None:
            _check(x, dims, k, variant)
    rmap = row_map(*key)
    row_bytes = x.shape[1] * x.element_size()
    plan = _EMPTY
    if row_bytes:
        g, run_src = map_runs(rmap)
        dev = x.device
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        blocks = BLOCKS_PER_SM * _SMS[dev]
        lo, hi = CHUNK_BYTES   # a power of two near bytes / blocks
        share = max(1, x.shape[0] * row_bytes // blocks)
        chunk = min(hi, max(lo, 1 << (share - 1).bit_length()))
        runs = torch.tensor(run_src, dtype=torch.int32, device=dev)
        args = _Plan(runs.data_ptr(), g * row_bytes, len(run_src), chunk,
                     blocks, dev.index)
        plan = (runs, args, ctypes.addressof(args), dev.index)
    if len(_PLANS) >= 4096:
        _PLANS.clear()
    _PLANS[(key, x.shape, x.dtype, x.device)] = plan
    return plan


def _launch(x, key) -> tuple[torch.Tensor, bool]:
    """Run pass ``key`` on the CUDA tensor ``x`` into a fresh buffer;
    returns it and whether the kernel was launched."""
    if not x.is_contiguous():
        raise ValueError("block reorder takes a contiguous buffer")
    plan = _PLANS.get((key, x.shape, x.dtype, x.device))
    if plan is None:
        plan = _plan(x, key)
    out = torch.empty_like(x)
    if plan is _EMPTY:
        return out, False
    fn, stream = _kernel()
    err = fn(x.data_ptr(), out.data_ptr(), plan[2], stream(plan[3]))
    if err:
        raise RuntimeError(f"block reorder kernel launch failed: CUDA "
                           f"error {err}")
    return out, True


def _tuple(order):
    return None if order is None else tuple(order)


def _device_kind(x, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return x.device.type


def datatype_pack(x, *, dims, k: int, variant: str = "paper",
                  send_order=None):
    """Pack round ``k``'s composite messages contiguously: rows
    ``[j p/D_k, (j+1) p/D_k)`` of the result are peer ``j``'s message
    (with ``send_order``, the message of the peer whose group rank is
    ``j``).

    x: contiguous ``(p, B)`` of any dtype.  On a CUDA tensor this
    launches the Hopper kernel (counted in ``datatype_pack.launches``);
    on a CPU tensor it returns the plain version."""
    if _device_kind(x, "datatype_pack") == "cpu":
        _check(x, dims, k, variant)
        return datatype_pack_plain(x, dims=dims, k=k, variant=variant,
                                   send_order=send_order)
    out, launched = _launch(x, (tuple(dims), None, k, variant, None,
                                _tuple(send_order)))
    datatype_pack.launches += launched
    return out


def datatype_unpack(y, *, dims, k: int, variant: str = "paper",
                    recv_order=None):
    """Inverse of :func:`datatype_pack`: scatter the received messages
    back to their datatype positions (counted in
    ``datatype_unpack.launches`` on a CUDA tensor)."""
    if _device_kind(y, "datatype_unpack") == "cpu":
        _check(y, dims, k, variant)
        return datatype_unpack_plain(y, dims=dims, k=k, variant=variant,
                                     recv_order=recv_order)
    out, launched = _launch(y, (tuple(dims), k, None, variant,
                                _tuple(recv_order), None))
    datatype_unpack.launches += launched
    return out


def datatype_repack(x, *, dims, k_unpack: int, k_pack: int,
                    variant: str = "paper", recv_order=None,
                    send_order=None):
    """The round boundary in one pass: ``datatype_pack(datatype_unpack(x,
    k=k_unpack), k=k_pack)``, the buffer written and read once instead of
    twice (counted in ``datatype_repack.launches`` on a CUDA tensor)."""
    if _device_kind(x, "datatype_repack") == "cpu":
        _check(x, dims, k_unpack, variant)
        _check(x, dims, k_pack, variant)
        return datatype_repack_plain(x, dims=dims, k_unpack=k_unpack,
                                     k_pack=k_pack, variant=variant,
                                     recv_order=recv_order,
                                     send_order=send_order)
    out, launched = _launch(x, (tuple(dims), k_unpack, k_pack, variant,
                                _tuple(recv_order), _tuple(send_order)))
    datatype_repack.launches += launched
    return out


datatype_pack.launches = 0
datatype_unpack.launches = 0
datatype_repack.launches = 0
