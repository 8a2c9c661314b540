"""Pencil-decomposition multidimensional FFT on the torus transpose (port
of ``repro.workloads.fft``).

The classic distributed-memory FFT (Dalcin et al., "Fast parallel
multidimensional FFT using advanced MPI", arXiv 1804.09536) keeps each
array axis either fully local or sharded: local axes are transformed with
the on-device FFT (``torch.fft``, cuFFT on a card), then a global
transpose re-shards the array so that the next axis becomes local.  Every
transpose is an all-to-all of one contiguous pencil chunk per peer, so
each is a cached :class:`~repro_torch.core.plan.TransposePlan` resolved
through any dense backend (``direct`` / ``factorized`` / ``pipelined`` /
``overlap`` / ``tuned`` / ``autotune``).

Decomposition model
-------------------

A rank-``m`` global array on a rank-``d`` torus.  The torus axes are
partitioned into ``g`` groups (``grid``); group ``k`` (size ``q_k``, the
product of its axis dims) shards array axis ``k`` of the input, its first
axis the fastest digit: the block a rank holds along axis ``k`` is its
torus rank in group ``k``'s sub-torus (``comm.sub(group).rank``), not a
mesh index.  ``g = d`` with singleton groups is the pencil decomposition;
``g = 1`` with every torus axis in one group is the slab decomposition
(the only one for 2-D arrays).  Array axes ``g..m-1`` start local.

Forward: transform the local axes, then for ``k = g-1 .. 0`` transpose
over group ``k`` (axis ``k+1`` becomes sharded, axis ``k`` local) and
transform axis ``k``.  The output is sharded on axes ``1..g``; axis 0 is
local.  The inverse mirrors the chain, each inverse transpose the same
stage plan's drain direction (``inverse_apply``), so a forward / inverse
pair resolves one plan per stage.

Execution is SPMD: every rank of the comm calls :meth:`PencilFFT.forward_fn`
/ :meth:`~PencilFFT.inverse_fn` on its own pencil (``in_index`` /
``out_index`` cut it from a global array), in the same order.  With the
telemetry tracer on, a call runs under an ``fft.forward`` /
``fft.inverse`` span with one ``fft.stage`` span per FFT stage beside
each transpose's own ``plan.execute`` span; the traced call runs the
untraced one's operations in the same order.

Correctness oracle: ``core.simulator.simulate_pencil_transpose``.
"""

from __future__ import annotations

import math
import time

import torch

from repro_torch.core import telemetry
from repro_torch.core.plan import _sync, torch_dtype

__all__ = ["PencilFFT", "pencil_fft"]

_COMPLEX = {"float32": "complex64", "float64": "complex128",
            "complex64": "complex64", "complex128": "complex128"}


def _normalize_axes(axes, m: int) -> tuple[int, ...]:
    if axes is None:
        return tuple(range(m))
    out = []
    for ax in axes:
        ax = int(ax)
        if ax < 0:
            ax += m
        if not 0 <= ax < m:
            raise ValueError(f"fft axis {ax} outside array rank {m}")
        out.append(ax)
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate fft axes {axes}")
    return tuple(sorted(out))


class PencilFFT:
    """A resolved pencil- or slab-decomposed FFT over a ``TorusComm``.

    Parameters
    ----------
    comm:
        Torus communicator (mesh-backed to run; a dims-only comm resolves
        the plans and ``describe()`` only).
    global_shape:
        Global (unsharded) array shape, rank ``m >= 2``.
    axes:
        Array axes to transform (default: all).  The transpose chain is
        fixed by the decomposition; axes outside ``axes`` still ride the
        re-shards and skip the local transform.
    grid:
        Tuple of tuples of torus axis names: group ``k`` shards array axis
        ``k``.  Default: one singleton group per torus axis when ``m - 1
        >= d`` (pencil), else one group of all axes (slab).
    real:
        Real-input transform: ``rfft`` along the last array axis (which
        must be in ``axes``), complex transforms elsewhere; the inverse
        ends in ``irfft`` and returns a real array.
    dtype:
        Input dtype name (default ``float32`` when ``real`` else
        ``complex64``); the transposes run in the matching complex dtype.
    backend, links, db, **plan_kw:
        Forwarded to ``TorusComm.transpose`` for every stage plan.
    """

    def __init__(self, comm, global_shape, *, axes=None, grid=None,
                 real: bool = False, dtype=None, backend: str = "tuned",
                 links=None, db=None, **plan_kw):
        self.comm = comm
        self.global_shape = tuple(int(n) for n in global_shape)
        m = len(self.global_shape)
        if m < 2:
            raise ValueError("pencil FFT needs a rank >= 2 array")
        self.fft_axes = _normalize_axes(axes, m)
        if grid is None:
            grid = tuple((name,) for name in comm.axis_names) \
                if m - 1 >= comm.d else (tuple(comm.axis_names),)
        self.grid = tuple(tuple(group) for group in grid)
        g = len(self.grid)
        if not 1 <= g <= m - 1:
            raise ValueError(f"{g} torus groups need an array of rank "
                             f">= {g + 1}, got {m}")
        flat = [name for group in self.grid for name in group]
        if sorted(flat) != sorted(comm.axis_names):
            raise ValueError(f"grid {self.grid} must partition the comm "
                             f"axes {comm.axis_names}")
        self.real = bool(real)
        if self.real and m - 1 not in self.fft_axes:
            raise ValueError("real transform requires the last array "
                             "axis in `axes` (the rfft axis)")
        self.dtype = str(dtype).removeprefix("torch.") \
            if dtype is not None else ("float32" if self.real
                                       else "complex64")
        if self.dtype not in _COMPLEX:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.real and self.dtype.startswith("complex"):
            raise ValueError("real transform takes a float input dtype")
        self.cdtype = _COMPLEX[self.dtype]
        self.backend = backend

        dim_of = dict(zip(comm.axis_names, comm.dims))
        self.group_sizes = tuple(
            math.prod(dim_of[name] for name in group)
            for group in self.grid)
        for k, q in enumerate(self.group_sizes):
            if self.global_shape[k] % q:
                raise ValueError(
                    f"array axis {k} (size {self.global_shape[k]}) not "
                    f"divisible by group {self.grid[k]} size {q}")

        # Shape the transposes see: rfft halves the last axis up front.
        work = list(self.global_shape)
        if self.real:
            work[m - 1] = work[m - 1] // 2 + 1
        cur = [work[k] // self.group_sizes[k] if k < g else work[k]
               for k in range(m)]
        self.in_local_shape = tuple(
            self.global_shape[k] // self.group_sizes[k] if k < g
            else self.global_shape[k] for k in range(m))
        self._comms = tuple(
            comm if group == tuple(comm.axis_names) else comm.sub(group)
            for group in self.grid)
        plans = [None] * g
        for k in range(g - 1, -1, -1):
            plans[k] = self._comms[k].transpose(
                tuple(cur), self.cdtype, split_axis=k + 1, concat_axis=k,
                backend=backend, links=links, db=db, **plan_kw)
            cur[k + 1] //= self.group_sizes[k]
            cur[k] *= self.group_sizes[k]
        self.plans = tuple(plans)
        self.out_local_shape = tuple(cur)

        # per array axis, the torus axes that shard it (major to minor):
        # stage k's plan gathers axis k and shards axis k + 1 over group k
        specs = [plan.specs() for plan in self.plans]
        self.in_spec = tuple(specs[k][0][k] if k < g else None
                             for k in range(m))
        self.out_spec = tuple(specs[k - 1][1][k] if 1 <= k <= g else None
                              for k in range(m))

    # -- geometry ----------------------------------------------------------

    @property
    def m(self) -> int:
        return len(self.global_shape)

    @property
    def g(self) -> int:
        return len(self.grid)

    def _group_ranks(self) -> tuple[int, ...]:
        """This rank's torus rank in each group's sub-torus: its block
        index along the array axis that group shards."""
        ranks = tuple(c.rank for c in self._comms)
        if any(r is None for r in ranks):
            raise ValueError("a dims-only comm has no rank: build the FFT "
                             "over a mesh-backed comm")
        return ranks

    def in_index(self) -> tuple[slice, ...]:
        """This rank's input pencil within the global input array."""
        ranks = self._group_ranks()
        return tuple(slice(ranks[k] * n, (ranks[k] + 1) * n) if k < self.g
                     else slice(None)
                     for k, n in enumerate(self.in_local_shape))

    def out_index(self) -> tuple[slice, ...]:
        """This rank's output pencil within the global transform (its last
        axis ``n // 2 + 1`` long for a real transform)."""
        ranks = self._group_ranks()
        out = [slice(None)] * self.m
        for k in range(self.g):
            n = self.out_local_shape[k + 1]
            out[k + 1] = slice(ranks[k] * n, (ranks[k] + 1) * n)
        return tuple(out)

    def _local_fft_axes(self) -> tuple[int, ...]:
        """The transformed axes that never need a transpose (local from
        the start), rfft axis excluded."""
        hi = self.m - 1 if self.real else self.m
        return tuple(ax for ax in self.fft_axes if self.g <= ax < hi)

    # -- this rank's pipeline (collective over the comm) ------------------

    def forward_local(self, x):
        """Forward transform of this rank's input pencil: local FFTs
        between :meth:`TransposePlan.apply` collectives."""
        for _, _, fn in self._stages("forward"):
            x = fn(x)
        return x

    def inverse_local(self, y):
        """Exact inverse of :meth:`forward_local`: each re-shard is the
        same stage plan's drain direction, so the transpose round trip is
        bit-identical and only the FFT pair adds float error."""
        for _, _, fn in self._stages("inverse"):
            y = fn(y)
        return y

    # -- entry points --------------------------------------------------------

    def _entry(self, direction: str):
        local = self.forward_local if direction == "forward" \
            else self.inverse_local
        tr = telemetry.get_tracer()

        def run(x):
            if not tr.enabled:
                return local(x)
            return self._traced(tr, direction, x)

        return run

    def forward_fn(self):
        """The forward FFT of this rank's ``in_local_shape`` pencil (cut
        from the global input by ``in_index()``); returns its
        ``out_local_shape`` pencil of the global transform
        (``out_index()``).  Collective: every rank of the comm calls it.
        With the tracer on, the stepped path with its spans."""
        return self._entry("forward")

    def inverse_fn(self):
        """The inverse FFT, from this rank's output pencil back to its
        input pencil; see :meth:`forward_fn`."""
        return self._entry("inverse")

    # -- the stage chain (untraced, or stepped under spans) ----------------

    def _fft_stage(self, axes_, ifft=False, rfft=False, irfft=False):
        def local(x):
            if rfft:
                x = torch.fft.rfft(x, dim=self.m - 1)
            if not rfft and not irfft and not ifft:
                x = x.to(torch_dtype(self.cdtype))
            for ax in axes_:
                x = (torch.fft.ifft if ifft else torch.fft.fft)(x, dim=ax)
            if irfft:
                x = torch.fft.irfft(x, n=self.global_shape[self.m - 1],
                                    dim=self.m - 1).to(
                    torch_dtype(self.dtype))
            return x
        return local

    def _stages(self, direction: str):
        """``(kind, label, fn)`` per pipeline stage, the one chain both
        the untraced and the traced call walk: the transpose stages are
        the plans' own calls (which open their own spans when traced),
        each FFT stage a function of the pencil."""
        stages = []
        if direction == "forward":
            stages.append(("fft", "fft[local]", self._fft_stage(
                self._local_fft_axes(), rfft=self.real)))
            for k in range(self.g - 1, -1, -1):
                stages.append(("transpose", f"transpose[{k}]",
                               self.plans[k].apply))
                if k in self.fft_axes:
                    stages.append(("fft", f"fft[axis={k}]",
                                   self._fft_stage((k,))))
        else:
            for k in range(self.g):
                if k in self.fft_axes:
                    stages.append(("fft", f"ifft[axis={k}]",
                                   self._fft_stage((k,), ifft=True)))
                stages.append(("transpose", f"transpose[{k}]",
                               self.plans[k].inverse_apply))
            stages.append(("fft", "ifft[local]", self._fft_stage(
                tuple(reversed(self._local_fft_axes())), ifft=True,
                irfft=self.real)))
        return stages

    def _traced(self, tr, direction: str, x):
        """:meth:`forward_local` / :meth:`inverse_local` under an
        ``fft.<direction>`` span, each FFT stage under an ``fft.stage``
        span that ends in a device synchronise."""
        with tr.span(f"fft.{direction}", cat="workload",
                     shape="x".join(str(n) for n in self.global_shape),
                     grid="|".join(",".join(g) for g in self.grid),
                     axes=",".join(str(a) for a in self.fft_axes),
                     real=self.real, backend=self.backend) as sp:
            t0 = time.perf_counter()
            for kind, label, fn in self._stages(direction):
                if kind == "transpose":
                    x = fn(x)        # the plan emits its own spans
                else:
                    with tr.span("fft.stage", cat="workload", stage=label):
                        x = fn(x)
                        _sync(x)
            sp.set(measured_seconds=time.perf_counter() - t0)
        return x

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """Stable, JSON-serializable summary (the reference's keys and
        values): the decomposition and every stage plan's describe."""
        preds = [p.describe()["predicted_seconds"] for p in self.plans]
        return {
            "kind": "pencil_fft",
            "global_shape": list(self.global_shape),
            "fft_axes": list(self.fft_axes),
            "grid": [list(g) for g in self.grid],
            "group_sizes": list(self.group_sizes),
            "decomposition": "slab" if self.g == 1 else "pencil",
            "real": self.real,
            "dtype": self.dtype,
            "cdtype": self.cdtype,
            "backend": self.backend,
            "out_local_shape": list(self.out_local_shape),
            "transposes": [p.describe() for p in self.plans],
            "predicted_transpose_seconds":
                None if any(t is None for t in preds) else sum(preds),
        }

    def __repr__(self):
        return (f"PencilFFT(shape={self.global_shape}, grid={self.grid}, "
                f"real={self.real}, backend={self.backend!r})")


def pencil_fft(comm, global_shape, axes=None, **kw) -> PencilFFT:
    """Build (or re-resolve: every transpose plan is registry-cached) a
    :class:`PencilFFT` over ``comm``; see the class for the knobs."""
    return PencilFFT(comm, global_shape, axes=axes, **kw)
