"""Cases and the gloo-world worker of the pencil-FFT tests
(``test_torch_fft.py``, and the distributed convolution in
``test_torch_recurrent.py``).

Kept free of jax imports: every rank of a ``torch_dist.run_world`` world
imports this module.  Inputs are made with numpy from a seed, so that the
ranks, the parent and the JAX subprocess draw the same arrays.

A world's ranks run, per case and complex dtype, the stage transposes of
the case's :class:`~repro_torch.workloads.fft.PencilFFT` under every
backend (``direct``, ``factorized`` natural and paper in every round
order, ``pipelined`` with two chunks, ``tuned``) and check each stage's
pencil against the global array sliced by the stage's sharding, then the
forward FFT, the round trip and the traced forward; the outputs they
return are held against the JAX package by the parent.
"""

from __future__ import annotations

import itertools

import numpy as np

WORLDS = {4: ((2, 2), ("data", "pod")), 12: ((2, 3, 2), ("a", "b", "c"))}

# name -> (global shape, PencilFFT knobs); "real" cases take a float input
CASES = {
    4: {"slab2d": ((16, 12), {}),
        "pencil3d": ((4, 8, 6), {}),
        "real": ((4, 8, 10), {"real": True})},
    12: {"slab2d": ((24, 36), {}),
         "slab3d": ((12, 24, 4), {}),
         "pencil4d": ((4, 6, 6, 4), {}),
         "real": ((12, 12, 10), {"real": True,
                                 "grid": (("a", "b"), ("c",))})},
}
CDTYPES = ("complex64", "complex128")
REAL_OF = {"complex64": "float32", "complex128": "float64"}
# (B, S, E) of the distributed convolution: 2S and B*E divisible by p
CONV = {1: (2, 6, 3), 4: (2, 8, 6), 12: (2, 24, 18)}
TOL = {"complex64": 1e-5, "complex128": 1e-12}
CHECKS = ("transpose_reshard", "inverse_roundtrip", "backends_agree",
          "inverse_shares_inner", "registry_hit", "fft_vs_numpy",
          "fft_roundtrip", "traced_equal", "span_tree", "traced_grad",
          "grad_span_tree")


def case_seed(name: str, cdtype: str) -> int:
    return sum(map(ord, name)) * 7 + CDTYPES.index(cdtype)


def global_input(name: str, shape, cdtype: str, real: bool) -> np.ndarray:
    """The case's seeded global input (float for a real case)."""
    rng = np.random.default_rng(case_seed(name, cdtype))
    if real:
        return rng.standard_normal(shape).astype(REAL_OF[cdtype])
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return z.astype(cdtype)


def work_array(name: str, shape, cdtype: str, real: bool) -> np.ndarray:
    """The complex global array the case's transposes move: its input,
    rfft'd along the last axis for a real case."""
    g = global_input(name, shape, cdtype, real)
    if real:
        g = np.fft.rfft(g.astype(np.float64), axis=-1).astype(cdtype)
    return g


def conv_inputs(B: int, S: int, E: int):
    rng = np.random.default_rng(B * 1000 + S * 10 + E)
    return (rng.standard_normal((B, S, E)).astype(np.float32),
            rng.standard_normal((S, E)).astype(np.float32))


def stage_dists(g: int) -> list[dict]:
    """The sharding before each forward transpose and after the last:
    ``{array axis: group}``; transpose ``k`` moves group ``k`` from axis
    ``k`` to axis ``k + 1``."""
    dist = {k: k for k in range(g)}
    out = [dict(dist)]
    for k in range(g - 1, -1, -1):
        del dist[k]
        dist[k + 1] = k
        out.append(dict(dist))
    return out


def dist_index(fft, dist: dict, ranks, shape) -> tuple:
    """This rank's block of a global array of ``shape`` sharded per
    ``dist``, as (start, stop) pairs (picklable)."""
    out = []
    for a, n in enumerate(shape):
        if a in dist:
            q = fft.group_sizes[dist[a]]
            r = ranks[dist[a]]
            out.append((r * n // q, (r + 1) * n // q))
        else:
            out.append((0, n))
    return tuple(out)


def as_slices(index) -> tuple:
    return tuple(slice(a, b) for a, b in index)


def _backends(stage_dims) -> list:
    """(label, variant, plan knobs) of every backend a case runs; the
    round orders are those of the stages' active rounds where every stage
    has the same number, else the default."""
    out = [("direct", "natural", {"backend": "direct"}),
           ("pipelined", "natural", {"backend": "pipelined",
                                     "n_chunks": 2}),
           ("tuned", "natural", {"backend": "tuned"})]
    active = {sum(1 for s in dims if s > 1) for dims in stage_dims}
    orders = list(itertools.permutations(range(active.pop()))) \
        if len(active) == 1 else [None]
    for variant in ("natural", "paper"):
        for order in orders:
            kw = {"backend": "factorized"}
            if order is not None:
                kw["round_order"] = order
            out.append((f"factorized-{variant}-{order}", variant, kw))
    return out


def _pairs(index, shape) -> tuple:
    """Slices as (start, stop) pairs (picklable)."""
    return tuple(sl.indices(n)[:2] for sl, n in zip(index, shape))


def _span_shape(spans) -> list:
    """The span forest as nested ``(name, kind, backend, axis,
    children)`` tuples, each level in start order."""
    kids: dict = {}
    for sp in sorted(spans, key=lambda sp: sp.start):
        kids.setdefault(sp.parent_id, []).append(sp)

    def shape(sp):
        return (sp.name, sp.attrs.get("kind"), sp.attrs.get("backend"),
                sp.attrs.get("axis"),
                tuple(shape(c) for c in kids.get(sp.span_id, ())))
    return [shape(sp) for sp in kids.get(None, ())]


def transpose_spans(plan, reverse: bool = False) -> tuple:
    """One traced transpose call: a ``plan.execute`` (``kind=
    "transpose"``) over its rounds, the inner plan's in the call's order
    (the drain order for ``reverse``), one fused round unless
    factorized."""
    inner = plan.inner
    if inner.backend == "factorized":
        order = inner.rev_order if reverse else inner.order
        names = [a for a, d in zip(inner.axis_names, inner.dims) if d > 1]
        rounds = tuple(("plan.round", None, None, names[k], ())
                       for k in order)
    else:
        rounds = (("plan.round", None, inner.backend, "*", ()),)
    return ("plan.execute", "transpose", inner.backend, None, rounds)


def expected_span_tree(fft, direction: str = "forward") -> list:
    """One traced call's spans: the ``fft.<direction>`` span with an
    ``fft.stage`` per FFT stage and, per transpose, one ``plan.execute``
    (``kind="transpose"``) over its rounds."""
    kids = tuple(("fft.stage", None, None, None, ()) if kind == "fft"
                 else transpose_spans(fn.__self__, direction == "inverse")
                 for kind, _, fn in fft._stages(direction))
    return [(f"fft.{direction}", None, fft.backend, None, kids)]


def world_checks(rank: int, n: int, dims, names) -> dict:
    """Every check of one rank of an ``n``-rank world (module docstring),
    plus what the parent compares with the JAX package: per case and
    dtype the factorized (natural) stage pencils, the forward pencil and
    the round trip, each with its global index; and the convolution's
    rows."""
    import torch
    from repro_torch.core import plan as planmod, telemetry
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.workloads import pencil_fft

    mesh = cart_create(n, dims, names, device_type="cpu")
    ok = {k: True for k in CHECKS}
    outs = {}
    for name, (shape, kw) in CASES[n].items():
        real = kw.get("real", False)
        for cdtype in CDTYPES:
            dtype = REAL_OF[cdtype] if real else cdtype
            G = work_array(name, shape, cdtype, real)
            fft = pencil_fft(torus_comm(mesh, names), shape, dtype=dtype,
                             **kw)
            ranks = fft._group_ranks()
            dists = stage_dists(fft.g)
            index = [dist_index(fft, d, ranks, G.shape) for d in dists]
            x = torch.from_numpy(G[as_slices(index[0])].copy())
            results = {}
            for label, variant, pkw in _backends([c.dims
                                                  for c in fft._comms]):
                comm = torus_comm(mesh, names, variant=variant)
                f = pencil_fft(comm, shape, dtype=dtype, **kw, **pkw)
                stages, y = [], x
                for i, k in enumerate(range(f.g - 1, -1, -1)):
                    y = f.plans[k].apply(y)
                    ok["transpose_reshard"] &= np.array_equal(
                        y.numpy(), G[as_slices(index[i + 1])])
                    stages.append(y)
                for k in range(f.g):
                    y = f.plans[k].inverse_apply(y)
                ok["inverse_roundtrip"] &= torch.equal(y, x)
                results[label] = stages
                # a stage's inverse resolves the same inner dense plan
                for k, p in enumerate(f.plans):
                    inv = f._comms[k].transpose(
                        p.out_shape, f.cdtype, split_axis=p.concat_axis,
                        concat_axis=p.split_axis, **pkw)
                    ok["inverse_shares_inner"] &= inv.inner is p.inner
                # a rebuild hits the registry and adds nothing to it
                before = planmod.plan_cache_stats()
                again = pencil_fft(comm, shape, dtype=dtype, **kw, **pkw)
                after = planmod.plan_cache_stats()
                ok["registry_hit"] &= all(
                    a is b for a, b in zip(again.plans, f.plans)) \
                    and after["hits"] > before["hits"] \
                    and after["size"] == before["size"]
            ok["backends_agree"] &= all(
                torch.equal(a, b) for st in results.values()
                for a, b in zip(st, results["direct"]))

            # the FFT itself (default backend), against numpy's
            g_in = global_input(name, shape, cdtype, real)
            xin = torch.from_numpy(g_in[fft.in_index()].copy())
            y = fft.forward_fn()(xin)
            ref = np.fft.rfftn(g_in.astype(np.float64)) if real \
                else np.fft.fftn(g_in.astype(np.complex128))
            err = np.abs(y.numpy() - ref[fft.out_index()]).max() \
                / np.abs(ref).max()
            ok["fft_vs_numpy"] &= bool(err < TOL[cdtype])
            back = fft.inverse_fn()(y)
            rerr = np.abs(back.numpy() - g_in[fft.in_index()]).max() \
                / np.abs(g_in).max()
            ok["fft_roundtrip"] &= bool(rerr < 1e-5) \
                and back.dtype == xin.dtype
            telemetry.reset_telemetry()
            tr = telemetry.enable_tracing()
            try:
                yt = fft.forward_fn()(xin)
            finally:
                telemetry.disable_tracing()
            ok["traced_equal"] &= torch.equal(yt, y)
            ok["span_tree"] &= _span_shape(tr.spans()) == \
                expected_span_tree(fft)
            # under autograd a traced transpose's backward is the inverse
            # re-shard of the cotangent, as the untraced one's
            plan = fft.plans[-1]
            t = x.clone().requires_grad_(True)
            cot = torch.ones(plan.out_shape, dtype=x.dtype).cumsum(0)
            grads = []
            for traced in (False, True):
                telemetry.reset_telemetry()
                if traced:
                    tr = telemetry.enable_tracing()
                try:
                    (grad,) = torch.autograd.grad(
                        (plan.apply(t) * cot).real.sum(), t)
                finally:
                    telemetry.disable_tracing()
                grads.append(grad)
            want = plan.inverse_apply(cot)
            ok["traced_grad"] &= all(torch.equal(g, want) for g in grads)
            # the traced backward is the transpose the other way: its own
            # transpose span over the rounds in the drain order, never
            # the inner plan's dense plan.execute
            ok["grad_span_tree"] &= _span_shape(tr.spans()) == \
                [transpose_spans(plan), transpose_spans(plan, True)]
            telemetry.reset_telemetry()
            fac = next(lb for lb in results
                       if lb.startswith("factorized-natural"))
            outs[(name, cdtype)] = {
                "stages": [t.numpy() for t in results[fac]],
                "stage_index": index[1:],
                "forward": y.numpy(),
                "out_index": _pairs(fft.out_index(), ref.shape),
                "roundtrip": back.numpy(),
                "in_index": _pairs(fft.in_index(), g_in.shape)}
    outs["conv"] = conv_rows(n, dims, names, mesh)
    return {"ok": {k: bool(v) for k, v in ok.items()}, "outs": outs}


def conv_rows(n: int, dims, names, mesh=None) -> np.ndarray:
    """This rank's rows of the distributed convolution on ``CONV[n]``."""
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.models.spectral import distributed_fft_causal_conv
    if mesh is None:
        mesh = cart_create(n, dims, names, device_type="cpu")
    x, k = conv_inputs(*CONV[n])
    return distributed_fft_causal_conv(torus_comm(mesh, names),
                                       torch.from_numpy(x),
                                       torch.from_numpy(k)).numpy()


def conv_world(rank: int, n: int) -> np.ndarray:
    """:func:`conv_rows` on a one-axis torus over the whole world (the
    torus rank is the world rank)."""
    return conv_rows(n, (n,), ("x",))
