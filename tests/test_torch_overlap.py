"""The port's overlap engine (repro_torch.core.overlap: the ``pipelined``
and ``overlap`` backends of A2APlan, and the chunked gather family) on
gloo worlds of 4 and 6 ranks, against the port's factorized all-to-all,
the collective's definition and the JAX package.

One world per torus, spawned once per module; every check of that world
runs inside it, and each check is then a test of its own.  Rank r's send
buffer is ``X[r]`` (the same seeded numpy array on every rank), so
``forward(x)[i]`` must be rank i's ``X[i, r]``.  The data are integers
stored as float32 and ``compute_fn`` is ``2 x + 1``, exact in float32, so
every comparison is bit for bit.  The JAX reference runs the same plans
(``plan_all_to_all(..., backend="overlap")``) inside ``shard_map`` on 6
forced host devices, in a subprocess (the pytest session itself never
sets ``XLA_FLAGS``).
"""

import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import overlap as jax_overlap
from repro_torch.core import overlap
from torch_dist import run_world

WORLDS = {4: ((2, 2), ("a", "b")), 6: ((2, 3), ("a", "b"))}
CHECKS = ("forward", "reverse", "tiled", "overlap_reverse",
          "overlap_no_reverse", "overlap_chunk_axis", "passes",
          "chunk_copies", "no_substitute", "overlap_no_reverse_grad")
B = 6                          # block elements: 3 chunks divide, 4 do not
TILED = (2, 2, 5)              # (rows, per-rank split, cols) of tiled input
CHUNKED = (3, 4)               # block of the chunk_axis=2 case
JAX_CASES = [(v, n) for v in ("natural", "paper") for n in (2, 3)]


def _inputs(p: int, block) -> np.ndarray:
    """Every rank's (p, *block) send buffer, integers as float32."""
    return np.random.default_rng(11).integers(
        -2**20, 2**20, (p, p) + tuple(block)).astype(np.float32)


def _tiled_input(p: int) -> np.ndarray:
    """Every rank's (rows, per * p, cols) tiled input (split axis 1)."""
    rows, per, cols = TILED
    return np.random.default_rng(12).integers(
        -2**20, 2**20, (p, rows, per * p, cols)).astype(np.float32)


def _compute(chunk, _c):
    return 2 * chunk + 1


def _grad_input(p: int) -> np.ndarray:
    """Every rank's (p, B) f64 send buffer of the gradient cases."""
    return np.random.default_rng(13).standard_normal((p, p, B))


def _stage(chunk, _c=0):
    """The gradient cases' compute stage (the reference audit's)."""
    return (chunk.sin() if hasattr(chunk, "sin") else np.sin(chunk)) * 2.0


def _cases(comm, torch):
    """(name, plan) of every overlap-engine plan a world runs."""
    for backend, nc in itertools.product(("pipelined", "overlap"),
                                         (1, 2, 3)):
        for order in itertools.permutations(range(comm.d)):
            yield (backend, nc, order), comm.all_to_all(
                (B,), torch.float32, backend=backend, round_order=order,
                n_chunks=nc)


def _world_checks(rank, n, dims, names):
    """Runs on every rank; returns ``{check: bool}`` and this rank's
    outputs of the JAX cases."""
    import torch
    from repro_torch.core import telemetry
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.factorized import round_schedule
    from repro_torch.kernels import ops as kops

    p = math.prod(dims)
    X = torch.from_numpy(_inputs(p, (B,)))
    x, want = X[rank].clone(), X[:, rank]
    X3 = torch.from_numpy(_inputs(p, CHUNKED))
    XG = torch.from_numpy(_grad_input(p))
    x3 = X3[rank].clone()
    T = torch.from_numpy(_tiled_input(p))
    per = TILED[1]
    want_t = torch.cat([T[s][:, rank * per:(rank + 1) * per]
                        for s in range(p)])
    mesh = cart_create(n, dims, names, device_type="cpu")
    ok = {c: True for c in CHECKS}
    outs, grads = {}, {}

    calls = []
    saved = {name: getattr(kops, name) for name in
             ("pack_round", "unpack_round", "repack_round")}

    def counting(name):
        def fn(*args, **kwargs):
            calls.append(name)
            return saved[name](*args, **kwargs)
        return fn

    for name in saved:
        setattr(kops, name, counting(name))
    try:
        for variant in ("natural", "paper"):
            comm = torus_comm(mesh, names, variant=variant)
            for (backend, nc, order), plan in _cases(comm, torch):
                fact = comm.all_to_all((B,), torch.float32,
                                       backend="factorized",
                                       round_order=order)
                calls.clear()
                y = plan.forward(x)
                ok["forward"] &= torch.equal(y, want) and torch.equal(
                    y, fact.forward(x))
                # B = 6: n_chunks runs 1, 2 or 3 chunks, each making the
                # passes of one factorized call
                fwd = len(round_schedule(dims, order, variant))
                rev = len(round_schedule(dims, plan.rev_order, variant))
                ok["passes"] &= len(calls) == nc * fwd + fwd
                ok["no_substitute"] &= plan.backend == backend
                ok["reverse"] &= torch.equal(plan.reverse(x), want)
                ok["tiled"] &= torch.equal(plan.tiled(T[rank], 1, 0),
                                           want_t)
                ok["tiled"] &= torch.equal(
                    plan.tiled(T[rank], 1, 0, reverse=True), want_t)
                calls.clear()
                got = plan.overlap(x, _compute)
                ok["passes"] &= len(calls) == nc * (fwd + rev)
                ok["overlap_reverse"] &= torch.equal(
                    got, fact.reverse(_compute(fact.forward(x), 0)))
                ok["overlap_no_reverse"] &= torch.equal(
                    plan.overlap(x, _compute, reverse=False),
                    _compute(want, 0))
                counters = [telemetry.metrics().counter(f"overlap.{k}")
                            for k in ("chunk_copies", "concat_copies")]
                before = [c.value for c in counters]
                got = plan.overlap(x3, _compute, chunk_axis=2)
                copied, joined = (c.value - b
                                  for c, b in zip(counters, before))
                ok["overlap_chunk_axis"] &= torch.equal(
                    got, fact.reverse(_compute(fact.forward(x3), 0)))
                # the (p, 3, 4) block's axis 2 splits into min(nc, 2)
                # strided chunks, each copied once, and joined once
                ok["chunk_copies"] &= copied == (0 if nc == 1 else 2)
                ok["chunk_copies"] &= joined == (0 if nc == 1 else 1)
                # the compute stage without reverse rounds under
                # autograd, f64: the gradient of sum(y ** 2) bit for bit
                # the factorized composition's
                g = {}
                for key, pl in (("over", plan), ("fact", fact)):
                    pl = comm.all_to_all((B,), torch.float64,
                                         backend=pl.backend,
                                         round_order=order, n_chunks=nc)
                    xg = XG[rank].clone().requires_grad_(True)
                    yg = pl.overlap(xg, _stage, reverse=False, params=()) \
                        if key == "over" else _stage(pl.forward(xg))
                    (g[key],) = torch.autograd.grad((yg ** 2).sum(), xg)
                ok["overlap_no_reverse_grad"] &= torch.equal(g["over"],
                                                             g["fact"])
                if backend == "overlap" and order == (0, 1) and \
                        (variant, nc) in JAX_CASES:
                    grads[(variant, nc)] = g["over"].numpy()
                    outs[(variant, nc)] = {
                        "forward": y.numpy(),
                        "reverse": plan.reverse(x).numpy(),
                        "tiled": plan.tiled(T[rank], 1, 0).numpy(),
                        "overlap": plan.overlap(x, _compute).numpy(),
                        "overlap_fwd": plan.overlap(
                            x, _compute, reverse=False).numpy(),
                        "overlap_axis": got.numpy()}
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)

    return {k: bool(v) for k, v in ok.items()}, outs, grads


_RESULTS: dict = {}


def _results(n, tmp_path_factory):
    if n not in _RESULTS:
        _RESULTS[n] = run_world(_world_checks, n,
                                tmp_path_factory.mktemp("overlap"),
                                *WORLDS[n])
    return _RESULTS[n]


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    return request.param, _results(request.param, tmp_path_factory)


@pytest.mark.parametrize("check", CHECKS)
def test_overlap_on_gloo(world, check):
    n, results = world
    failed = [r for r, (ok, *_) in enumerate(results) if not ok[check]]
    assert not failed, f"{check} wrong on ranks {failed} of the " \
        f"{WORLDS[n][0]} torus"


@pytest.mark.parametrize("n_chunks,n_stages",
                         [(c, s) for c in range(1, 5) for s in range(1, 8)])
def test_pipeline_order_matches_reference(n_chunks, n_stages):
    assert list(overlap.pipeline_order(n_chunks, n_stages)) == \
        list(jax_overlap.pipeline_order(n_chunks, n_stages))
    stages = [lambda st, c, k=k: st + [(k, c)] for k in range(n_stages)]
    states = [[c] for c in range(n_chunks)]
    assert overlap.run_pipelined(states, stages) == \
        jax_overlap.run_pipelined(states, stages)


def test_split_chunks_shrinks_like_the_reference():
    import jax.numpy as jnp
    import torch
    for size, n in ((6, 3), (6, 4), (5, 3), (7, 7), (1, 4), (12, 5)):
        x = np.arange(2 * size).reshape(2, size)
        got = overlap._split_chunks(torch.from_numpy(x), 1, n)
        want = jax_overlap._split_chunks(jnp.asarray(x), 1, n)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.core.cache import cart_create
from repro.core.plan import plan_all_to_all

cases = eval(sys.argv[2])
data = np.load(sys.argv[1])
out = {}
for n, dims, names in eval(sys.argv[3]):
    X, X3, T = data[f"X{n}"], data[f"X3_{n}"], data[f"T{n}"]
    mesh = cart_create(jax.devices()[:n], dims, names)
    spec = P(tuple(reversed(names)))
    f = lambda c, _i: 2 * c + 1
    for variant, nc in cases:
        plan = plan_all_to_all(mesh, names, X.shape[2:], X.dtype,
                               backend="overlap", variant=variant,
                               n_chunks=nc)

        def local(x, x3, t):
            x, x3, t = x[0], x3[0], t[0]
            res = (plan.forward(x), plan.reverse(x), plan.tiled(t, 1, 0),
                   plan.overlap(x, f), plan.overlap(x, f, reverse=False),
                   plan.overlap(x3, f, chunk_axis=2))
            return tuple(r[None] for r in res)

        res = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=(spec,) * 6))(X, X3, T)
        for key, r in zip(("forward", "reverse", "tiled", "overlap",
                           "overlap_fwd", "overlap_axis"), res):
            out[f"{n}_{variant}_{nc}_{key}"] = np.asarray(r)
np.savez(sys.argv[4], **out)
"""


def test_overlap_matches_jax(tmp_path, tmp_path_factory):
    """Each rank's outputs equal the JAX package's overlap plans, bit for
    bit, on both tori."""
    arrays = {}
    for n in WORLDS:
        p = math.prod(WORLDS[n][0])
        arrays[f"X{n}"] = _inputs(p, (B,))
        arrays[f"X3_{n}"] = _inputs(p, CHUNKED)
        arrays[f"T{n}"] = _tiled_input(p)
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    worlds = [(n, dims, names) for n, (dims, names) in WORLDS.items()]
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(tmp_path / "in.npz"), repr(JAX_CASES),
                           repr(worlds), str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_out = np.load(tmp_path / "out.npz")
    for n in WORLDS:
        for rank, (_, outs, _) in enumerate(_results(n, tmp_path_factory)):
            for (variant, nc), res in outs.items():
                for key, y in res.items():
                    np.testing.assert_array_equal(
                        y, jax_out[f"{n}_{variant}_{nc}_{key}"][rank],
                        err_msg=f"{n} ranks {variant} n_chunks={nc} {key}")


_JAX_GRAD_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.cache import cart_create
from repro.core.plan import plan_all_to_all

cases = eval(sys.argv[2])
data = np.load(sys.argv[1])
out = {}
for n, dims, names in eval(sys.argv[3]):
    X = jnp.asarray(data[f"X{n}"])
    mesh = cart_create(jax.devices()[:n], dims, names)
    spec = P(tuple(reversed(names)))
    stage = lambda c, _i=0: jnp.sin(c) * 2.0
    for variant, nc in cases:
        plan = plan_all_to_all(mesh, names, X.shape[2:], X.dtype,
                               backend="overlap", variant=variant,
                               n_chunks=nc)
        run = jax.shard_map(
            lambda x: plan.overlap(x[0], stage, reverse=False)[None],
            mesh=mesh, in_specs=spec, out_specs=spec)
        g = jax.jit(jax.grad(lambda x: (run(x) ** 2).sum()))(X)
        out[f"{n}_{variant}_{nc}"] = np.asarray(g)
np.savez(sys.argv[4], **out)
"""


def test_overlap_no_reverse_grad_matches_jax(tmp_path, tmp_path_factory):
    """``overlap(x, sin(c) * 2, reverse=False)`` under autograd, f64: each
    rank's gradient of ``sum(y ** 2)`` against ``jax.grad`` of the
    reference's overlap plan on the same torus, within 1e-12 relative
    (``sin`` is XLA's on one side and torch's on the other)."""
    arrays = {f"X{n}": _grad_input(math.prod(WORLDS[n][0]))
              for n in WORLDS}
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    worlds = [(n, dims, names) for n, (dims, names) in WORLDS.items()]
    proc = subprocess.run([sys.executable, "-c", _JAX_GRAD_SCRIPT,
                           str(tmp_path / "in.npz"), repr(JAX_CASES),
                           repr(worlds), str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_out = np.load(tmp_path / "out.npz")
    for n in WORLDS:
        for rank, (*_, grads) in enumerate(_results(n, tmp_path_factory)):
            assert set(grads) == set(JAX_CASES)
            for (variant, nc), g in grads.items():
                np.testing.assert_allclose(
                    g, jax_out[f"{n}_{variant}_{nc}"][rank], rtol=1e-12,
                    atol=1e-14,
                    err_msg=f"{n} ranks {variant} n_chunks={nc}")
