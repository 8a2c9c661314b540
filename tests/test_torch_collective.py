"""The port's torus collectives on gloo worlds of 4, 6 and 12 ranks
(repro_torch.core: cart_create, TorusComm, A2APlan, the gather family).

One world per torus, spawned once per module (tests/torch_dist.py); every
check of that world runs inside it, and each check is then a test of its
own.  The reference is the definition of each collective, computed from
every rank's inputs, which each rank makes from the same seed: on rank r,
``forward(x)[i]`` is rank i's ``x[r]``.  All data is int64, so every
comparison is bit-exact (reduce-scatter sums included).  On the (2,3,2)
torus the outputs are also held against the JAX package's ``host_fn`` on
12 forced host devices, run in a subprocess (the pytest session itself
never sets ``XLA_FLAGS``).
"""

import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist import run_world

WORLDS = {4: ((2, 2), ("a", "b")), 6: ((3, 2), ("a", "b")),
          12: ((2, 3, 2), ("a", "b", "c"))}
CHECKS = ("rank_order", "direct", "factorized_natural", "factorized_paper",
          "reverse", "tiled", "sub", "all_gather", "reduce_scatter",
          "registry")
B = 3


def _inputs(p: int) -> np.ndarray:
    """Every rank's (p, B) send buffer: ``X[r, i]`` goes from r to i."""
    return np.random.default_rng(7).integers(-2**31, 2**31, (p, p, B))


def _coset(rank, dims, names, axes):
    """Global ranks of ``rank``'s coset over ``axes``, in torus order."""
    from repro_torch.core.simulator import rank_to_coords
    p = math.prod(dims)
    me = rank_to_coords(rank, dims)
    idx = [names.index(a) for a in axes]
    members = [r for r in range(p)
               if all(c == m for i, (c, m) in enumerate(
                   zip(rank_to_coords(r, dims), me)) if i not in idx)]
    sub_dims = [dims[i] for i in idx]

    def sub_rank(r):
        c = rank_to_coords(r, dims)
        return sum(c[i] * math.prod(sub_dims[:j]) for j, i in enumerate(idx))
    return sorted(members, key=sub_rank)


def _world_checks(rank, n, dims, names):
    """Runs on every rank; returns ``{check: bool}`` and this rank's
    factorized outputs for the JAX comparison."""
    import torch.distributed as dist
    from repro_torch.core import cache
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm

    p = math.prod(dims)
    X = torch.from_numpy(_inputs(p))
    x = X[rank].clone()
    want = X[:, rank]                       # y[i] = rank i's x[rank]
    mesh = cart_create(n, dims, names, device_type="cpu")
    comm = torus_comm(mesh, names)
    ok = {c: True for c in CHECKS}
    outs = {}

    ok["rank_order"] = (comm.rank == dist.get_rank() == rank
                        and tuple(mesh.get_coordinate()) == tuple(
                            reversed(comm.fact.coords)))

    plan = comm.all_to_all((B,), torch.int64, backend="direct")
    ok["direct"] = torch.equal(plan.forward(x), want)
    active = sum(s > 1 for s in dims)
    for variant in ("natural", "paper"):
        vcomm = torus_comm(mesh, names, variant=variant)
        for order in itertools.permutations(range(active)):
            plan = vcomm.all_to_all((B,), torch.int64, backend="factorized",
                                    round_order=order)
            y = plan.forward(x)
            ok[f"factorized_{variant}"] &= torch.equal(y, want)
            ok["reverse"] &= torch.equal(plan.reverse(x), want)
            outs[(variant, order)] = y.numpy()

    # tiled: split dim 1 of (2, p*2, 5) into p chunks, concat on dim 0
    t = torch.arange(2 * p * 2 * 5, dtype=torch.int64).reshape(2, p * 2, 5)
    t_of = [t + 10**6 * r for r in range(p)]
    want_t = torch.cat([t_of[s][:, rank * 2:(rank + 1) * 2] for s in
                        range(p)], dim=0)
    for backend in ("direct", "factorized"):
        plan = comm.all_to_all(backend=backend)
        ok["tiled"] &= torch.equal(plan.tiled(t_of[rank], 1, 0), want_t)
        ok["tiled"] &= torch.equal(plan.tiled(t_of[rank], 1, 0,
                                              reverse=True), want_t)

    # sub-communicators over every axis subset, in both orders
    for r in range(1, len(names) + 1):
        for axes in itertools.permutations(names, r):
            members = _coset(rank, dims, names, axes)
            q, me = len(members), members.index(rank)
            xs = X[rank, :q]
            want_s = torch.stack([X[m, me] for m in members])
            for backend in ("direct", "factorized"):
                plan = comm.sub(axes).all_to_all((B,), torch.int64,
                                                 backend=backend)
                ok["sub"] &= comm.sub(axes).rank == me
                ok["sub"] &= torch.equal(plan.forward(xs), want_s)

    # the gather family: rank i contributes G[i]; terms R[s, i] for rank i
    G = X[:, 0]
    for backend in ("direct", "factorized"):
        for order in itertools.permutations(range(active)):
            ag = comm.all_gather((B,), torch.int64, backend=backend,
                                 round_order=order)
            ok["all_gather"] &= torch.equal(ag.forward(G[rank]), G)
            rs = comm.reduce_scatter((B,), torch.int64, backend=backend,
                                     round_order=order)
            ok["reduce_scatter"] &= torch.equal(rs.forward(X[rank]),
                                                X[:, rank].sum(0))

    # registry: a refetch hits; a freed comm rebuilds on the same groups
    plan = comm.all_to_all((B,), torch.int64, backend="factorized")
    ok["registry"] = (comm.all_to_all((B,), torch.int64,
                                      backend="factorized") is plan
                      and plan.describe()["cache"] == "hit")
    made = cache.cache_stats()["groups_created"]
    comm.free()
    again = torus_comm(mesh, names)
    ok["registry"] &= again is not comm and torch.equal(
        again.all_to_all((B,), torch.int64, backend="factorized")
        .forward(x), want)
    ok["registry"] &= cache.cache_stats()["groups_created"] == made
    return {k: bool(v) for k, v in ok.items()}, outs


_RESULTS: dict = {}


def _results(n, tmp_path_factory):
    """Each world runs once per session, whichever test asks first."""
    if n not in _RESULTS:
        _RESULTS[n] = run_world(_world_checks, n,
                                tmp_path_factory.mktemp("gloo"), *WORLDS[n])
    return _RESULTS[n]


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    return request.param, _results(request.param, tmp_path_factory)


@pytest.mark.parametrize("check", CHECKS)
def test_collective_on_gloo(world, check):
    n, results = world
    failed = [r for r, (ok, _) in enumerate(results) if not ok[check]]
    assert not failed, f"{check} wrong on ranks {failed} of the " \
        f"{WORLDS[n][0]} torus"


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
from repro.core.cache import cart_create
from repro.core.plan import plan_all_to_all

dims, names = (2, 3, 2), ("a", "b", "c")
X = np.load(sys.argv[1])["X"]
mesh = cart_create(12, dims, names)
out = {}
for backend, variant in (("direct", "natural"), ("factorized", "natural"),
                         ("factorized", "paper")):
    plan = plan_all_to_all(mesh, names, X.shape[2:], X.dtype,
                           backend=backend, variant=variant)
    out[f"{backend}_{variant}"] = np.asarray(plan.host_fn(mesh)(X))
np.savez(sys.argv[2], **out)
"""


def test_factorized_matches_jax_host_fn(tmp_path, tmp_path_factory):
    """(2,3,2): the port's rank outputs == the JAX package's host_fn."""
    results = _results(12, tmp_path_factory)
    X = _inputs(12).astype(np.int32)          # JAX runs without x64
    np.savez(tmp_path / "in.npz", X=X)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_out = np.load(tmp_path / "out.npz")
    for key in jax_out.files:
        np.testing.assert_array_equal(jax_out[key], X.transpose(1, 0, 2))
    for rank, (_, outs) in enumerate(results):
        for (variant, order), y in outs.items():
            np.testing.assert_array_equal(
                y.astype(np.int32), jax_out[f"factorized_{variant}"][rank])
