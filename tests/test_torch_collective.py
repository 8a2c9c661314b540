"""The port's torus collectives on gloo worlds of 4, 6 and 12 ranks
(repro_torch.core: cart_create, TorusComm, A2APlan, the gather family),
and, last in the 12-rank world, ``TorusComm.rebuild`` on the survivors of
a device loss (``_rebuild_leg``).

One world per torus, spawned once per module (tests/torch_dist.py); every
check of that world runs inside it, and each check is then a test of its
own.  The reference is the definition of each collective, computed from
every rank's inputs, which each rank makes from the same seed: on rank r,
``forward(x)[i]`` is rank i's ``x[r]``.  All data is int64, so every
comparison is bit-exact (reduce-scatter sums included).  On the (2,3,2)
torus the outputs are also held against the JAX package's ``host_fn`` on
12 forced host devices, run in a subprocess (the pytest session itself
never sets ``XLA_FLAGS``).

The gather family under autograd (``allgather_grad``,
``reduce_scatter_grad``): f64 inputs and loss weights holding integers,
so every sum is exact, against the definition (the all-gather's input
gradient is each rank's block of every rank's cotangent, summed; the
reduce-scatter's is every rank's cotangent, gathered); on the (2,2)
torus also against ``jax.grad`` of the reference's plans on 4 forced
host devices.
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
          "registry", "passes", "group_order", "allgather_grad",
          "reduce_scatter_grad")
B = 3


def _inputs(p: int) -> np.ndarray:
    """Every rank's (p, B) send buffer: ``X[r, i]`` goes from r to i."""
    return np.random.default_rng(7).integers(-2**31, 2**31, (p, p, B))


def _grad_inputs(p: int):
    """Integer-valued f64 data for the gradient checks: every rank's
    gather block ``G[r]`` and reduce-scatter terms ``X[r]``, and the loss
    weights of rank r, ``WG[r]`` on its gathered ``(p, B)`` output and
    ``WR[r]`` on its reduced ``(B,)`` output."""
    rng = np.random.default_rng(11)
    return {"G": rng.integers(-50, 50, (p, B)).astype(np.float64),
            "X": rng.integers(-50, 50, (p, p, B)).astype(np.float64),
            "WG": rng.integers(-9, 10, (p, p, B)).astype(np.float64),
            "WR": rng.integers(-9, 10, (p, B)).astype(np.float64)}


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

    # the gather family under autograd: rank r's loss is the sum of its
    # output times its weights; each backward is the other collective
    D = {k: torch.from_numpy(v) for k, v in _grad_inputs(p).items()}
    grads = {}
    for backend in ("direct", "factorized"):
        for order in itertools.permutations(range(active)):
            ag = comm.all_gather((B,), torch.float64, backend=backend,
                                 round_order=order)
            rs = comm.reduce_scatter((B,), torch.float64, backend=backend,
                                     round_order=order)
            g_ag = _input_grad(ag, D["G"][rank], D["WG"][rank], D["G"])
            g_rs = _input_grad(rs, D["X"][rank], D["WR"][rank],
                               D["X"][:, rank].sum(0))
            ok["allgather_grad"] &= g_ag is not None and torch.equal(
                g_ag, D["WG"][:, rank].sum(0))
            ok["reduce_scatter_grad"] &= g_rs is not None and torch.equal(
                g_rs, D["WR"])
            grads[backend] = (g_ag, g_rs)

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

    ok["passes"] = _passes_follow_the_schedule(mesh, names, x, want)
    ok["group_order"] = _group_order_checks(n, dims, names, X)
    if n == 12:                    # last: ranks 8-11 leave the world
        ok.update(_rebuild_leg())
    return {k: bool(v) for k, v in ok.items()}, outs, grads


REBUILD_LOST = (8, 9, 10, 11)
REBUILD_CHECKS = ("fired", "recover", "dims", "lineage", "slice",
                  "migrated", "bits", "partition")


def _rebuild_leg():
    """``check_rebuild.py`` part 1 on the 12-rank world: a (3,4) torus
    loses ranks 8-11 on its plan's 3rd call (they then make no call), and
    the 8 survivors rebuild it to (2,4) by themselves: factorized ==
    direct == the definition bit for bit on the survivor torus, exactly
    the dead comm's plan slice freed (another comm's plan kept as the same
    object), and the one tuning record whose axis kept its extent (j, 4)
    migrated.  Returns ``{"rebuild:<check>": bool}``."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core.autotune import TuningDB, db_fingerprint, \
        plan_db_key
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.faults import (DeviceLossError, FaultInjector,
                                         FaultSpec)
    from repro_torch.core.plan import plan_cache_stats
    from repro_torch.runtime.watchdog import StragglerWatchdog

    rank = dist.get_rank()
    ok = {f"rebuild:{c}": rank in REBUILD_LOST for c in REBUILD_CHECKS}
    record = {"version": 1, "axis_names": ["j"], "dims": [4],
              "winner": {"backend": "factorized", "round_order": [0],
                         "n_chunks": 1, "median_us": 10.0}}
    key = lambda fp: plan_db_key(fp, (4,), ("j",), (8,), "float32",
                                 "natural")
    with tempfile.TemporaryDirectory() as tmp:
        db = TuningDB(Path(tmp) / "tuning.json")
        mesh = cart_create(12, (3, 4), ("i", "j"), device_type="cpu")
        comm = torus_comm(mesh, ("i", "j"), db=db)
        plan = comm.all_to_all((4,), torch.float32, backend="factorized")
        other = torus_comm((5,), ("k",))
        kept = other.all_to_all((4,), torch.float32, backend="direct")
        db.put(key(db_fingerprint(mesh)), record)
        inj = FaultInjector((FaultSpec("device_loss", at_call=3,
                                       devices=REBUILD_LOST),))
        inj.install(plan)
        X = (torch.arange(12 * 12 * 4) % 251).reshape(12, 12, 4).float()
        err = None
        for _ in range(3):
            try:
                plan.forward(X[comm.rank])
            except DeviceLossError as e:
                err = e
                break
        if rank in REBUILD_LOST:
            return ok
        ok["rebuild:fired"] = err is not None \
            and err.devices == REBUILD_LOST
        action = StragglerWatchdog().policy(3, 0.0, verdict="device_loss")
        ok["rebuild:recover"] = action.kind == "recover"
        before = plan_cache_stats()["size"]
        fresh = comm.rebuild([r for r in mesh.mesh.flatten().tolist()
                              if r not in err.devices])
        ok["rebuild:dims"] = (fresh.dims == (2, 4) and fresh.p == 8
                              and fresh.axis_names == ("i", "j")
                              and fresh.mesh is not None)
        ok["rebuild:lineage"] = comm._freed and fresh.rebuilt_from == {
            "dims": [3, 4], "axes": ["i", "j"], "p": 12} \
            and fresh.describe()["rebuilt_from"]["p"] == 12
        ok["rebuild:slice"] = (plan_cache_stats()["size"] == before - 1
                               and other.all_to_all(
                                   (4,), torch.float32,
                                   backend="direct") is kept)
        rec = db.get(key(db_fingerprint(fresh.mesh)))
        ok["rebuild:migrated"] = fresh.tuning_migrated == 1 \
            and rec is not None and rec["migrated"] is True
        X8 = (torch.arange(8 * 8 * 4) % 251).reshape(8, 8, 4).float()
        x8 = X8[fresh.rank]
        yf = fresh.all_to_all((4,), torch.float32,
                              backend="factorized").forward(x8)
        yd = fresh.all_to_all((4,), torch.float32,
                              backend="direct").forward(x8)
        ok["rebuild:bits"] = torch.equal(yf, yd) \
            and torch.equal(yf, X8[:, fresh.rank])
        # the survivors split by rank range: each builds its own half's
        # mesh with its members alone and holds the other half dims-only
        first, rest = fresh.partition(4)
        mine, other_half = (first, rest) if fresh.rank < 4 \
            else (rest, first)
        X4 = X8[:4, :4]
        ok["rebuild:partition"] = (
            first.dims == rest.dims == (2, 2) and mine.mesh is not None
            and other_half.mesh is None
            and torch.equal(mine.all_to_all((4,), torch.float32,
                                            backend="factorized")
                            .forward(X4[mine.rank]), X4[:, mine.rank]))
    return ok


def _input_grad(plan, x, w, want):
    """The gradient of ``sum(plan.forward(x) * w)`` with respect to ``x``,
    or None where the forward is not ``want`` or autograd fails (every
    rank runs the same calls, so one rank's failure is every rank's)."""
    x = x.clone().requires_grad_(True)
    try:
        y = plan.forward(x)
        y.mul(w).sum().backward()
    except RuntimeError:
        return None
    if x.grad is None or not torch.equal(y.detach(), want):
        return None
    return x.grad


def _passes_follow_the_schedule(mesh, names, x, want):
    """Every factorized call makes exactly the reorder passes
    ``round_schedule`` lists, in its order (counted at ``kernels.ops``)."""
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.factorized import round_schedule
    from repro_torch.kernels import ops as kops

    names_of = {"pack_round": lambda ku, kp: ku is None,
                "unpack_round": lambda ku, kp: kp is None,
                "repack_round": lambda ku, kp: None not in (ku, kp)}
    saved = {name: getattr(kops, name) for name in names_of}
    calls = []

    def counting(name):
        def fn(*args, **kwargs):
            calls.append(name)
            return saved[name](*args, **kwargs)
        return fn

    def kinds(passes):
        return [next(n for n, f in names_of.items() if f(ku, kp))
                for ku, kp in passes]

    ok = True
    for name in names_of:
        setattr(kops, name, counting(name))
    try:
        for variant in ("natural", "paper"):
            comm = torus_comm(mesh, names, variant=variant)
            dims = comm.fact.dims
            for order in itertools.permutations(range(len(dims))):
                plan = comm.all_to_all((B,), torch.int64,
                                       backend="factorized",
                                       round_order=order)
                for run, o in ((plan.forward, plan.order),
                               (plan.reverse, plan.rev_order)):
                    calls.clear()
                    ok &= torch.equal(run(x), want)
                    ok &= calls == kinds(round_schedule(dims, o, variant))
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)
    return ok


def _group_order_checks(n, dims, names, X):
    """The same collectives over a mesh of the ranks in reverse order:
    the groups' rank orders differ from the torus order, and the
    factorized passes fold them into their maps."""
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm

    mesh = cart_create(list(reversed(range(n))), dims, names,
                       device_type="cpu")
    comm = torus_comm(mesh, names)
    t = comm.rank
    x, want = X[t].clone(), X[:, t]
    ok = t == n - 1 - dist.get_rank()        # its place in the rank list
    ok &= any(g is not None and g.order is not None
              for g in comm.fact.dim_groups)
    ok &= torch.equal(comm.all_to_all((B,), torch.int64, backend="direct")
                      .forward(x), want)
    for variant in ("natural", "paper"):
        vcomm = torus_comm(mesh, names, variant=variant)
        for order in itertools.permutations(range(len(dims))):
            plan = vcomm.all_to_all((B,), torch.int64, backend="factorized",
                                    round_order=order)
            ok &= torch.equal(plan.forward(x), want)
            ok &= torch.equal(plan.reverse(x), want)
    G = X[:, 0]
    for backend in ("direct", "factorized"):
        ok &= torch.equal(comm.all_gather((B,), torch.int64,
                                          backend=backend).forward(G[t]), G)
        ok &= torch.equal(comm.reduce_scatter((B,), torch.int64,
                                              backend=backend).forward(
                                                  X[t]), X[:, t].sum(0))
    return ok


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
    failed = [r for r, (ok, _, _) in enumerate(results) if not ok[check]]
    assert not failed, f"{check} wrong on ranks {failed} of the " \
        f"{WORLDS[n][0]} torus"


@pytest.mark.parametrize("check", REBUILD_CHECKS)
def test_rebuild_on_the_survivors_of_12(tmp_path_factory, check):
    """The 8 survivors of the 12-rank world rebuild (3,4) -> (2,4) with no
    call from ranks 8-11 (``_rebuild_leg``)."""
    results = _results(12, tmp_path_factory)
    failed = [r for r, (ok, _, _) in enumerate(results)
              if not ok[f"rebuild:{check}"]]
    assert not failed, f"rebuild {check} wrong on ranks {failed}"


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
    for rank, (_, outs, _) in enumerate(results):
        for (variant, order), y in outs.items():
            np.testing.assert_array_equal(
                y.astype(np.int32), jax_out[f"factorized_{variant}"][rank])


_JAX_GRAD_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.cache import cart_create
from repro.core.comm import torus_comm

dims, names = (2, 2), ("a", "b")
D = {k: jnp.asarray(v, jnp.float32) for k, v in np.load(sys.argv[1]).items()}
mesh = cart_create(4, dims, names)
comm = torus_comm(mesh, names)
axes = tuple(reversed(names))
out = {}
for backend in ("direct", "factorized"):
    ag = comm.all_gather((3,), jnp.float32, backend=backend)
    rs = comm.reduce_scatter((3,), jnp.float32, backend=backend)

    def losses(fn, x, w):
        local = lambda xl, wl: (fn(xl[0]) * wl[0]).sum()[None]
        return jax.shard_map(local, mesh=mesh, in_specs=(P(axes), P(axes)),
                             out_specs=P(axes))(x, w).sum()

    out[f"{backend}_allgather"] = np.asarray(jax.jit(jax.grad(
        lambda x: losses(ag.forward, x, D["WG"])))(D["G"]))
    out[f"{backend}_reduce_scatter"] = np.asarray(jax.jit(jax.grad(
        lambda x: losses(rs.forward, x, D["WR"][:, None])))(D["X"]))
np.savez(sys.argv[2], **out)
"""


def test_gather_family_grads_match_jax_grad(tmp_path, tmp_path_factory):
    """(2,2): each rank's input gradients of the all-gather and the
    reduce-scatter, both backends, == ``jax.grad`` of the reference's
    plans on 4 forced host devices (rank r's loss: its output times its
    weights, summed; integer values, exact in f32)."""
    results = _results(4, tmp_path_factory)
    D = _grad_inputs(4)
    np.savez(tmp_path / "in.npz", **D)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _JAX_GRAD_SCRIPT,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = np.load(tmp_path / "out.npz")
    for rank, (_, _, grads) in enumerate(results):
        for backend, (g_ag, g_rs) in grads.items():
            assert g_ag is not None and g_rs is not None, (rank, backend)
            np.testing.assert_array_equal(g_ag.numpy(), want[f"{backend}_allgather"]
                                          [rank])
            np.testing.assert_array_equal(
                g_rs.numpy(), want[f"{backend}_reduce_scatter"][rank])
