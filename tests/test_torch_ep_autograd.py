"""The port's all-to-all plans and expert-parallel MoE layer under
autograd, on a 4-rank gloo world, against the plans themselves and the
JAX reference.

The world is a (data=2, pod=2) torus, as in test_torch_moe_ep.py.  One
world runs every check; each is then a test of its own.

* The dense plan's Function (``core.plan._BlockwiseFn``): for direct,
  factorized (natural and paper, both round orders), overlap and
  autotune (replaying a winner measured in the world), the backward of
  ``forward`` is ``reverse`` on the cotangent bit for bit and the other
  way round, and ``<A x, y> = <x, A^T y>`` holds exactly (integer
  payloads in float64, the sums over the world exact); ``tiled`` the
  same way with split and concat axes swapped.
* The overlap engine's Function (``core.overlap.OverlapFn``):
  ``overlap(x, f, params=(w,))`` against the factorized plan's forward,
  ``f`` and reverse under autograd: the input's gradient bit for bit (``f``
  is elementwise, so chunking changes no sum), ``w``'s within 1e-12
  relative; forward and backward each make n_chunks x
  ``round_schedule``'s reorder passes per direction; without ``params``
  under autograd it raises, as does a compute stage without the reverse
  rounds.
* The ragged and sparse Alltoallv: the backward of ``forward(x, counts)``
  on the counted rows is ``reverse(g, recv_counts)``'s, bit for bit.
* The repair: on the mesh, ``moe_block`` gives every leaf (router, w1,
  w3, w2 and the input) a finite, non-zero gradient.  Before the plans
  were differentiable the expert weights got none.
* The MoE layer's gradients against ``jax.grad`` of ``mean(y**2) + 0.5
  aux`` through the reference's ``moe_block(mesh=mesh)`` on 4 forced
  host devices (a subprocess): E = 4, 8 and 2 (replicas) under
  factorized and overlap, dropless (the ragged Alltoallv) and dropless
  through the sparse one, per leaf within rtol = atol = 2e-4.  Each
  rank's loss is its share of the global mean times the 4 ranks, so the
  router's and the input's gradients are averaged over the ranks, the
  experts' scaled by 1/4 after their replicas are summed
  (``ExpertSharding.sum_replicas``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_dist import run_world

BLOCK = (3, 5)                 # the dense checks' block, float64 integers
TILED = (2, 8, 3)              # tiled input: split axis 1 (2 per rank)
ROW, MAX_COUNT = (4,), 5       # the Alltoallv checks' row and count bound
B, S, D = 8, 4, 32             # the MoE layer's global batch
AUX_W = 0.5
# name: (n_experts, a2a_backend, capacity_factor); None = dropless
MOE_CASES = {
    "E4-factorized": (4, "factorized", 8.0),
    "E8-factorized": (8, "factorized", 8.0),
    "E2-factorized": (2, "factorized", 8.0),
    "E4-overlap": (4, "overlap", 8.0),
    "E8-overlap": (8, "overlap", 8.0),
    "E2-overlap": (2, "overlap", 8.0),
    "E4-dropless": (4, "factorized", None),
    "E4-dropless-sparse": (4, "factorized", None),
}
DENSE = [("direct", "natural", None), ("autotune", "natural", None),
         ("overlap", "natural", None)] + [
    ("factorized", v, o) for v in ("natural", "paper")
    for o in ((0, 1), (1, 0))]


def _cfg(module, E, backend="factorized", cf=8.0):
    return module.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=E, top_k=2,
        capacity_factor=cf, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend)


def _int_payload(rng, shape):
    return rng.integers(-2**10, 2**10, shape).astype(np.float64)


def _dense_checks(rank, mesh, torch):
    """{(backend, variant, order): {check: bool}} for the dense Function."""
    import torch.distributed as dist
    from repro_torch.core.autotune import autotune
    from repro_torch.core.comm import torus_comm

    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(_int_payload(rng, (4,) + BLOCK))
    ct = torch.from_numpy(_int_payload(rng, (4,) + BLOCK))
    xt = torch.from_numpy(_int_payload(rng, TILED))
    # the tiled output: split axis 1 over 4 ranks, concatenated on axis 0
    ctt = torch.from_numpy(_int_payload(
        rng, (TILED[0] * 4, TILED[1] // 4, TILED[2])))
    autotune(mesh, ("data", "pod"), BLOCK, torch.float64, warmup=0,
             repeats=1, budget_seconds=60)

    def world_sum(t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    out = {}
    for backend, variant, order in DENSE:
        comm = torus_comm(mesh, ("data", "pod"), variant=variant)
        plan = comm.all_to_all(BLOCK, torch.float64, backend=backend,
                               round_order=order)
        ok = {"measured": backend != "autotune"
              or plan.describe()["tuned_from"] == "measured"}
        for name, call, adjoint in (("forward", plan.forward, plan.reverse),
                                    ("reverse", plan.reverse, plan.forward)):
            xg = x.clone().requires_grad_(True)
            y = call(xg)
            (g,) = torch.autograd.grad(y, xg, ct)
            ok[f"{name}_adjoint"] = torch.equal(g, adjoint(ct))
            ok[f"{name}_no_graph"] = y.grad_fn is not None \
                and not call(x).requires_grad
            # <A x, y> = <x, A^T y>, summed over the world, exactly
            ok[f"{name}_inner"] = torch.equal(
                world_sum(torch.sum(y.detach() * ct)),
                world_sum(torch.sum(x * g)))
        for rev in (False, True):
            xg = xt.clone().requires_grad_(True)
            y = plan.tiled(xg, 1, 0, reverse=rev)
            (g,) = torch.autograd.grad(y, xg, ctt)
            want = plan.tiled(ctt, 0, 1, reverse=not rev)
            ok[f"tiled_{rev}"] = torch.equal(g, want)
        out[(backend, variant, order)] = ok
    return out


def _overlap_checks(rank, mesh, torch):
    from repro_torch.core.comm import torus_comm
    comm = torus_comm(mesh, ("data", "pod"))
    rng = np.random.default_rng(200 + rank)
    x = torch.from_numpy(rng.standard_normal((4, 2, 6, 3)))
    ct = torch.from_numpy(rng.standard_normal((4, 2, 6, 3)))
    w0 = torch.from_numpy(rng.standard_normal((3,)))
    ov = comm.all_to_all((2, 6, 3), torch.float64, backend="overlap",
                         n_chunks=3)
    fa = comm.all_to_all((2, 6, 3), torch.float64, backend="factorized")

    def run(use_overlap):
        xg = x.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        f = lambda c, _i=0: torch.tanh(c) * w + c
        if use_overlap:
            y = ov.overlap(xg, f, chunk_axis=2, params=(w,))
        else:
            y = fa.reverse(f(fa.forward(xg)))
        return (y,) + torch.autograd.grad(y, (xg, w), ct)

    f_plain = lambda c, _i: c * 2
    # the reorder passes of the overlap call's forward and backward: each
    # n_chunks x round_schedule's passes per direction
    from repro_torch.core.factorized import round_schedule
    from repro_torch.kernels import ops
    passes = [0]
    real = {k: getattr(ops, k) for k in ("pack_round", "repack_round",
                                         "unpack_round")}

    def counting(fn):
        def wrapped(*a, **kw):
            passes[0] += 1
            return fn(*a, **kw)
        return wrapped
    for k, fn in real.items():
        setattr(ops, k, counting(fn))
    try:
        y1, gx1, gw1 = run(True)
    finally:
        for k, fn in real.items():
            setattr(ops, k, fn)
    per_call = 3 * (len(round_schedule((2, 2), ov.order))
                    + len(round_schedule((2, 2), ov.rev_order)))
    y2, gx2, gw2 = run(False)
    ok = {"output": torch.equal(y1, y2), "x_grad": torch.equal(gx1, gx2),
          "w_grad": bool(torch.allclose(gw1, gw2, rtol=1e-12, atol=0)),
          "passes": passes[0] == 2 * per_call}
    try:
        ov.overlap(x.clone().requires_grad_(True), lambda c, _i: c * 2,
                   chunk_axis=2)
        ok["needs_params"] = False
    except ValueError:
        ok["needs_params"] = True
    try:
        ov.overlap(x.clone().requires_grad_(True), f_plain, chunk_axis=2,
                   reverse=False, params=())
        ok["no_reverse_refused"] = False
    except NotImplementedError:
        ok["no_reverse_refused"] = True
    return ok


def _alltoallv_checks(rank, mesh, torch):
    """The backward of the ragged and sparse forward on counted rows."""
    from repro_torch.core.comm import torus_comm
    comm = torus_comm(mesh, ("data", "pod"))
    counts_all = np.random.default_rng(7).integers(0, MAX_COUNT + 1, (4, 4))
    counts_all[1, 2] = counts_all[3, 0] = 0
    counts = torch.from_numpy(counts_all[rank].astype(np.int32))
    rng = np.random.default_rng(300 + rank)
    x = torch.from_numpy(rng.standard_normal((4, MAX_COUNT) + ROW))
    plans = {"ragged": comm.ragged_all_to_all(ROW, torch.float64,
                                              max_count=MAX_COUNT,
                                              backend="factorized"),
             "sparse": comm.sparse_all_to_all(ROW, torch.float64,
                                              max_count=MAX_COUNT,
                                              density=0.5)}
    ok = {}
    for name, plan in plans.items():
        xg = x.clone().requires_grad_(True)
        y, rc = plan.forward(xg, counts)
        bucket = y.shape[1]
        # a cotangent on the counted rows received only
        keep = torch.arange(bucket)[None, :] < rc[:, None]
        ct = torch.from_numpy(np.random.default_rng(400 + rank)
                              .standard_normal(tuple(y.shape)))
        ct = ct * keep[..., None]
        (g,) = torch.autograd.grad(y, xg, ct)
        back, _ = plan.reverse(ct, rc)
        sent = torch.arange(MAX_COUNT)[None, :] < counts[:, None]
        ok[name] = torch.equal(g[sent], back[:, :MAX_COUNT][sent])
    return ok


def _moe_grads(rank, mesh, torch, params, x):
    """{case: (grads of router/w1/w3/w2 gathered, this rank's x grad,
    loss)} and the repair's {case: leaves without a usable gradient}."""
    import torch.distributed as dist
    from repro_torch.core.cache import mesh_shape
    from repro_torch.core.comm import torus_comm
    from repro_torch.models import config, moe
    from repro_torch.parallel.sharding import ExpertSharding

    xs = x[rank * 2:(rank + 1) * 2]
    n = 4
    out, missing = {}, {}
    for case, (E, backend, cf) in MOE_CASES.items():
        cfg = _cfg(config, E, backend, cf)
        sh = ExpertSharding({"w1": 0, "w3": 0, "w2": 0}, E, mesh)
        p = sh.shard_tree({k: torch.from_numpy(v)
                           for k, v in params[E].items()})
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xg = torch.from_numpy(xs).requires_grad_(True)
        if case.endswith("sparse"):
            axes, G, E_loc, R = moe._group_geometry(cfg, mesh)
            C = moe._capacity(cfg, 2 * S, max(E, G))
            plan = moe.moe_ep_comm(cfg, mesh, axes).sparse_all_to_all(
                (D,), cfg.cdtype, max_count=E_loc * C, density=0.5)
            batch = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
            y, aux = moe._moe_inner(
                xg, p["router"], p["w1"][None], p["w3"][None],
                p["w2"][None], cfg=cfg, G=G, E_loc=E_loc, R=R, C=C,
                ragged_plan=plan,
                reduce_group=torus_comm(mesh, batch[::-1]).fact.group)
        else:
            y, aux = moe.moe_block(p, xg, cfg, mesh=mesh)
        loss = torch.sum(y ** 2) / (B * S * D) * n + AUX_W * aux
        names = ["router", "w1", "w3", "w2"]
        got = torch.autograd.grad(loss, [p[k] for k in names] + [xg],
                                  allow_unused=True)
        missing[case] = [k for k, g in zip(names + ["x"], got)
                         if g is None or not torch.isfinite(g).all()
                         or float(g.abs().sum()) == 0.0]
        if missing[case]:
            continue
        grads = dict(zip(names, got[:4]))
        dist.all_reduce(grads["router"])
        grads = {k: sh.sum_replicas(k, g) / n for k, g in grads.items()}
        full = {k: sh.gather(k, g).numpy() for k, g in grads.items()}
        out[case] = (full, (got[4] / n).numpy(), float(loss))
    return out, missing


def _ranks(rank, n, params, x, db_path):
    import torch
    from repro_torch.core.cache import cart_create
    os.environ["REPRO_TORCH_TUNING_DB"] = db_path
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type="cpu")
    return {"dense": _dense_checks(rank, mesh, torch),
            "overlap": _overlap_checks(rank, mesh, torch),
            "alltoallv": _alltoallv_checks(rank, mesh, torch),
            "moe": _moe_grads(rank, mesh, torch, params, x)}


def _numpy_init(specs, seed):
    """A parameter tree drawn with numpy from ``seed``, by the reference's
    init rules (normal at 1 / sqrt(leading dim), ones, zeros), f32."""
    from repro_torch.models.common import tree_map
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("ones", "zeros"):
            return (np.ones if spec.init == "ones" else np.zeros)(
                spec.shape, np.float32)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None \
            else 1.0 / np.sqrt(max(1, fan_in))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    return tree_map(draw, specs)


def _params():
    """Each expert count's MoE weights (numpy); both packages take them."""
    from repro_torch.models import config
    from repro_torch.models.moe import moe_specs
    return {E: _numpy_init(moe_specs(_cfg(config, E)), E)
            for E in sorted({c[0] for c in MOE_CASES.values()})}


def _x():
    return np.random.default_rng(1).standard_normal((B, S, D)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference's gradients in a subprocess, started first, and
    the port's world meanwhile: ``(world, reference)``."""
    tmp = tmp_path_factory.mktemp("ep_autograd")
    params = _params()
    arrays = {"x": _x()}
    for E, p in params.items():
        arrays.update({f"{E}_{k}": v for k, v in p.items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
         repr((MOE_CASES, D, AUX_W)), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        world = run_world(_ranks, 4, tmp, params, _x(),
                          str(tmp / "tuning.json"), timeout=180)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    return world, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_grads(runs):
    return runs[1]


@pytest.mark.parametrize("case", DENSE, ids=lambda c: "-".join(map(str, c)))
def test_a2a_backward_is_the_reverse_plan(world, case):
    for rank, r in enumerate(world):
        bad = [k for k, v in r["dense"][case].items() if not v]
        assert not bad, (rank, bad)


def test_overlap_backward_matches_factorized(world):
    for rank, r in enumerate(world):
        bad = [k for k, v in r["overlap"].items() if not v]
        assert not bad, (rank, bad)


def test_alltoallv_backward_on_counted_rows(world):
    for rank, r in enumerate(world):
        assert r["alltoallv"] == {"ragged": True, "sparse": True}, rank


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_every_leaf_gets_a_gradient_on_the_mesh(world, case):
    for rank, r in enumerate(world):
        assert r["moe"][1][case] == [], (rank, r["moe"][1][case])


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.cache import cart_create
from repro.models import config
from repro.models.moe import moe_block

data = np.load(sys.argv[1])
cases, D, aux_w = eval(sys.argv[2])
mesh = cart_create(4, (2, 2), ("data", "pod"))
x = jax.device_put(jnp.asarray(data["x"]),
                   NamedSharding(mesh, P(("pod", "data"))))
out = {}
for name, (E, backend, cf) in cases.items():
    cfg = config.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=E, top_k=2,
        capacity_factor=cf, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend)
    p = {k: jnp.asarray(data[f"{E}_{k}"]) for k in ("router", "w1", "w3",
                                                   "w2")}

    def loss(p, x):
        y, aux = moe_block(p, x, cfg, mesh=mesh)
        return jnp.mean(y ** 2) + aux_w * aux
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(p, x)
    out[f"{name}_loss"] = np.asarray(val)
    out[f"{name}_x"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"{name}_{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_grads_match_jax_on_the_mesh(world, jax_grads, case):
    out = [r["moe"][0][case] for r in world]
    for k in ("router", "w1", "w3", "w2"):
        want = jax_grads[f"{case}_{k}"]
        for rank, (full, _, _) in enumerate(out):
            np.testing.assert_allclose(full[k], want, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{case} {k} rank {rank}")
    gx = np.concatenate([o[1] for o in out])
    np.testing.assert_allclose(gx, jax_grads[f"{case}_x"], rtol=2e-4,
                               atol=2e-4, err_msg=f"{case} x")
    # every rank's loss is its share of the global loss times 4
    np.testing.assert_allclose(np.mean([o[2] for o in out]),
                               float(jax_grads[f"{case}_loss"]), rtol=2e-4)
