"""Sequence and pipeline parallelism in the port, on one 8-rank gloo
world, against the JAX reference on 8 forced host devices.

* ``parallel.ulysses.ulysses_attention`` on ``check_ulysses.py``'s seven
  cases, mesh (data=2, model=4), B 4, S 32, hd 16, f32: kv heads
  divisible (the tiled all-to-all re-shards q, k and v), GQA with Hkv <
  sp (k and v all-gathered along the sequence), non-causal, a window,
  and the overlap backend's head-group chunks (2 chunks at 8/8 and
  16/8; at 8/4 the chunks do not divide and it falls back to one).  The
  output (rtol = atol = 2e-4, the device script's) against the
  reference's, and the gradients of q, k and v against ``jax.grad`` of
  it; the re-shard itself (``A2APlan.tiled``) against the definition
  of the tiled all-to-all, bit for bit.
* ``parallel.ring_attention.ring_attention`` on
  ``check_ring_attention.py``'s four cases (2e-4), and the gradients
  of the GQA case against ``jax.grad`` (2e-4).
* ``parallel.pipeline``: ``check_pipeline.py``'s 4 stages x 2 residual
  MLP layers (D 16, H 32) over 4 microbatches on the ``pod`` axis of a
  (pod=4, data=2) mesh: the forward against the reference's (1e-5) and
  the sequential run, each stage's parameter gradients against
  ``jax.grad`` of the reference's pipeline (1e-4).
* ``parallel.sharding.sp_gather`` and ``ppermute`` over the ``model``
  group: forward and gradients against their definitions, bit for bit
  (the gather's backward this rank's own slice, the permutation's the
  inverse permutation, zeros where no member sends).

Inputs are drawn with numpy from seeds and carried to both packages.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_dist import run_world

B, S, HD = 4, 32, 16
# check_ulysses.py's cases: (Hq, Hkv, causal, window, backend, chunks)
ULYSSES = {"8/8": (8, 8, True, None, "tuned", 0),
           "8/2": (8, 2, True, None, "tuned", 0),
           "4/4-noncausal": (4, 4, False, None, "tuned", 0),
           "8/8-window": (8, 8, True, 8, "tuned", 0),
           "8/8-overlap": (8, 8, True, None, "overlap", 2),
           "16/8-overlap": (16, 8, True, None, "overlap", 2),
           "8/4-overlap": (8, 4, True, None, "overlap", 2)}
# check_ring_attention.py's cases: (Hq, Hkv, causal, window)
RING = {"4/4": (4, 4, True, None), "8/2": (8, 2, True, None),
        "4/4-noncausal": (4, 4, False, None),
        "4/4-window": (4, 4, True, 8)}
RING_GRAD = "8/2"
STAGES, L_PER, D, H, PIPE_B, MICRO = 4, 2, 16, 32, 8, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(Hq, Hkv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, h, S, HD)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


def _cotangent(Hq, seed):
    return np.random.default_rng(100 + seed).standard_normal(
        (B, Hq, S, HD)).astype(np.float32)


def _pipe_arrays():
    rng = np.random.default_rng(7)
    return {"w1": (rng.standard_normal((STAGES, L_PER, D, H)) * 0.1
                   ).astype(np.float32),
            "w2": (rng.standard_normal((STAGES, L_PER, H, D)) * 0.1
                   ).astype(np.float32),
            "x": rng.standard_normal((PIPE_B, D)).astype(np.float32)}


def _stage_fn(p, x):
    """One stage: ``L_PER`` residual MLP layers (``check_pipeline.py``'s
    ``stage_fn``, in torch)."""
    import torch
    for i in range(p["w1"].shape[0]):
        x = x + torch.tanh(x @ p["w1"][i]) @ p["w2"][i]
    return x


def _ranks(rank, n):
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel.pipeline import make_pipelined_forward
    from repro_torch.parallel.ring_attention import ring_attention
    from repro_torch.parallel.sharding import (ppermute, sp_gather,
                                               tp_group, tp_rank)
    from repro_torch.parallel.ulysses import ulysses_attention

    dm = cart_create(n, (4, 2), ("model", "data"), device_type="cpu")
    coord = dict(zip(dm.mesh_dim_names, dm.get_coordinate()))
    b, m = coord["data"], coord["model"]
    rows, seq = slice(2 * b, 2 * b + 2), slice(8 * m, 8 * m + 8)

    def shard(a):
        return torch.from_numpy(a[rows, :, seq].copy()).requires_grad_(True)

    out = {"data": b, "model": m, "ulysses": {}, "ring": {}}
    for k, (Hq, Hkv, causal, window, backend, chunks) in enumerate(
            ULYSSES.values()):
        name = list(ULYSSES)[k]
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=Hq, n_kv_heads=Hkv, d_ff=64, vocab=32,
                          window=window, use_ulysses=True,
                          param_dtype="float32", compute_dtype="float32",
                          a2a_backend=backend, a2a_chunks=chunks)
        q, kk, v = (shard(a) for a in _qkv(Hq, Hkv, k))
        o = ulysses_attention(q, kk, v, cfg, causal=causal, mesh=dm)
        g = torch.from_numpy(_cotangent(Hq, k)[rows, :, seq].copy())
        grads = torch.autograd.grad(o, (q, kk, v), g)
        out["ulysses"][name] = (o.detach().numpy(),
                                *(t.numpy() for t in grads))
    # the re-shard alone: this rank's heads over the whole sequence
    comm = torus_comm(dm, ("model",))
    q = shard(_qkv(8, 8, 0)[0]).detach()
    plan = comm.all_to_all((2, 2, 8, HD), torch.float32,
                           backend="factorized")
    out["tiled"] = (comm.rank, plan.tiled(q, 1, 2).numpy(),
                    plan.tiled(plan.tiled(q, 1, 2), 2, 1,
                               reverse=True).numpy())

    for k, (Hq, Hkv, causal, window) in enumerate(RING.values()):
        name = list(RING)[k]
        q, kk, v = (shard(a) for a in _qkv(Hq, Hkv, 50 + k))
        o = ring_attention(q, kk, v, causal=causal, window=window, mesh=dm)
        res = [o.detach().numpy()]
        if name == RING_GRAD:
            g = torch.from_numpy(_cotangent(Hq, 50 + k)[rows, :, seq].copy())
            res += [t.numpy() for t in torch.autograd.grad(o, (q, kk, v), g)]
        out["ring"][name] = res

    # the differentiable exchanges over the model group
    group = tp_group(dm)
    me = tp_rank(group)
    rng = np.random.default_rng(1000 + rank)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32)
                         ).requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(2000 + b).standard_normal(
        (2, 12, 5)).astype(np.float32))
    y = sp_gather(x, group, 1)
    out["sp_gather"] = (me, x.detach().numpy(), y.detach().numpy(),
                        torch.autograd.grad((y * w).sum(), x)[0].numpy())
    out["ppermute"] = []
    for perm in ([(i, (i + 1) % 4) for i in range(4)], [(0, 2), (1, 3)]):
        wr = torch.from_numpy(np.random.default_rng(3000 + rank)
                              .standard_normal((2, 3, 5)).astype(np.float32))
        y = ppermute(x, group, perm)
        out["ppermute"].append((me, wr.numpy(), y.detach().numpy(),
                                torch.autograd.grad((y * wr).sum(),
                                                    x)[0].numpy()))

    # the pipeline over pod (4 stages), each data slice its own copy
    dp = cart_create(n, (2, 4), ("data", "pod"), device_type="cpu")
    stage = dict(zip(dp.mesh_dim_names, dp.get_coordinate()))["pod"]
    arr = _pipe_arrays()
    mine = {k: torch.from_numpy(arr[k][stage].copy()).requires_grad_(True)
            for k in ("w1", "w2")}
    run = make_pipelined_forward(_stage_fn, dp, axis="pod",
                                 n_microbatches=MICRO)
    y = run(mine, torch.from_numpy(arr["x"]))
    grads = torch.autograd.grad((y ** 2).sum(), (mine["w1"], mine["w2"]))
    out["pipeline"] = (stage, y.detach().numpy(),
                       *(g.numpy() for g in grads))
    return out


_JAX_SCRIPT = r"""
import functools
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models.config import ModelConfig
from repro.parallel.pipeline import make_pipelined_forward, pipeline_apply
from repro.parallel.ring_attention import ring_attention
from repro.parallel.ulysses import ulysses_attention

data = np.load(sys.argv[1])
ulysses, ring, ring_grad, micro = eval(sys.argv[2])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
sh = NamedSharding(mesh, P("data", None, "model", None))
out = {}


def attn_and_grads(f, name):
    q, k, v, g = (jax.device_put(jnp.asarray(data[f"{name}|{t}"]), sh)
                  for t in "qkvg")
    o, vjp = jax.vjp(jax.jit(f), q, k, v)
    out[f"{name}|out"] = np.asarray(o)
    for t, d in zip("qkv", vjp(g)):
        out[f"{name}|d{t}"] = np.asarray(d)


for name, (Hq, Hkv, causal, window, backend, chunks) in ulysses.items():
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=Hq, n_kv_heads=Hkv, d_ff=64, vocab=32,
                      window=window, use_ulysses=True,
                      param_dtype="float32", compute_dtype="float32",
                      a2a_backend=backend, a2a_chunks=chunks)
    attn_and_grads(functools.partial(ulysses_attention, cfg=cfg,
                                     causal=causal, mesh=mesh),
                   "u" + name)
for name, (Hq, Hkv, causal, window) in ring.items():
    f = functools.partial(ring_attention, causal=causal, window=window,
                          mesh=mesh)
    if name == ring_grad:
        attn_and_grads(f, "r" + name)
    else:
        q, k, v = (jax.device_put(jnp.asarray(data[f"r{name}|{t}"]), sh)
                   for t in "qkv")
        out[f"r{name}|out"] = np.asarray(jax.jit(f)(q, k, v))

pmesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
params = {"w1": jnp.asarray(data["pipe|w1"]),
          "w2": jnp.asarray(data["pipe|w2"])}
x = jnp.asarray(data["pipe|x"])


def stage_fn(p, x):
    for i in range(p["w1"].shape[0]):
        x = x + jnp.tanh(x @ p["w1"][i]) @ p["w2"][i]
    return x


pg = jax.device_put(params, NamedSharding(pmesh, P("pod")))
out["pipe|out"] = np.asarray(make_pipelined_forward(
    stage_fn, pmesh, axis="pod", n_microbatches=micro)(pg, x))


def loss_pipe(params, x):
    mbs = x.reshape(micro, x.shape[0] // micro, x.shape[1])
    inner = functools.partial(pipeline_apply, stage_fn, axis="pod",
                              n_stages=4)
    y = jax.shard_map(inner, mesh=pmesh, in_specs=(P("pod"), P()),
                      out_specs=P(), check_vma=False)(params, mbs)
    return jnp.sum(y ** 2)


grads = jax.jit(jax.grad(loss_pipe))(pg, x)
out["pipe|dw1"] = np.asarray(grads["w1"])
out["pipe|dw2"] = np.asarray(grads["w2"])
np.savez(sys.argv[3], **out)
"""


def _inputs():
    arrays = {}
    for k, (name, (Hq, Hkv, *_)) in enumerate(ULYSSES.items()):
        q, kk, v = _qkv(Hq, Hkv, k)
        arrays.update({f"u{name}|q": q, f"u{name}|k": kk, f"u{name}|v": v,
                       f"u{name}|g": _cotangent(Hq, k)})
    for k, (name, (Hq, Hkv, *_)) in enumerate(RING.items()):
        q, kk, v = _qkv(Hq, Hkv, 50 + k)
        arrays.update({f"r{name}|q": q, f"r{name}|k": kk, f"r{name}|v": v,
                       f"r{name}|g": _cotangent(Hq, 50 + k)})
    arrays.update({f"pipe|{k}": v for k, v in _pipe_arrays().items()})
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference started first, then the port's world:
    ``(per-rank results, reference results)``."""
    tmp = tmp_path_factory.mktemp("seqpar")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    args = (ULYSSES, RING, RING_GRAD, MICRO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
         repr(args), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        world = run_world(_ranks, 8, tmp / "world", timeout=240)
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        ref = dict(np.load(tmp / "out.npz"))
    finally:
        if proc.poll() is None:
            proc.kill()
    return world, ref


def _assembled(world, what, name, i):
    """The global (B, H, S, hd) tensor from every rank's shard: row block
    ``data``, sequence block ``model``."""
    shards = {(r["data"], r["model"]): r[what][name][i] for r in world}
    return np.concatenate([np.concatenate([shards[b, m] for m in range(4)],
                                          axis=2) for b in range(2)])


@pytest.mark.parametrize("case", list(ULYSSES))
def test_ulysses_attention_matches_jax(runs, case):
    world, ref = runs
    from repro.kernels.ref import ref_attention
    Hq, Hkv, causal, window, *_ = ULYSSES[case]
    got = _assembled(world, "ulysses", case, 0)
    np.testing.assert_allclose(got, ref[f"u{case}|out"], **TOL)
    q, k, v = _qkv(Hq, Hkv, list(ULYSSES).index(case))
    np.testing.assert_allclose(
        got, np.asarray(ref_attention(q, k, v, causal=causal,
                                      window=window)), **TOL)


@pytest.mark.parametrize("case", list(ULYSSES))
def test_ulysses_gradients_match_jax(runs, case):
    world, ref = runs
    for i, t in enumerate("qkv"):
        np.testing.assert_allclose(_assembled(world, "ulysses", case, i + 1),
                                   ref[f"u{case}|d{t}"], **TOL,
                                   err_msg=f"{case} d{t}")


def test_tiled_reshard_is_the_definition(runs):
    """Rank ``m`` of the model torus receives heads ``[2m, 2m + 2)`` of
    every sequence block, in sequence order, and the reverse re-shard
    gives back its input, bit for bit."""
    world, _ = runs
    q = _qkv(8, 8, 0)[0]
    for r in world:
        m, heads, back = r["tiled"]
        b = r["data"]
        assert m == r["model"]
        np.testing.assert_array_equal(heads, q[2 * b:2 * b + 2,
                                               2 * m:2 * m + 2])
        np.testing.assert_array_equal(back, q[2 * b:2 * b + 2, :,
                                              8 * m:8 * m + 8])


@pytest.mark.parametrize("case", list(RING))
def test_ring_attention_matches_jax(runs, case):
    world, ref = runs
    np.testing.assert_allclose(_assembled(world, "ring", case, 0),
                               ref[f"r{case}|out"], **TOL)


def test_ring_attention_gradients_match_jax(runs):
    world, ref = runs
    for i, t in enumerate("qkv"):
        np.testing.assert_allclose(_assembled(world, "ring", RING_GRAD,
                                              i + 1),
                                   ref[f"r{RING_GRAD}|d{t}"], **TOL,
                                   err_msg=f"d{t}")


def test_pipeline_forward_matches_jax(runs):
    world, ref = runs
    arr = _pipe_arrays()
    seq = arr["x"]
    for s in range(STAGES):
        h = seq
        for i in range(L_PER):
            h = h + np.tanh(h @ arr["w1"][s, i]) @ arr["w2"][s, i]
        seq = h
    stages = sorted(r["pipeline"][0] for r in world)
    assert stages == sorted(list(range(STAGES)) * 2)
    for r in world:
        np.testing.assert_allclose(r["pipeline"][1], ref["pipe|out"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["pipeline"][1], seq, rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_gradients_match_jax(runs):
    """Each stage's gradients are its slice of the reference's: no
    factor of the stage count from the final broadcast."""
    world, ref = runs
    for r in world:
        s, _, dw1, dw2 = r["pipeline"]
        np.testing.assert_allclose(dw1, ref["pipe|dw1"][s], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(dw2, ref["pipe|dw2"][s], rtol=1e-4,
                                   atol=1e-4)


def test_sp_gather_and_its_gradient_are_the_definition(runs):
    world, _ = runs
    xs = {(r["data"], r["sp_gather"][0]): r["sp_gather"][1] for r in world}
    for r in world:
        m, _, y, dx = r["sp_gather"]
        b = r["data"]
        np.testing.assert_array_equal(
            y, np.concatenate([xs[b, j] for j in range(4)], axis=1))
        w = np.random.default_rng(2000 + b).standard_normal(
            (2, 12, 5)).astype(np.float32)
        np.testing.assert_array_equal(dx, w[:, 3 * m:3 * m + 3])


@pytest.mark.parametrize("which", [0, 1])
def test_ppermute_and_its_gradient_are_the_definition(runs, which):
    """Rotation (every member sends) and a partial permutation (members
    0, 1 send to 2, 3; 0 and 1 receive zeros)."""
    world, _ = runs
    perm = ([(i, (i + 1) % 4) for i in range(4)], [(0, 2), (1, 3)])[which]
    to = dict(perm)
    frm = {d: s for s, d in perm}
    by = {(r["data"], r["ppermute"][which][0]): (r["sp_gather"][1],
                                                 r["ppermute"][which][1])
          for r in world}
    for r in world:
        m, _, y, dx = r["ppermute"][which]
        b = r["data"]
        want_y = by[b, frm[m]][0] if m in frm else np.zeros_like(y)
        want_dx = by[b, to[m]][1] if m in to else np.zeros_like(dx)
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(dx, want_dx)
