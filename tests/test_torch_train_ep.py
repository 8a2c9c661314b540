"""Expert- and data-parallel training of the port on a 4-rank gloo world
(a ``(pod=2, data=2, model=1)`` mesh) against the JAX reference on the
same mesh of 4 forced host devices, and against the port itself on one
device.

Both packages run a 2-layer MoE model (d 32, 4/2 heads, d_ff 64, vocab
100, top-2, f32, remat) on the same weights, drawn once with numpy from
a seed and carried to each (``params_from_jax`` with the mesh: each rank
keeps its experts' slice and its FSDP block of the embedding and
attention, ``d_model`` split over ``(pod, data)``), and one numpy batch
of 8 x 16 tokens, each rank its row block ``pod * 2 + data``.  Cases: 4
experts under the factorized plan, 2 (replicas) under the overlap
engine, 8 with dropless dispatch (the ragged Alltoallv).

* The gradients: ``reduce_grads`` of each rank's gradient of its loss,
  gathered over the EP group, against ``jax.value_and_grad`` of the
  reference's ``make_loss_fn(model, mesh, rules)``, per leaf within rtol
  = atol = 2e-4; ``grad_norm`` (the sharded global norm) and the metrics
  against the reference step's.  AdamW's update does not see a leaf's
  gradient scale (``m / sqrt(v)``), so a missed ``1 / n`` or ``R`` shows
  here and in the clipped norm, not in the parameters.
* The parameters after 2 AdamW steps (clipping active: the norm is about
  19) against the reference's ``make_train_step``, within 2e-4.
* The port against itself: the reduced gradients against the port's
  ``mesh=None`` gradients of the global batch, within 2e-4; and the
  4-expert case's FSDP run against the same case with ``embed_fsdp=()``
  (every leaf but the experts whole): reduced gradients, norm, metrics
  and parameters after 2 steps within 2e-4.
* The FSDP layout: every rank holds block ``pod * 2 + data`` of each
  FSDP leaf's ``d_model`` dim, its AdamW moments the same shape, and no
  expert leaf is split by FSDP.
* ``opt_state_from_jax`` with the mesh keeps each rank's shard of the
  reference's global moments.
* ``compressed_psum`` over the world against the reference's int8
  quantisation of each rank's gradient, and against the exact sum within
  the reference's bound (``check_compression.py``: n * max|g| / 127).
* The checkpoint on the mesh: the files hold global arrays; restored with
  the mesh and without it, both bit for bit.  Its gather
  (``gather_tree_to_writer``) leaves the global tree on the writer
  rank's host and nothing on the other ranks, replicas included.
* The mesh factories: ``make_mesh`` gives each rank ``cart_create``'s
  coordinate; the production and debug factories ask for the reference's
  shapes, which ``check_trainable`` accepts (tensor parallelism over
  their ``model`` dim, and Ulysses over it where the query heads divide
  it).
* ``Trainer`` on the mesh: 3 steps with a checkpoint at step 2, restored
  into a fresh ``Trainer`` (bit for bit the live state at step 2), whose
  step 3 is then bit for bit the live one's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_dist import fsdp_layout, run_world

CASES = {"E4-factorized": (4, "factorized", 8.0),
         "E2-overlap": (2, "overlap", 8.0),
         "E8-dropless": (8, "factorized", None)}
WHOLE = "E4-factorized"                # also run with embed_fsdp=()
GB, SEQ, LR, STEPS = 8, 16, 1e-3, 2
MESH = ((1, 2, 2), ("model", "data", "pod"))      # fastest digit first
GRAD = (4, 4096)                                   # compressed_psum's leaf


def _cfg(module, E, backend, cf):
    return module.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=E, top_k=2,
        capacity_factor=cf, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend, remat=True)


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 99, (GB, SEQ)).astype(np.int32),
            "labels": rng.integers(0, 99, (GB, SEQ)).astype(np.int32),
            "mask": (rng.uniform(size=(GB, SEQ)) < 0.8).astype(np.float32)}


def _grads(rank):
    return np.random.default_rng(50 + rank).standard_normal(GRAD) \
        .astype(np.float32) * 0.01


def _flat(tree):
    from repro_torch.models.common import tree_leaves
    return {p: t.detach().numpy().copy() for p, t in tree_leaves(tree)}


def _case(rank, mesh, torch, name, jparams, batch, rules=None):
    """One case on this rank: the gathered reduced gradients, the norm and
    metrics, the FSDP layout, the parameters after 2 steps, and (rank 0,
    default rules) the port's own mesh=None gradients of the global
    batch."""
    from repro_torch.models import build_model, config, make_loss_fn, \
        make_train_step, reduce_grads
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map, tree_with_leaves)
    from repro_torch.models.convert import (opt_state_from_jax,
                                            params_from_jax)
    from repro_torch.optim import AdamW, AdamWConfig, global_norm
    from repro_torch.parallel.sharding import batch_group, batch_split

    E, backend, cf = CASES[name]
    cfg = _cfg(config, E, backend, cf)
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh, rules)
    n, i = batch_split(mesh, rules)
    rows = GB // n
    local = {k: torch.from_numpy(v[i * rows:(i + 1) * rows])
             for k, v in batch.items()}
    params = params_from_jax(jparams, cfg, "cpu", mesh=mesh, rules=rules)
    tree_map(lambda t: t.requires_grad_(True), params)
    leaves = tree_leaves(params)
    total, metrics = make_loss_fn(model, mesh, rules)(params, local)
    got = torch.autograd.grad(total, [t for _, t in leaves])
    grads = reduce_grads(tree_with_leaves(
        params, {p: g for (p, _), g in zip(leaves, got)}), sh,
        batch_group(mesh, rules))
    out = {"grads": _flat(sh.gather_tree(grads)),
           "grad_norm": float(global_norm(grads, sh))}
    step = make_train_step(model, AdamW(AdamWConfig(lr=LR)), mesh, rules)
    opt_state = AdamW(AdamWConfig(lr=LR)).init(params)
    out["fsdp"] = fsdp_layout(mesh, sh, params, opt_state, jparams)
    out["steps"] = []
    for _ in range(STEPS):
        params, opt_state, m = step(params, opt_state, local)
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["params"] = _flat(sh.gather_tree(params))
    if rules is not None:
        return out
    # the checkpoint's gather: the global tree on the writer's host alone
    to_writer = sh.gather_tree_to_writer(params)
    out["to_writer"] = to_writer if to_writer is None else {
        p: (str(t.device), t.numpy()) for p, t in tree_leaves(to_writer)}
    out["writer"] = sh.writer
    # the mesh form of opt_state_from_jax: the reference's global moments
    # (here its initial parameters) -> this rank's shard
    state = opt_state_from_jax({"mu": jparams, "nu": jparams,
                                "step": np.int32(0)}, cfg, "cpu", mesh=mesh)
    want = params_from_jax(jparams, cfg, "cpu", mesh=mesh)
    out["opt_state_mesh"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves(want), tree_leaves(state["mu"])))
    if rank == 0:
        whole = params_from_jax(jparams, cfg, "cpu")
        tree_map(lambda t: t.requires_grad_(True), whole)
        lv = tree_leaves(whole)
        total1, _ = build_model(cfg).loss(
            whole, {k: torch.from_numpy(v) for k, v in batch.items()})
        g1 = torch.autograd.grad(total1, [t for _, t in lv])
        out["one_device"] = {p: g.numpy() for (p, _), g in zip(lv, g1)}
    return out


def _compression(rank, torch):
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.optim import compressed_psum
    mesh = cart_create(4, (4,), ("dp",), device_type="cpu")
    comm = torus_comm(mesh, ("dp",))
    g = torch.from_numpy(_grads(rank))
    small = torch.full((3,), float(rank + 1))
    out = compressed_psum({"g": g, "small": small}, comm)
    return out["g"].numpy(), out["small"].numpy()


def _checkpoint(rank, mesh, torch, tmp):
    """Save on the mesh, restore with and without it; the Trainer's
    round trip."""
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.data import CopyTaskConfig, SyntheticLM
    from repro_torch.launch.train import build_training
    from repro_torch.models import config
    from repro_torch.models.common import param_shardings, tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(config, 8, "factorized", 8.0)
    model, _, params, opt_state, step_fn = build_training(
        cfg, mesh, lr=LR, warmup=1, total=10, seed=3, device="cpu")
    ok = {}
    tr = Trainer(TrainerConfig(total_steps=3, checkpoint_dir=str(tmp / "tr"),
                               checkpoint_every=2, log_every=1),
                 step_fn,
                 SyntheticLM(CopyTaskConfig(vocab=cfg.vocab, seq_len=SEQ,
                                            global_batch=GB), mesh=mesh,
                             task="copy", device="cpu"),
                 params, opt_state,
                 sharding=param_shardings(model.specs(), mesh))
    state_sh = tr._state_sharding()
    # a synchronous save of the live state, restored both ways
    live = tr._state_tree()
    path = save_checkpoint(tmp / "ck", 0, live, sharding=state_sh)
    back, _, _ = restore_checkpoint(tmp / "ck", 0, live, sharding=state_sh)
    ok["restore_mesh"] = all(torch.equal(a, b) for (_, a), (_, b) in
                             zip(tree_leaves(live), tree_leaves(back)))
    glob = state_sh.gather_tree(live)
    back, _, _ = restore_checkpoint(tmp / "ck", 0, glob)
    ok["restore_no_mesh"] = all(torch.equal(a, b) for (_, a), (_, b) in
                                zip(tree_leaves(glob), tree_leaves(back)))
    import json
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    ok["global_arrays"] = all(
        manifest["leaves"][p]["shape"] == list(t.shape)
        for p, t in tree_leaves(glob))
    ok["experts_sliced"] = any(
        tuple(a.shape) != tuple(b.shape)
        for (_, a), (_, b) in zip(tree_leaves(live), tree_leaves(glob)))
    ok["fsdp_sliced"] = all(
        (p in state_sh.fsdp_axes) == (p.endswith(("embed", "wq", "wk", "wv",
                                                  "wo")))
        for p, _ in tree_leaves(live) if not p.endswith("step"))

    # Trainer: 2 steps (async checkpoint at 2), restore into a fresh one
    tr.run(max_steps=2)
    fresh = Trainer(tr.config, step_fn,
                    SyntheticLM(CopyTaskConfig(vocab=cfg.vocab, seq_len=SEQ,
                                               global_batch=GB), mesh=mesh,
                                task="copy", device="cpu"),
                    tr.params, tr.opt_state, sharding=tr.sharding)
    ok["restored"] = fresh.try_restore() and fresh.step == tr.step == 2 \
        and fresh.data.step == tr.data.step
    same = lambda: all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(tr._state_tree()), tree_leaves(fresh._state_tree())))
    ok["state_at_2"] = same()
    tr.run()
    fresh.run()
    ok["state_at_3"] = fresh.step == tr.step == 3 and same()
    ok["metrics"] = [r["total_loss"] for r in tr.metrics_log][-1] \
        == [r["total_loss"] for r in fresh.metrics_log][-1]
    return ok


def _ranks(rank, n, jparams, batch, tmp):
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.data import CopyTaskConfig, SyntheticLM
    from repro_torch.parallel.sharding import batch_split
    from repro_torch.parallel.sharding import ShardingRules
    mesh = cart_create(n, *MESH, device_type="cpu")
    out = {"cases": {name: _case(rank, mesh, torch, name, jparams[name],
                                 batch) for name in CASES},
           "whole": _case(rank, mesh, torch, WHOLE, jparams[WHOLE], batch,
                          ShardingRules().override(embed_fsdp=()))}
    out["compressed"] = _compression(rank, torch)
    out["checkpoint"] = _checkpoint(rank, mesh, torch, Path(tmp))
    from repro_torch.core.cache import mesh_shape
    from repro_torch.launch.mesh import make_mesh
    built = make_mesh({"pod": 2, "data": 2, "model": 1}, device_type="cpu")
    out["make_mesh"] = [
        (mesh_shape(m), dict(zip(m.mesh_dim_names, m.get_coordinate())))
        for m in (built, mesh)]
    dcfg = CopyTaskConfig(vocab=100, seq_len=SEQ, global_batch=GB)
    out["data"] = (batch_split(mesh), {
        k: v.numpy() for k, v in SyntheticLM(dcfg, mesh=mesh, task="copy",
                                             device="cpu").next().items()})
    return out


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.cache import cart_create
from repro.models import build_model, config, make_loss_fn, make_train_step
from repro.models.common import param_shardings
from repro.optim import AdamW, AdamWConfig
from repro.parallel.sharding import ShardingRules

data = np.load(sys.argv[1])
cases, lr, steps = eval(sys.argv[2])


def unflat(name):
    tree = {}
    for key in data.files:
        if key.startswith(name + "|"):
            node = tree
            *parts, leaf = key.split("|", 1)[1].split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(data[key])
    return tree


mesh = cart_create(4, (1, 2, 2), ("model", "data", "pod"))
rules = ShardingRules()
batch = {k: jax.device_put(jnp.asarray(data[k]),
                           NamedSharding(mesh, P(("pod", "data"))))
         for k in ("tokens", "labels", "mask")}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


out = {}
for name, (E, backend, cf) in cases.items():
    cfg = config.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=E, top_k=2,
        capacity_factor=cf, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend, remat=True)
    model = build_model(cfg)
    params = jax.device_put(unflat(name), param_shardings(model.specs(),
                                                          mesh, rules))
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(model, mesh, rules), has_aux=True))(params, batch)
    for k, v in flat(grads).items():
        out[f"{name}|grad|{k}"] = v
    opt = AdamW(AdamWConfig(lr=lr))
    state = jax.jit(opt.init)(params)
    step = jax.jit(make_train_step(model, opt, mesh, rules))
    for s in range(steps):
        params, state, m = step(params, state, batch)
        for k, v in m.items():
            out[f"{name}|step{s}|{k}"] = np.asarray(v)
    for k, v in flat(params).items():
        out[f"{name}|params|{k}"] = v
np.savez(sys.argv[3], **out)
"""


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


def _init():
    """Each case's initial parameters (numpy leaves, the reference's tree
    layout); both packages start from them."""
    from repro_torch.models import build_model, config
    return {name: _numpy_init(build_model(_cfg(config, E, backend, cf))
                              .specs(), E)
            for name, (E, backend, cf) in CASES.items()}


def _jax_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_jax_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference in a subprocess, started first, and the port's
    world meanwhile: ``(world, reference)``."""
    tmp = tmp_path_factory.mktemp("train_ep")
    init = _init()
    arrays = dict(_batch())
    for name in CASES:
        arrays.update({f"{name}|{p}": v
                       for p, v in _jax_flat(init[name]).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
         repr((CASES, LR, STEPS)), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        world = run_world(_ranks, 4, tmp, init, _batch(), str(tmp),
                          timeout=180)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    ref = {}
    for key, v in np.load(tmp / "out.npz").items():
        case, what, path = key.split("|")
        ref.setdefault(case, {}).setdefault(what, {})[path] = v
    return world, ref


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[1]


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_grads_match_jax(world, jax_run, case):
    want = jax_run[case]["grad"]
    for rank, r in enumerate(world):
        got = r["cases"][case]["grads"]
        assert set(got) == set(want)
        for path, w in want.items():
            assert float(np.abs(w).max()) > 0, path
            np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{case} {path} rank {rank}")


@pytest.mark.parametrize("case", list(CASES))
def test_grad_norm_and_metrics_match_jax(world, jax_run, case):
    ref = jax_run[case]
    for r in world:
        out = r["cases"][case]
        np.testing.assert_allclose(out["grad_norm"],
                                   float(ref["step0"]["grad_norm"]),
                                   rtol=2e-4, atol=2e-4)
        for s, m in enumerate(out["steps"]):
            for k, v in m.items():
                np.testing.assert_allclose(v, float(ref[f"step{s}"][k]),
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"{case} step {s} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_params_after_two_steps_match_jax(world, jax_run, case):
    want = jax_run[case]["params"]
    for rank, r in enumerate(world):
        got = r["cases"][case]["params"]
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{case} {path} rank {rank}")


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_gather_reaches_the_writer_alone(world, case):
    want = world[0]["cases"][case]["params"]
    writers = [r["cases"][case]["writer"] for r in world]
    assert writers == [True, False, False, False]
    for r in world:
        got = r["cases"][case]["to_writer"]
        if not r["cases"][case]["writer"]:
            assert got is None
            continue
        assert set(got) == set(want)
        for path, (device, value) in got.items():
            assert device == "cpu", path
            np.testing.assert_array_equal(value, want[path], err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_converted_opt_state_is_the_shard(world, case):
    assert all(r["cases"][case]["opt_state_mesh"] for r in world)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_grads_match_the_one_device_port(world, case):
    want = world[0]["cases"][case]["one_device"]
    got = world[0]["cases"][case]["grads"]
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{case} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_layout(world, case):
    """Every rank holds block ``pod * 2 + data`` of each FSDP leaf's
    ``d_model`` dim, split over ``(pod, data)``, with AdamW moments of
    its shape: the embedding and attention leaves (the resolver's
    ``embed_fsdp`` leaves), no expert leaf, the norms and the router
    whole."""
    want = {"embed": 1}
    for w in ("wq", "wk", "wv"):
        want[f"blocks/pos0/mixer/{w}"] = 1
    want["blocks/pos0/mixer/wo"] = 3
    for r in world:
        got = r["cases"][case]["fsdp"]
        assert got["axes"] == want and got["kept"] == ("pod", "data")
        assert got["experts"] == [f"blocks/pos0/ffn/{w}"
                                  for w in ("w1", "w2", "w3")]
        assert set(got["blocks"]) == set(want)
        assert all(got["blocks"].values()), got["blocks"]


def test_fsdp_matches_the_whole_leaf_run(world):
    """The 4-expert case with FSDP against itself with ``embed_fsdp=()``:
    reduced gradients (gathered), ``grad_norm``, metrics and the
    parameters after 2 steps within 2e-4, on every rank."""
    for rank, r in enumerate(world):
        fsdp, whole = r["cases"][WHOLE], r["whole"]
        assert whole["fsdp"]["axes"] == {} and fsdp["fsdp"]["axes"]
        np.testing.assert_allclose(fsdp["grad_norm"], whole["grad_norm"],
                                   rtol=2e-4, atol=2e-4)
        for what in ("grads", "params"):
            assert set(fsdp[what]) == set(whole[what])
            for path, w in whole[what].items():
                np.testing.assert_allclose(
                    fsdp[what][path], w, rtol=2e-4, atol=2e-4,
                    err_msg=f"{what} {path} rank {rank}")
        for s, m in enumerate(fsdp["steps"]):
            for k, v in m.items():
                np.testing.assert_allclose(v, whole["steps"][s][k],
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"step {s} {k}")


def test_compressed_psum_matches_the_reference_quantisation(world):
    import jax.numpy as jnp
    from repro.optim.transforms import _dequantize_int8, _quantize_int8
    import torch
    from repro_torch.optim import transforms
    terms = []
    for rank in range(4):
        g = _grads(rank)
        q, s, shape = _quantize_int8(jnp.asarray(g))
        tq, ts, _ = transforms._quantize_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        terms.append(np.asarray(_dequantize_int8(q, s, shape)))
    want = np.sum(terms, axis=0)
    exact = np.sum([_grads(rank) for rank in range(4)], axis=0)
    bound = 4 * max(np.abs(_grads(r)).max() for r in range(4)) / 127.0
    outs = [r["compressed"] for r in world]
    for got, small in outs:
        np.testing.assert_array_equal(got, outs[0][0])   # same bits
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        assert np.abs(got - exact).max() <= bound + 1e-7
        np.testing.assert_array_equal(small, np.full(3, 10.0, np.float32))


def test_tie_expert_replica_grads_matches_the_reference():
    import jax.numpy as jnp
    import torch
    from repro.optim.transforms import tie_expert_replica_grads as jtie
    from repro_torch.optim import tie_expert_replica_grads
    rng = np.random.default_rng(3)
    tree = {"ffn": {"w1": rng.standard_normal((4, 3, 2)).astype(np.float32),
                    "router": rng.standard_normal((4, 3)).astype(np.float32)}}
    want = jtie({"ffn": {k: jnp.asarray(v) for k, v in tree["ffn"].items()}},
                2)
    got = tie_expert_replica_grads(
        {"ffn": {k: torch.from_numpy(v) for k, v in tree["ffn"].items()}}, 2)
    for k in ("w1", "router"):
        np.testing.assert_allclose(got["ffn"][k].numpy(),
                                   np.asarray(want["ffn"][k]), rtol=1e-7)


def test_checkpoint_and_trainer_on_the_mesh(world):
    for rank, r in enumerate(world):
        bad = [k for k, v in r["checkpoint"].items() if not v]
        assert not bad, (rank, bad)


def test_synthetic_lm_yields_the_row_block(world):
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    whole = make_copy_task_batch(CopyTaskConfig(vocab=100, seq_len=SEQ,
                                                global_batch=GB), 0)
    blocks = set()
    for r in world:
        (n, i), got = r["data"]
        blocks.add(i)
        rows = GB // n
        for k, v in got.items():
            np.testing.assert_array_equal(v, whole[k][i * rows:
                                                      (i + 1) * rows].numpy())
    assert blocks == {0, 1, 2, 3}


def test_make_mesh_builds_the_reference_layout(world):
    """``make_mesh`` over (pod, data, model) gives each rank the
    coordinate ``cart_create`` gives it on the same dims, fastest first."""
    coords = []
    for r in world:
        (shape, coord), (want_shape, want_coord) = r["make_mesh"]
        assert shape == want_shape == {"pod": 2, "data": 2, "model": 1}
        assert coord == want_coord
        coords.append(tuple(sorted(coord.items())))
    assert len(set(coords)) == 4


@pytest.mark.parametrize("factory,multi_pod,n,dims,names", [
    ("make_production_mesh", False, 256, (16, 16), ("model", "data")),
    ("make_production_mesh", True, 512, (16, 16, 2),
     ("model", "data", "pod")),
    ("make_debug_mesh", False, 8, (4, 2), ("model", "data")),
    ("make_debug_mesh", True, 16, (4, 2, 2), ("model", "data", "pod"))])
def test_mesh_factories_build_the_reference_shapes(monkeypatch, factory,
                                                   multi_pod, n, dims, names):
    """Each factory asks ``cart_create`` for the reference's mesh (most
    significant dim first there, fastest first here), and the port
    trains on it (tensor parallelism over its ``model`` dim), and with
    Ulysses sequence parallelism over ``model`` where the query heads
    divide it."""
    from repro_torch.launch import mesh as mesh_mod
    calls = []
    monkeypatch.setattr(mesh_mod, "cart_create",
                        lambda *a, **kw: calls.append((a, kw)) or "mesh")
    assert getattr(mesh_mod, factory)(multi_pod=multi_pod,
                                      device_type="cpu") == "mesh"
    assert calls == [((n, dims, names), {"device_type": "cpu"})]
    shape = dict(zip(reversed(names), reversed(dims)))
    assert shape == (mesh_mod.production_shape if "production" in factory
                     else mesh_mod.debug_shape)(multi_pod=multi_pod)
    from repro_torch.configs import get_config
    cfg = get_config("phi3.5-moe-42b", smoke=True)
    mesh_mod.check_trainable(shape)
    mesh_mod.check_trainable(shape, cfg)
    # phi3.5-moe's 32 query heads divide every factory's model dim; the
    # smoke config's 4 divide the debug meshes' 4, not production's 16
    mesh_mod.check_trainable(shape, get_config("phi3.5-moe-42b").replace(
        use_ulysses=True))
    if shape["model"] == 4:
        mesh_mod.check_trainable(shape, cfg.replace(use_ulysses=True))
    else:
        with pytest.raises(ValueError, match="Ulysses"):
            mesh_mod.check_trainable(shape, cfg.replace(use_ulysses=True))


def test_meshes_with_a_model_dim_are_refused(monkeypatch):
    """The debug meshes (``model`` = 4) are trainable, Ulysses over
    ``model`` included.  The launcher started without a world of the
    mesh's size refuses and names the ranks it needs
    (``tests/test_torch_tp.py`` trains it under 8 ranks, with and
    without Ulysses)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import check_trainable, debug_shape
    cfg = get_config("phi3.5-moe-42b", smoke=True)
    for multi in (False, True):
        check_trainable(debug_shape(multi_pod=multi), cfg)
        check_trainable(debug_shape(multi_pod=multi),
                        cfg.replace(use_ulysses=True))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for mesh, n in (("debug", 8), ("debug_multi", 16)):
        with pytest.raises(SystemExit, match=f"needs {n} ranks"):
            train.main(["--arch", "phi3.5-moe-42b", "--smoke", "--mesh",
                        mesh, "--device", "cpu"])
    check_trainable({"pod": 2, "data": 2, "model": 1}, cfg)
