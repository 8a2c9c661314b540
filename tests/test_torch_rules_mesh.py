"""The sharding rules the port once refused, on one 8-rank gloo world of
``(pod=2, data=2, model=2)``, against the JAX reference on 8 forced host
devices (one subprocess) and against the port itself on one device; and
the elastic trainer's recovery onto a survivor mesh that keeps ``model``.

Both packages run test_torch_tp.py's 2-layer model (d 32, d_ff 64,
vocab 128, heads 4/2, f32, remat; the MoE with 4 experts, top-2,
capacity factor 8, the factorized plan) at its numpy fan-in init, on
the same 8 x 16 batch.  The cases:

* ``moe-batch`` / ``dense-batch``: ``batch=("data",)``.  The ``pod``
  ranks of a ``data`` coordinate hold the same rows, while the EP group
  (``data``, ``pod``) and the FSDP split (``pod``, ``data``) still span
  ``pod``: the gradients that arrive summed over those groups hold two
  copies of each row block (``ExpertSharding.repeats``).
* ``dense-fsdp`` / ``moe-fsdp``: ``embed_fsdp=("model",)``.  ``wq`` /
  ``wk`` / ``wv`` and the dense ``w1`` / ``w3`` are FSDP over ``model``
  (gathered whole) while ``wo`` keeps its heads and ``w2`` its hidden
  dim split over ``model``: each ``model`` rank uses its heads' or
  columns' part of the gathered leaves, and the reduce-scatter sums the
  parts.  The MoE's expert weights still split F over ``model``, as the
  reference's ``moe_block`` re-constrains them.
* ``dense-vocab``: ``vocab=("data",)``: the embedding is FSDP over
  ``pod`` alone (its own communicator), every other FSDP leaf over
  ``pod, data``.

Checked within rtol = atol = 2e-4 (test_torch_tp.py's checks): the loss,
every reduced gradient gathered to the global tree, ``grad_norm`` and
the parameters after 2 AdamW steps against the reference's
``jax.value_and_grad`` / ``make_train_step`` on the mesh under the same
rules, and the gradients against the port's ``mesh=None`` run; one
case per rule served (prefill and 4 decode ticks, full vocab) against
the reference and the port without a mesh.  Bit for bit: the ``model``
ranks of a ``(pod, data)`` coordinate end with the same reduced
gradients and parameters of every leaf none of them splits.  Each FSDP
leaf's shard is the block of its own kept axes, row-major, its AdamW
moments the same shape.

Beside them, jamba's SMOKE config under ``embed_fsdp=("model",)``
(mamba's ``in_proj`` gathered whole, each rank using the channel pairs
of its ``out_proj`` split) against the port's one-device gradients.

Last in the world, the elastic trainer (test_torch_elastic.py's model,
weights, batches and fault schedule): ranks 5 and 6 are lost at step 5
of 6 (checkpoint every 3).  Their partners 4 and 7, whose ``(pod,
data)`` coordinates lost a rank, leave too (``run`` returns "lost");
ranks 0-3 recover onto ``(data 2, model 2)`` with EP over ``data``
(``launch.mesh.survivor_mesh``), bit for bit the port's direct restore
of the step-3 checkpoint onto that mesh plus the same steps, and within
2e-4 of the reference's ``Trainer(elastic=True)`` on one device.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_elastic import _cfg as _elastic_cfg
from test_torch_elastic import _dcfg, _fixed_timer, _reference_run
from test_torch_tp import _jax_flat, _numpy_init, _recording_topk
from torch_dist import fsdp_layout, run_world

MESH = ((2, 2, 2), ("model", "data", "pod"))            # fastest first
BASE = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, n_experts=4, top_k=2,
            capacity_factor=8.0, param_dtype="float32",
            compute_dtype="float32", a2a_backend="factorized", remat=True)
DENSE = dict(family="dense", n_experts=0)
# case -> (config changes, rule overrides)
CASES = {"moe-batch": ({}, {"batch": ("data",)}),
         "dense-batch": (DENSE, {"batch": ("data",)}),
         "dense-fsdp": (DENSE, {"embed_fsdp": ("model",)}),
         "moe-fsdp": ({}, {"embed_fsdp": ("model",)}),
         "dense-vocab": (DENSE, {"vocab": ("data",)})}
SERVED = ("moe-batch", "dense-fsdp", "dense-vocab")    # one per rule
GB, SEQ, LR, STEPS = 8, 16, 1e-3, 2
PROMPT, TICKS = 8, 4
TOL = dict(rtol=2e-4, atol=2e-4)
LOST, PARTNERS = (5, 6), (4, 7)


def _fields(name):
    return {**BASE, **CASES[name][0]}


def _rules(name):
    from repro_torch.parallel.sharding import ShardingRules
    return ShardingRules().override(**CASES[name][1])


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 127, (GB, SEQ)).astype(np.int32),
            "labels": rng.integers(0, 127, (GB, SEQ)).astype(np.int32),
            "mask": (rng.uniform(size=(GB, SEQ)) < 0.8).astype(np.float32)}


def _serve_tokens():
    return np.random.default_rng(1).integers(
        0, 127, (GB, PROMPT + TICKS)).astype(np.int32)


def _np(tree):
    from repro_torch.models.common import tree_leaves
    return {p: t.detach().numpy().copy() for p, t in tree_leaves(tree)}


def _coord(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _case(rank, mesh, torch, name, jparams, batch):
    """One training case on this rank: the gathered reduced gradients,
    norm, metrics and parameters after 2 steps, the leaves no ``model``
    rank splits (bit-equal over ``model``), the FSDP layout, and (rank 0)
    the port's mesh=None gradients of the global batch."""
    from repro_torch.models import (build_model, config, make_loss_fn,
                                    make_train_step, reduce_grads)
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map, tree_with_leaves)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW, AdamWConfig, global_norm
    from repro_torch.parallel.sharding import batch_group, batch_split

    cfg = config.ModelConfig(**_fields(name))
    rules = _rules(name)
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh, rules)
    n, i = batch_split(mesh, rules)
    rows = GB // n
    local = {k: torch.from_numpy(v[i * rows:(i + 1) * rows])
             for k, v in batch.items()}
    params = params_from_jax(jparams, cfg, "cpu", mesh=mesh, rules=rules)
    tree_map(lambda t: t.requires_grad_(True), params)
    leaves = tree_leaves(params)
    routed = []
    real = _recording_topk(torch, routed)
    try:
        total, _ = make_loss_fn(model, mesh, rules)(params, local)
    finally:
        torch.topk = real
    got = torch.autograd.grad(total, [t for _, t in leaves])
    grads = reduce_grads(tree_with_leaves(
        params, {p: g for (p, _), g in zip(leaves, got)}), sh,
        batch_group(mesh, rules))
    same = [p for p, _ in leaves if p not in sh.model_axes
            and "model" not in sh.fsdp_kept.get(p, ())]
    out = {"block": i, "coord": (_coord(mesh)["pod"], _coord(mesh)["data"]),
           "loss": float(total.detach()), "routed": routed,
           "repeats": {p: sh.repeats(p) for p, _ in leaves},
           "whole_use": sorted(sh.fsdp_whole),
           "grads": _np(sh.gather_tree(grads)),
           "same_grads": {p: g.numpy() for p, g in tree_leaves(grads)
                          if p in same},
           "grad_norm": float(global_norm(grads, sh))}
    opt = AdamW(AdamWConfig(lr=LR))
    step = make_train_step(model, opt, mesh, rules)
    opt_state = opt.init(params)
    out["fsdp"] = fsdp_layout(mesh, sh, params, opt_state, jparams)
    out["steps"] = []
    for _ in range(STEPS):
        params, opt_state, m = step(params, opt_state, local)
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["params"] = _np(sh.gather_tree(params))
    out["same_params"] = {p: t.detach().numpy() for p, t
                          in tree_leaves(params) if p in same}
    if rank == 0:
        one = params_from_jax(jparams, cfg, "cpu")
        tree_map(lambda t: t.requires_grad_(True), one)
        lv = tree_leaves(one)
        total1, _ = model.loss(one, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        g1 = torch.autograd.grad(total1, [t for _, t in lv])
        out["one_device"] = {p: g.numpy() for (p, _), g in zip(lv, g1)}
    return out


def _serve(rank, mesh, torch, name, jparams, tokens):
    """Prefill and decode on the mesh (this rank's row block under the
    case's rules), and on rank 0 the same without a mesh on every row."""
    from repro_torch.models import (build_model, config, make_prefill_fn,
                                    make_serve_step)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.sharding import batch_split

    cfg = config.ModelConfig(**_fields(name))
    model = build_model(cfg)

    def run(params, toks, mesh, rules):
        pre = make_prefill_fn(model, mesh, rules)(params, toks[:, :PROMPT])
        caches = model.init_caches(toks.shape[0], PROMPT + TICKS, "cpu",
                                   mesh=mesh, rules=rules)
        serve = make_serve_step(model, mesh, rules)
        ticks = []
        for t in range(PROMPT + TICKS):
            _, logits, caches = serve(params, caches, toks[:, t:t + 1])
            if t >= PROMPT - 1:
                ticks.append(logits[:, 0].numpy())
        return pre.numpy(), np.stack(ticks, 1)

    rules = _rules(name)
    n, i = batch_split(mesh, rules)
    rows = GB // n
    toks = torch.from_numpy(tokens)
    out = {"block": i, "mesh": run(
        params_from_jax(jparams, cfg, "cpu", mesh=mesh, rules=rules),
        toks[i * rows:(i + 1) * rows], mesh, rules)}
    if rank == 0:
        out["one"] = run(params_from_jax(jparams, cfg, "cpu"), toks, None,
                         None)
    return out


def _elastic(rank, mesh, jparams, tmp):
    """The device loss of ``LOST`` at step 5 of 6 on this world: the
    survivors' result and the direct-restore check."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import survivor_mesh
    from repro_torch.models import build_model, config, make_train_step
    from repro_torch.models.common import param_shardings, tree_map
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime import trainer as trainer_mod
    trainer_mod.StepTimer = _fixed_timer([])
    cfg = _elastic_cfg(config)
    model = build_model(cfg)
    opt = AdamW(AdamWConfig(lr=LR))
    params = params_from_jax(jparams, cfg, "cpu", mesh=mesh)
    tree_map(lambda t: t.requires_grad_(True), params)
    inj = FaultInjector((FaultSpec("device_loss", at_call=5,
                                   devices=LOST),))
    built = {}

    def rebuild_fn(trainer, err):
        mesh_b = survivor_mesh(mesh, err.devices, cfg.n_experts)
        trainer.train_step = make_train_step(model, opt, mesh_b)
        trainer.data = SyntheticLM(_dcfg(), mesh=mesh_b, task="copy",
                                   device="cpu")
        built.update(mesh=mesh_b, step=trainer.train_step)
        return param_shardings(model.specs(), mesh_b)

    tr = Trainer(
        TrainerConfig(total_steps=6, checkpoint_dir=str(tmp),
                      checkpoint_every=3, log_every=1,
                      async_checkpoint=False, elastic=True),
        inj.wrap(make_train_step(model, opt, mesh), "train_step"),
        SyntheticLM(_dcfg(), mesh=mesh, task="copy", device="cpu"),
        params, opt.init(params),
        sharding=param_shardings(model.specs(), mesh),
        rebuild_fn=rebuild_fn)
    status = tr.run()
    if status == "lost":
        return {"status": status, "step": tr.step}
    mesh_b = built["mesh"]
    mgr = CheckpointManager(tmp, sharding=tr._state_sharding())
    tree, extra, _ = mgr.restore(tr._state_tree(), step=3)
    params, opt_state = tree["params"], tree["opt_state"]
    tree_map(lambda t: t.requires_grad_(True), params)
    data = SyntheticLM(_dcfg(), mesh=mesh_b, task="copy", device="cpu")
    data.load_state_dict(extra["data"])
    for _ in range(3):
        params, opt_state, _ = built["step"](params, opt_state, data.next())
    live = _np(tr._state_tree())
    direct = _np({"params": params, "opt_state": opt_state})
    out = {"status": status, "step": tr.step, "fired": inj.fired,
           "recoveries": tr.recoveries_done,
           "events": [e[0] for e in tr.watchdog.events],
           "logged": [r["step"] for r in tr.metrics_log],
           "mesh": [int(r) for r in mesh_b.mesh.flatten().tolist()],
           "dims": dict(zip(mesh_b.mesh_dim_names, mesh_b.mesh.shape)),
           "direct_equal": set(live) == set(direct) and all(
               np.array_equal(live[p], direct[p]) for p in live)}
    glob = _np(tr.sharding.gather_tree(tr.params))
    if rank == 0:
        out["params"] = glob
    return out


def _pipeline(mesh):
    """The copy task's first batch under ``batch=("data",)`` on this rank,
    and the global batch's rows of its block (``batch_split``)."""
    from repro_torch.data import (CopyTaskConfig, SyntheticLM,
                                  make_copy_task_batch)
    from repro_torch.parallel.sharding import batch_split
    rules = _rules("moe-batch")
    dcfg = CopyTaskConfig(vocab=BASE["vocab"], seq_len=SEQ, global_batch=GB)
    got = SyntheticLM(dcfg, mesh=mesh, task="copy", device="cpu",
                      rules=rules).next()
    n, i = batch_split(mesh, rules)
    glob = make_copy_task_batch(dcfg, 0, "cpu")
    rows = GB // n
    return {"block": i, "coord": (_coord(mesh)["pod"], _coord(mesh)["data"]),
            "got": {k: v.numpy() for k, v in got.items()},
            "want": {k: v[i * rows:(i + 1) * rows].numpy()
                     for k, v in glob.items()}}


def _recurrent_fsdp(rank, mesh, torch, batch):
    """jamba's SMOKE config (f32, capacity factor 8, the factorized plan,
    remat) at test_torch_tp.py's fan-in init under
    ``embed_fsdp=("model",)``: mamba's ``in_proj`` gathered whole over
    ``model``, each rank using the channel pairs its ``out_proj`` splits.
    The gathered reduced gradients, and on rank 0 the port's one-device
    ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, make_loss_fn, reduce_grads
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map, tree_with_leaves)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.sharding import (ShardingRules, batch_group,
                                               batch_split)
    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(
        **{k: BASE[k] for k in ("capacity_factor", "param_dtype",
                                "compute_dtype", "a2a_backend", "remat")})
    model = build_model(cfg)
    init = _numpy_init(model.specs(), 50, cfg.d_model)
    rules = ShardingRules().override(embed_fsdp=("model",))
    sh = param_shardings(model.specs(), mesh, rules)
    params = params_from_jax(init, cfg, "cpu", mesh=mesh, rules=rules)
    tree_map(lambda t: t.requires_grad_(True), params)
    n, i = batch_split(mesh, rules)
    rows = GB // n
    local = {k: torch.from_numpy(v[i * rows:(i + 1) * rows])
             for k, v in batch.items()}
    leaves = tree_leaves(params)
    total, _ = make_loss_fn(model, mesh, rules)(params, local)
    got = torch.autograd.grad(total, [t for _, t in leaves])
    grads = reduce_grads(tree_with_leaves(
        params, {p: g for (p, _), g in zip(leaves, got)}), sh,
        batch_group(mesh, rules))
    out = {"grads": _np(sh.gather_tree(grads)),
           "over_model": sorted(p for p, kept in sh.fsdp_kept.items()
                                if kept == ("model",))}
    if rank == 0:
        one = params_from_jax(init, cfg, "cpu")
        tree_map(lambda t: t.requires_grad_(True), one)
        lv = tree_leaves(one)
        total1, _ = model.loss(one, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        g1 = torch.autograd.grad(total1, [t for _, t in lv])
        out["one_device"] = {p: g.numpy() for (p, _), g in zip(lv, g1)}
    return out


def _ranks(rank, n, init, batch, tokens, elastic_params, tmp):
    import torch
    from repro_torch.core.cache import cart_create
    mesh = cart_create(n, *MESH, device_type="cpu")
    out = {"pipeline": _pipeline(mesh),
           "cases": {name: _case(rank, mesh, torch, name, init[name], batch)
                     for name in CASES},
           "serve": {name: _serve(rank, mesh, torch, name, init[name],
                                  tokens) for name in SERVED},
           "recurrent": _recurrent_fsdp(rank, mesh, torch, batch)}
    # last: ranks 4-7 leave the world here
    out["elastic"] = _elastic(rank, mesh, elastic_params, Path(tmp))
    return out


_JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.cache import cart_create
from repro.models import (build_model, config, make_loss_fn,
                          make_prefill_fn, make_serve_step, make_train_step)
from repro.models.common import param_shardings
from repro.optim import AdamW, AdamWConfig
from repro.parallel.sharding import ShardingRules

data = np.load(sys.argv[1])
dims, names, cases, served, lr, steps, prompt, ticks = eval(sys.argv[2])


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


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


mesh = cart_create(8, dims, names)
replicated = NamedSharding(mesh, P())
out = {}
for name, (fields, rule_kw) in cases.items():
    rules = ShardingRules().override(**rule_kw)
    batch_axes = tuple(a for a in rules.lookup("batch") if a in mesh.shape)
    rows = NamedSharding(mesh, P(batch_axes))
    batch = {k: jax.device_put(jnp.asarray(data[k]), rows)
             for k in ("tokens", "labels", "mask")}
    model = build_model(config.ModelConfig(**fields))
    shardings = param_shardings(model.specs(), mesh, rules)
    params = jax.device_put(unflat(name), shardings)
    (total, _), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(model, mesh, rules), has_aux=True))(params, batch)
    out[f"{name}|loss|total"] = np.asarray(total)
    for k, v in flat(grads).items():
        out[f"{name}|grad|{k}"] = v
    if name in served:
        toks = jax.device_put(jnp.asarray(data["serve"]), rows)
        out[f"{name}|serve|prefill"] = np.asarray(jax.jit(make_prefill_fn(
            model, mesh, rules))(params, toks[:, :prompt]))
        caches = model.init_caches(toks.shape[0], prompt + ticks)
        step = jax.jit(make_serve_step(model, mesh, rules))
        got = []
        for t in range(prompt + ticks):
            _, logits, caches = step(params, caches, toks[:, t:t + 1])
            if t >= prompt - 1:
                got.append(np.asarray(logits[:, 0]))
        out[f"{name}|serve|ticks"] = np.stack(got, 1)
    opt = AdamW(AdamWConfig(lr=lr))
    layout = (shardings, {"mu": shardings, "nu": shardings,
                          "step": replicated})
    state = jax.device_put(jax.jit(opt.init)(params), layout[1])
    step = jax.jit(make_train_step(model, opt, mesh, rules),
                   out_shardings=(*layout, replicated))
    for s in range(steps):
        params, state, m = step(params, state, batch)
        for k, v in m.items():
            out[f"{name}|step{s}|{k}"] = np.asarray(v)
    for k, v in flat(params).items():
        out[f"{name}|params|{k}"] = v
np.savez(sys.argv[3], **out)
"""


def _start_jax(tmp, init):
    """The reference's cases in a subprocess of 8 forced host devices;
    returns (process, output path)."""
    arrays = dict(_batch(), serve=_serve_tokens())
    for name in CASES:
        arrays.update({f"{name}|{p}": v
                       for p, v in _jax_flat(init[name]).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    args = (*MESH, {n: (_fields(n), CASES[n][1]) for n in CASES}, SERVED,
            LR, STEPS, PROMPT, TICKS)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"), repr(args),
         str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp / "out.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference started first, then the port's world: ``(per-rank
    results, {case: reference results}, the reference's elastic run)``."""
    import jax
    from repro import models as jax_models
    from repro_torch.models import build_model, config
    tmp = tmp_path_factory.mktemp("rules")
    init = {name: _numpy_init(build_model(config.ModelConfig(
        **_fields(name))).specs(), 40 + k, BASE["d_model"])
            for k, name in enumerate(CASES)}
    jparams = jax_models.build_model(_elastic_cfg(jax_models.config)).init(
        jax.random.PRNGKey(0))
    proc, path = _start_jax(tmp, init)
    try:
        world = run_world(_ranks, 8, tmp / "world", init, _batch(),
                          _serve_tokens(),
                          jax.tree.map(np.asarray, jparams),
                          str(tmp / "ckpt"), timeout=420)
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        ref = {}
        for k, v in np.load(path).items():
            case, what, leaf = k.split("|")
            ref.setdefault(case, {}).setdefault(what, {})[leaf] = v
    finally:
        if proc.poll() is None:
            proc.kill()
    mp = pytest.MonkeyPatch()
    try:
        elastic_ref = _reference_run(jparams, tmp / "ref", mp)
    finally:
        mp.undo()
    return world, ref, elastic_ref


def _results(runs, case):
    world, ref, _ = runs
    return [r["cases"][case] for r in world], ref[case]


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_reduced_grads_match_jax(runs, case):
    ranks, ref = _results(runs, case)
    want = ref["grad"]
    losses = {}
    for r in ranks:
        losses.setdefault(r["block"], []).append(r["loss"])
    # each rank's loss is its row block's share times the block count
    np.testing.assert_allclose(np.mean([v[0] for v in losses.values()]),
                               float(ref["loss"]["total"]), **TOL)
    for rank, r in enumerate(ranks):
        assert set(r["grads"]) == set(want)
        for path, w in want.items():
            assert float(np.abs(w).max()) > 0, path
            np.testing.assert_allclose(r["grads"][path], w, **TOL,
                                       err_msg=f"{case} {path} rank {rank}")


@pytest.mark.parametrize("case", list(CASES))
def test_grad_norm_and_two_steps_match_jax(runs, case):
    ranks, ref = _results(runs, case)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["grad_norm"],
                                   float(ref["step0"]["grad_norm"]), **TOL)
        for s, m in enumerate(r["steps"]):
            for k, v in m.items():
                np.testing.assert_allclose(v, float(ref[f"step{s}"][k]),
                                           **TOL, err_msg=f"step {s} {k}")
        for path, w in ref["params"].items():
            np.testing.assert_allclose(r["params"][path], w, **TOL,
                                       err_msg=f"{case} {path} rank {rank}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_grads_match_the_one_device_port(runs, case):
    ranks, _ = _results(runs, case)
    want = ranks[0]["one_device"]
    for path, w in want.items():
        np.testing.assert_allclose(ranks[0]["grads"][path], w, **TOL,
                                   err_msg=f"{case} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_model_replicas_agree_bit_for_bit(runs, case):
    """The ``model`` ranks of a ``(pod, data)`` coordinate: the same
    routing, loss, reduced gradients and parameters of every leaf none of
    them splits; and each gathered tree is the same on every rank."""
    ranks, _ = _results(runs, case)
    first = {}
    for r in ranks:
        f = first.setdefault(r["coord"], r)
        assert r["loss"] == f["loss"]
        assert len(r["routed"]) == len(f["routed"])
        for (p, idx), (fp, fidx) in zip(r["routed"], f["routed"]):
            np.testing.assert_array_equal(p, fp)
            np.testing.assert_array_equal(idx, fidx)
        for what in ("same_grads", "same_params"):
            assert set(r[what]) == set(f[what]) and r[what]
            for path, v in r[what].items():
                np.testing.assert_array_equal(v, f[what][path], err_msg=path)
        for what in ("grads", "params"):
            for path, v in r[what].items():
                np.testing.assert_array_equal(v, ranks[0][what][path])
    assert len(first) == 4


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_shard_is_the_block_of_its_own_axes(runs, case):
    """Every FSDP leaf's shard is block ``i`` of the axes that leaf kept
    (row-major, most significant first), as the reference's
    ``NamedSharding`` lays it out; the moments have its shape; the axes
    are the resolver's, per leaf."""
    from repro_torch.models import build_model, config
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import fsdp_dim
    ranks, _ = _results(runs, case)
    shape = dict(zip(MESH[1], MESH[0]))
    rules = _rules(case)
    want = {}
    for path, spec in tree_leaves(build_model(config.ModelConfig(
            **_fields(case))).specs()):
        split = fsdp_dim(spec.shape, spec.logical, shape, rules)
        if split is not None and "expert" not in spec.logical:
            want[path] = split
    kept = {axes for _, axes in want.values()}
    assert kept == {"dense-vocab": {("pod",), ("pod", "data")},
                    "dense-fsdp": {("model",)},
                    "moe-fsdp": {("model",)}}.get(case, {("pod", "data")})
    for rank, r in enumerate(ranks):
        got = r["fsdp"]
        assert got["axes"] == {p: d for p, (d, _) in want.items()}
        per_leaf = got["kept"] if isinstance(got["kept"], dict) else \
            {p: got["kept"] for p in want}
        assert per_leaf == {p: axes for p, (_, axes) in want.items()}
        bad = [p for p, ok in got["blocks"].items() if not ok]
        assert set(got["blocks"]) == set(want) and not bad, (rank, bad)


def test_repeats_count_the_copies_of_a_row_block(runs):
    """The divisor beyond the batch group: ``pod`` (2) for every leaf
    under ``batch=("data",)``; 1 where the FSDP group over ``model``
    sums parts (``embed_fsdp=("model",)``: every gathered leaf of these
    models has a split consumer) and under ``vocab=("data",)``."""
    world, _, _ = runs
    for case in CASES:
        r = world[0]["cases"][case]
        want = 2 if "batch" in CASES[case][1] else 1
        assert set(r["repeats"].values()) == {want}, case
        assert r["whole_use"] == [], case


def test_recurrent_mixers_under_fsdp_over_model(runs):
    """jamba under ``embed_fsdp=("model",)``: every mamba ``in_proj`` is
    FSDP over ``model`` and used by its ``out_proj``'s split, and each
    rank's gathered reduced gradients match the port's one-device ones
    within 2e-4."""
    world, _, _ = runs
    want = world[0]["recurrent"]["one_device"]
    over = world[0]["recurrent"]["over_model"]
    assert any(p.endswith("mixer/in_proj") for p in over), over
    for rank, r in enumerate(world):
        got = r["recurrent"]["grads"]
        assert set(got) == set(want)
        for p, w in want.items():
            np.testing.assert_allclose(got[p], w, **TOL,
                                       err_msg=f"{p} rank {rank}")


def test_every_pod_replica_reads_the_same_rows(runs):
    """``SyntheticLM`` under ``batch=("data",)``: each rank's batch is row
    block ``data`` of the global one, so the ``pod`` ranks of a ``data``
    coordinate read the same rows."""
    world, _, _ = runs
    for r in world:
        p = r["pipeline"]
        assert p["block"] == p["coord"][1]
        for k, v in p["want"].items():
            np.testing.assert_array_equal(p["got"][k], v)


@pytest.mark.parametrize("case", SERVED)
def test_prefill_and_decode_logits_match(runs, case):
    """Full-vocab logits of ``make_prefill_fn`` and of each decode tick
    (the last prompt token and 4 more) under the case's rules, row
    blocks in order, against the reference on the mesh and the port
    without one; equal bits on the ranks of a block."""
    world, ref, _ = runs
    blocks = {}
    for r in world:
        s = r["serve"][case]
        if s["block"] in blocks:
            for a, b in zip(s["mesh"], blocks[s["block"]]):
                np.testing.assert_array_equal(a, b)
        blocks[s["block"]] = s["mesh"]
    pre = np.concatenate([blocks[i][0] for i in sorted(blocks)])
    ticks = np.concatenate([blocks[i][1] for i in sorted(blocks)])
    assert pre.shape == (GB, BASE["vocab"])
    assert ticks.shape == (GB, TICKS + 1, BASE["vocab"])
    np.testing.assert_allclose(pre, ref[case]["serve"]["prefill"], **TOL)
    np.testing.assert_allclose(ticks, ref[case]["serve"]["ticks"], **TOL)
    one_pre, one_ticks = world[0]["serve"][case]["one"]
    np.testing.assert_allclose(pre, one_pre, **TOL)
    np.testing.assert_allclose(ticks, one_ticks, **TOL)
    np.testing.assert_allclose(ticks[:, 0], pre, **TOL)


def test_survivors_keep_model_and_leave_with_broken_groups(runs):
    """Ranks 5 and 6 lost: 4 and 7 leave with them at step 4; 0-3 finish
    on (data 2, model 2), bit for bit the direct restore plus the same
    steps."""
    world, _, (tr, inj, _) = runs
    got = [r["elastic"] for r in world]
    assert {i for i, g in enumerate(got) if g["status"] == "lost"} == \
        set(LOST) | set(PARTNERS)
    assert [g["status"] for g in got[:4]] == ["done"] * 4
    assert [g["step"] for g in got[4:]] == [4] * 4
    ref_events = [e[0] for e in tr.watchdog.events]
    for g in got[:4]:
        assert g["step"] == 6 and g["mesh"] == [0, 1, 2, 3]
        assert g["dims"] == {"pod": 1, "data": 2, "model": 2}
        assert g["direct_equal"]
        assert g["fired"] == inj.fired == [("device_loss", "train_step", 5)]
        assert g["recoveries"] == tr.recoveries_done == 1
        assert g["events"] == ref_events
        assert g["logged"] == [row["step"] for row in tr.metrics_log]


def test_survivors_match_the_reference_elastic_trainer(runs):
    world, _, (_, _, want) = runs
    got = world[0]["elastic"]["params"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, **TOL, err_msg=p)


# ---------------------------------------------------------------------------
# in process, no world: the layout under each rule, the survivor arithmetic
# ---------------------------------------------------------------------------

RULE_SETS = {"default": {}, "batch": {"batch": ("data",)},
             "embed_fsdp": {"embed_fsdp": ("model",)},
             "vocab": {"vocab": ("data",)}}


@pytest.mark.parametrize("family", ["moe", "dense"])
@pytest.mark.parametrize("rule", list(RULE_SETS))
def test_layout_matches_the_reference_resolver(family, rule):
    """On ``{pod: 2, data: 2, model: 2}``, leaf by leaf: ``resolve_spec``
    is the reference's; ``fsdp_dim`` is the dim the reference gives an
    FSDP rule's axes (with them); ``model_dim`` the first other dim it
    gives ``model`` (an expert leaf's read with its FSDP rule as None,
    the reference MoE's re-constraint); and ``param_layout`` holds each
    leaf so."""
    from types import SimpleNamespace
    from repro.parallel.sharding import ShardingRules as JaxRules
    from repro.parallel.sharding import resolve_spec as jax_resolve
    from repro_torch.models import build_model, config
    from repro_torch.models.common import param_layout, tree_leaves
    from repro_torch.parallel.sharding import (FSDP_RULES, ShardingRules,
                                               fsdp_dim, model_dim,
                                               resolve_spec)
    shape = dict(zip(MESH[1], MESH[0]))
    rules = ShardingRules().override(**RULE_SETS[rule])
    jrules = JaxRules().override(**RULE_SETS[rule])
    fields = {**BASE, **(DENSE if family == "dense" else {})}
    specs = build_model(config.ModelConfig(**fields)).specs()
    lay = param_layout(specs, shape, rules)
    for path, spec in tree_leaves(specs):
        want = tuple(jax_resolve(spec.shape, spec.logical,
                                 SimpleNamespace(shape=shape), jrules))
        assert resolve_spec(spec.shape, spec.logical, shape, rules) == want
        axes = lambda part: (part,) if isinstance(part, str) else \
            tuple(part or ())
        split = next(((i, axes(part)) for i, (name, part) in
                      enumerate(zip(spec.logical, want))
                      if name in FSDP_RULES and axes(part)), None)
        assert fsdp_dim(spec.shape, spec.logical, shape, rules) == split
        expert = "expert" in spec.logical
        logical = tuple(None if expert and n in FSDP_RULES else n
                        for n in spec.logical)
        cut = tuple(jax_resolve(spec.shape, logical,
                                SimpleNamespace(shape=shape), jrules))
        tp = next((i for i, (name, part) in enumerate(zip(logical, cut))
                   if name not in FSDP_RULES and "model" in axes(part)),
                  None)
        assert model_dim(spec.shape, logical, shape, rules) == tp, path
        assert lay["model_axes"].get(path) == tp, path
        if expert:
            assert path not in lay["fsdp_axes"]
            assert lay["axes"][path] == spec.logical.index("expert")
        else:
            assert (lay["fsdp_axes"].get(path), lay["fsdp_kept"].get(
                path)) == (split or (None, None)), path
    mixer, ffn = "blocks/pos0/mixer/", "blocks/pos0/ffn/"
    if rule == "embed_fsdp":
        # the mixed layout: whole projections feeding split consumers
        for w in ("wq", "wk", "wv"):
            assert lay["fsdp_kept"][mixer + w] == ("model",)
            assert mixer + w not in lay["model_axes"]
        assert lay["model_axes"][mixer + "wo"] == 1          # its heads
        assert lay["model_axes"]["embed"] == 0               # the vocab
        if family == "dense":
            assert lay["fsdp_kept"][ffn + "w1"] == ("model",)
            assert lay["model_axes"][ffn + "w2"] == 1        # its F
        else:
            assert lay["model_axes"][ffn + "w1"] == 3        # F of E, D, F
        assert lay["partial"] == set() and lay["fsdp_whole"] == set()
    if rule == "vocab":
        assert lay["fsdp_kept"]["embed"] == ("pod",)
        assert lay["fsdp_kept"][mixer + "wq"] == ("pod", "data")


SURVIVORS = {
    # lost ranks -> (survivors, their mesh, the ranks that leave)
    "a whole pod": ((4, 5, 6, 7), [0, 1, 2, 3],
                    {"pod": 1, "data": 2, "model": 2}, [4, 5, 6, 7]),
    "a rank and its partner": ((3,), [0, 1, 4, 5, 6, 7],
                               {"pod": 1, "data": 3, "model": 2},
                               [2, 3]),
    "two groups": (LOST, [0, 1, 2, 3], {"pod": 1, "data": 2, "model": 2},
                   [4, 5, 6, 7]),
}


@pytest.mark.parametrize("case", list(SURVIVORS))
def test_survivor_layout(case):
    """``launch.mesh.survivor_layout`` on (pod 2, data 2, model 2), rank =
    model + 2 data + 4 pod: the EP coordinates whose whole ``model``
    group survives, refactorized, ``model`` kept."""
    from repro_torch.launch.mesh import survivor_layout
    lost, survivors, dims, leaving = SURVIVORS[case]
    shape = {"pod": 2, "data": 2, "model": 2}
    assert survivor_layout(shape, range(8), lost) == (survivors, dims,
                                                      leaving)


def test_survivor_layout_refuses_an_extent_the_experts_cannot_divide():
    """One rank lost leaves 3 whole EP coordinates: 4 experts cannot be
    spread over 3 (nor 3 over 4), and the refusal names the extent."""
    from repro_torch.launch.mesh import survivor_layout
    shape = {"pod": 2, "data": 2, "model": 2}
    survivor_layout(shape, range(8), (3,), n_experts=3)
    survivor_layout(shape, range(8), (3,), n_experts=6)
    with pytest.raises(ValueError, match="surviving EP extent 3 .* 4 "
                       "experts"):
        survivor_layout(shape, range(8), (3,), n_experts=4)
