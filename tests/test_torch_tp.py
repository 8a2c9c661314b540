"""Tensor parallelism over ``model`` in the port, on 8-rank gloo worlds,
against the JAX reference on the same meshes of 8 forced host devices
and against the port itself on one device.

Both packages run a 2-layer MoE model (d 32, d_ff 64, vocab 128, 4
experts, top-2, capacity factor 8, f32, remat) on the same weights,
drawn once with numpy from a seed and carried to each
(``params_from_jax`` with the mesh: each rank keeps its slices, the
FSDP leaves' ``d_model`` dim split over ``pod`` / ``data`` as the
reference's ``param_shardings`` splits it), and one numpy batch of 8 x
16 tokens, each row block on the ranks of its ``(pod, data)``
coordinate.  Cases:

* ``(data=2, model=4)``: query / kv heads 8/4 (both split: case a), 4/2
  (the kv heads stay whole, each rank reads the ones its query heads
  map to: case b), 2/2 (attention whole on every rank: case c); the
  factorized plan; and a dense model with qwen2.5-3b's ``qkv_bias`` and
  h2o-danube's sliding window (4 tokens) at heads 4/2, so case b slices
  the query bias by the rank's heads and keeps the kv biases whole.
* ``(data=2, model=4)`` under ``use_ulysses``: the sequence split over
  ``model`` and re-sharded to heads by the tiled all-to-all around
  attention, with every attention leaf whole over ``model`` and partial:
  heads 8/4 (k and v re-sharded too), 4/2 (k and v all-gathered along
  the sequence, each rank reading its query heads' kv heads) and 8/8
  under the overlap backend (2 head-group chunks through the pipelined
  re-shard).
* ``(pod=2, data=2, model=2)``, heads 4/2: the factorized plan, the
  overlap engine and dropless dispatch (the ragged Alltoallv) over the
  2-dim EP group; and a dense-FFN model (no experts) at d 30, which
  ``pod`` divides and ``pod * data`` does not, so the FSDP split keeps
  ``pod`` alone and its gradients are summed over ``data`` after the
  reduce-scatter.

* the recurrent archs on both meshes, their SMOKE fields in f32 (at
  remat, capacity factor 8 and the factorized plan for jamba's MoE):
  jamba-v0.1-52b (7 mamba positions and one attention, 4 MoE positions,
  EP over the batch axes), the same with ``spectral_long_conv`` (the
  spectral mixer in mamba's place), and xlstm-1.3b with ``xlstm_chunk``
  8 (the 16-token batch takes the chunkwise mLSTM, decode the per-step
  cell) at vocab 512.  Each mixer's channels or heads split over
  ``model``, its ``[xs | z]`` projection pairwise; on ``(data=2,
  model=4)`` one mLSTM head and 32 mamba channels a rank.  On that mesh
  also under ``use_ulysses`` (``jamba-u``, served too; ``xlstm-u``):
  jamba's attention layer sequence-parallel beside the mixers' split.
* the frontend and encoder-decoder archs, their SMOKE fields in f32 at
  remat, each batch with numpy ``frontend_embeds``: whisper-tiny (2 + 2
  layers, heads 4/4, 16 frames, vocab 256 split over ``model``) on both
  meshes and under ``use_ulysses`` on ``(data=2, model=4)`` (4 frames
  and 4 tokens a rank in each self- and cross-attention call), its ticks
  reading the encoder's memory of the rank's rows; internvl2-2b (heads
  4/2: case b on ``model`` = 4, case a on 2; 8 patch embeddings before
  the text, ``frontend_proj`` FSDP-split) on both.  On ``(data=2,
  model=4)`` under Ulysses, ``loss`` refuses whisper's 15 frames or 18
  decoder tokens and internvl2's F + S = 8 + 18, naming both numbers.

Checked within rtol = atol = 2e-4: the loss, every leaf's reduced
gradient gathered to the global tree, ``grad_norm`` and the parameters
after 2 AdamW steps against ``jax.value_and_grad`` / ``make_train_step``
of the reference on the mesh, and the gradients against the port's
``mesh=None`` ones on the global batch; prefill (``make_prefill_fn``)
and decode (``make_serve_step``, 4 ticks after an 8-token prompt)
logits, full-vocab, against the reference on the mesh and the port
without one.  Bit for bit: every ``model`` rank of a row block routes
the same tokens from the same router probabilities, computes the same
loss and ends with the same reduced gradients and parameters of its
leaves whole over ``model``.  FSDP: each rank holds block ``pod *
|data| + data`` (over the axes kept) of every FSDP leaf, its AdamW
moments the same shapes, no expert leaf is split by FSDP, and one case
per mesh run with ``embed_fsdp=()`` (every such leaf whole) gives the
same reduced gradients, norm and parameters within 2e-4.  The
checkpoint of a state split over the EP group, ``model`` and FSDP
restores with and without the mesh bit for bit (whisper-tiny's split
over ``model`` and FSDP too), and ``launch.train
--mesh debug --smoke --device cpu`` trains 3 steps in the 8-rank world,
for phi3.5-moe-42b, jamba-v0.1-52b and xlstm-1.3b.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from torch_dist import fsdp_layout, run_world

MESHES = {"dm": ((4, 2), ("model", "data")),               # fastest first
          "pdm": ((2, 2, 2), ("model", "data", "pod"))}
# the config both packages build, and per case: (mesh, its fields)
BASE = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, n_experts=4, top_k=2,
            capacity_factor=8.0, param_dtype="float32",
            compute_dtype="float32", a2a_backend="factorized", remat=True)
CASES = {"a-8/4": ("dm", dict(n_heads=8, n_kv_heads=4)),
         "b-4/2": ("dm", {}),
         "c-2/2": ("dm", dict(n_heads=2)),
         "factorized": ("pdm", {}),
         "overlap": ("pdm", dict(a2a_backend="overlap")),
         "dropless": ("pdm", dict(capacity_factor=None)),
         "dense": ("pdm", dict(family="dense", n_experts=0, d_model=30,
                               head_dim=8)),
         "u-8/4": ("dm", dict(n_heads=8, n_kv_heads=4, use_ulysses=True)),
         "u-4/2": ("dm", dict(use_ulysses=True)),
         "u-overlap": ("dm", dict(n_heads=8, n_kv_heads=8, use_ulysses=True,
                                  a2a_backend="overlap", a2a_chunks=2)),
         "b-bias-window": ("dm", dict(family="dense", n_experts=0,
                                      qkv_bias=True, window=4))}
# the recurrent cases: an arch's SMOKE fields with these changes
_JAMBA = dict(arch="jamba-v0.1-52b", capacity_factor=8.0,
              a2a_backend="factorized", remat=True)
_XLSTM = dict(arch="xlstm-1.3b", xlstm_chunk=8, vocab=512, remat=True)
RECURRENT = {"jamba": _JAMBA, "spectral": dict(_JAMBA,
                                               spectral_long_conv=True),
             "xlstm": _XLSTM}
CASES.update({f"{name}-{key}": (key, fields)
              for name, fields in RECURRENT.items() for key in ("dm", "pdm")})
# the recurrent mixers beside Ulysses attention on (data=2, model=4):
# jamba's attention layer sequence-parallel, its mixers split over model
# as without Ulysses; xlstm has no attention layer, so use_ulysses must
# change nothing
CASES.update({f"{name}-u": ("dm", dict(RECURRENT[name], use_ulysses=True))
              for name in ("jamba", "xlstm")})
RECURRENT_CASES = tuple(c for c, (_, f) in CASES.items() if "arch" in f)
UNSERVED = ("xlstm-u",)             # xlstm-dm's model: nothing reads Ulysses
# the frontend and encoder-decoder cases: their SMOKE fields under remat,
# each batch with numpy frontend_embeds (whisper's frames, internvl2's
# patch embeddings)
_WHISPER = dict(arch="whisper-tiny", remat=True)
_INTERNVL = dict(arch="internvl2-2b", remat=True)
FRONTEND = {"whisper-dm": ("dm", _WHISPER), "whisper-pdm": ("pdm", _WHISPER),
            "whisper-u": ("dm", dict(_WHISPER, use_ulysses=True)),
            "internvl-dm": ("dm", _INTERNVL),
            "internvl-pdm": ("pdm", _INTERNVL)}
CASES.update(FRONTEND)
FRONTEND_CASES = tuple(FRONTEND)                # served too
SERVE = {"dm": "b-4/2", "pdm": "factorized"}    # the cases served
ULYSSES = ("u-8/4", "u-4/2", "u-overlap")       # served too
# AdamW's eps in the recurrent and frontend cases: at the default 1e-8
# the first step's m / (sqrt(v) + eps) turns a gradient element within f32
# noise of zero (4e-9 in jamba's; whisper's embedding rows of the tokens
# the batch never holds) into +-lr, and one sign that the summation order
# flips moves that parameter by 2 lr, 10x the tolerance
RECURRENT_EPS = 1e-3
WHOLE = {"dm": "b-4/2", "pdm": "factorized"}    # also run embed_fsdp=()
GB, SEQ, LR, STEPS = 8, 16, 1e-3, 2
PROMPT, TICKS = 8, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _fields(name):
    """The config fields of case ``name``: ``BASE`` with its changes, or
    its arch's SMOKE config with them."""
    changes = dict(CASES[name][1])
    arch = changes.pop("arch", None)
    if arch is None:
        return {**BASE, **changes}
    from repro_torch.configs import get_config
    return {**dataclasses.asdict(get_config(arch, smoke=True)), **changes}


def _cfg(module, name):
    return module.ModelConfig(**_fields(name))


def _opt_fields(name):
    """The case's AdamWConfig fields beside the learning rate."""
    return {"eps": RECURRENT_EPS} if name in RECURRENT_CASES \
        or name in FRONTEND_CASES else {}


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 127, (GB, SEQ)).astype(np.int32),
            "labels": rng.integers(0, 127, (GB, SEQ)).astype(np.int32),
            "mask": (rng.uniform(size=(GB, SEQ)) < 0.8).astype(np.float32)}


def _frames(name):
    """Case ``name``'s global ``frontend_embeds`` (GB, F, D), std 1, from
    numpy, or None where its model has no frontend."""
    from repro_torch.models import config
    cfg = _cfg(config, name)
    if cfg.frontend is None:
        return None
    return np.random.default_rng(10 + list(CASES).index(name)) \
        .standard_normal((GB, cfg.n_frontend_tokens, cfg.d_model)) \
        .astype(np.float32)


def _case_batch(name, batch):
    """``batch`` with case ``name``'s ``frontend_embeds`` where it has a
    frontend."""
    frames = _frames(name)
    return batch if frames is None else dict(batch, frontend_embeds=frames)


def _serve_tokens():
    return np.random.default_rng(1).integers(
        0, 127, (GB, PROMPT + TICKS)).astype(np.int32)


def _flat(tree):
    from repro_torch.models.common import tree_leaves
    return {p: t.detach().numpy().copy() for p, t in tree_leaves(tree)}


def _recording_topk(torch, record):
    """``torch.topk`` that appends its input and indices to ``record`` (on
    this path only the MoE router calls it); returns the original."""
    real = torch.topk

    def topk(x, k, *args, **kwargs):
        out = real(x, k, *args, **kwargs)
        record.append((x.detach().numpy().copy(),
                       out.indices.detach().numpy().copy()))
        return out
    torch.topk = topk
    return real


def _case(rank, mesh, torch, name, jparams, batch, rules=None):
    """One training case on this rank: the gathered reduced gradients,
    norm, metrics and parameters after 2 steps, what must be the same
    bits on every ``model`` rank of its row block, the FSDP layout, and
    (rank 0, default rules) the port's mesh=None gradients of the global
    batch."""
    from repro_torch.models import (build_model, config, make_loss_fn,
                                    make_train_step, reduce_grads)
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map, tree_with_leaves)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW, AdamWConfig, global_norm
    from repro_torch.parallel.sharding import batch_group, batch_split

    cfg = _cfg(config, name)
    model = build_model(cfg)
    batch = _case_batch(name, batch)
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
    # whole over model: the same bits on each model rank of a row block
    whole = [p for p, _ in leaves if p not in sh.model_axes]
    out = {"block": i, "loss": float(total.detach()), "routed": routed,
           "shards": {p: tuple(t.shape) for p, t in leaves},
           "partial": sorted(sh.partial),
           "grads": _flat(sh.gather_tree(grads)),
           "whole_grads": {p: g.numpy() for p, g in tree_leaves(grads)
                           if p in whole},
           "grad_norm": float(global_norm(grads, sh))}
    opt = AdamW(AdamWConfig(lr=LR, **_opt_fields(name)))
    step = make_train_step(model, opt, mesh, rules)
    opt_state = opt.init(params)
    out["fsdp"] = fsdp_layout(mesh, sh, params, opt_state, jparams)
    out["steps"] = []
    for _ in range(STEPS):
        params, opt_state, m = step(params, opt_state, local)
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["params"] = _flat(sh.gather_tree(params))
    out["whole_params"] = {p: t.detach().numpy() for p, t
                           in tree_leaves(params) if p in whole}
    if name in FRONTEND_CASES:
        # the reference's AdamW state carried to the mesh: every moment
        # this rank's shard of the global one, as the parameters are
        from repro_torch.models.convert import opt_state_from_jax
        moments = {"mu": jparams, "nu": jparams, "step": np.int32(3)}
        carried = opt_state_from_jax(moments, cfg, "cpu", mesh=mesh,
                                     rules=rules)
        shard = params_from_jax(jparams, cfg, "cpu", mesh=mesh, rules=rules)
        out["opt_state_from_jax"] = int(carried["step"]) == 3 and all(
            torch.equal(t, dict(tree_leaves(carried[m]))[p].to(t.dtype))
            for m in ("mu", "nu") for p, t in tree_leaves(shard))
    if rank == 0 and rules is None:
        one = params_from_jax(jparams, cfg, "cpu")
        tree_map(lambda t: t.requires_grad_(True), one)
        lv = tree_leaves(one)
        total1, _ = model.loss(one, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        g1 = torch.autograd.grad(total1, [t for _, t in lv])
        out["one_device"] = {p: g.numpy() for (p, _), g in zip(lv, g1)}
        out["one_loss"] = float(total1.detach())
    return out


def _serve(rank, mesh, torch, name, jparams, tokens):
    """Prefill and decode on the mesh (this rank's row block), and on rank
    0 the same without a mesh on every row.  A frontend's embeddings go
    into the prefill; the encoder-decoder's ticks read the encoder's
    memory of the same frames (this rank's rows on the mesh)."""
    from repro_torch.models import (build_model, config, make_prefill_fn,
                                    make_serve_step)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.parallel.sharding import batch_split

    cfg = _cfg(config, name)
    model = build_model(cfg)
    frames = _frames(name)

    def run(params, toks, fr, mesh):
        pre = make_prefill_fn(model, mesh)(params, toks[:, :PROMPT], fr)
        memory = None
        if isinstance(model, EncDecModel):
            with torch.no_grad():
                memory = model.encode(params, fr, mesh=mesh)
        caches = model.init_caches(toks.shape[0], PROMPT + TICKS, "cpu",
                                   mesh=mesh)
        serve = make_serve_step(model, mesh)
        ticks = []
        for t in range(PROMPT + TICKS):
            _, logits, caches = serve(params, caches, toks[:, t:t + 1],
                                      memory)
            if t >= PROMPT - 1:
                ticks.append(logits[:, 0].numpy())
        return pre.numpy(), np.stack(ticks, 1)

    n, i = batch_split(mesh)
    rows = GB // n
    toks = torch.from_numpy(tokens)
    fr = None if frames is None else torch.from_numpy(frames)
    local = None if fr is None else fr[i * rows:(i + 1) * rows]
    out = {"case": name, "block": i,
           "mesh": run(params_from_jax(jparams, cfg, "cpu", mesh=mesh),
                       toks[i * rows:(i + 1) * rows], local, mesh)}
    if rank == 0:
        out["one"] = run(params_from_jax(jparams, cfg, "cpu"), toks, fr,
                         None)
    return out


def _checkpoint(mesh, torch, tmp):
    """States split over ``model`` and FSDP, the MoE case's over the EP
    group too, each saved on the mesh and restored with the mesh and
    without it: per case, the checks."""
    import json
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.launch.train import build_training
    from repro_torch.models import config
    from repro_torch.models.common import param_shardings, tree_leaves

    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in
                            zip(tree_leaves(a), tree_leaves(b)))
    out = {}
    for name in CHECKPOINTED:
        cfg = _cfg(config, name)
        model, _, params, opt_state, _ = build_training(
            cfg, mesh, lr=LR, warmup=1, total=10, seed=3, device="cpu")
        sh = param_shardings(model.specs(), mesh)
        state_sh = sh.prefixed("params").merged(
            sh.prefixed("opt_state/mu"), sh.prefixed("opt_state/nu"))
        live = {"params": params, "opt_state": opt_state}
        path = save_checkpoint(tmp / name, 0, live, sharding=state_sh)
        back, _, _ = restore_checkpoint(tmp / name, 0, live,
                                        sharding=state_sh)
        glob = state_sh.gather_tree(live)
        back_glob, _, _ = restore_checkpoint(tmp / name, 0, glob)
        manifest = json.loads((Path(path) / "manifest.json").read_text())
        out[name] = {"restore_mesh": same(live, back),
                     "restore_no_mesh": same(glob, back_glob),
                     "global_arrays": all(
                         manifest["leaves"][p]["shape"] == list(t.shape)
                         for p, t in tree_leaves(glob)),
                     "fsdp_and_model": any(
                         p in state_sh.fsdp_axes and p in state_sh.model_axes
                         for p, _ in tree_leaves(live))}
        if cfg.n_experts:
            out[name]["both_splits"] = any(
                p in state_sh.axes and p in state_sh.model_axes
                for p, _ in tree_leaves(live))
    return out


# the states checkpointed in the (pod=2, data=2, model=2) world
CHECKPOINTED = ("factorized", "whisper-pdm")


LAUNCHED = ("phi3.5-moe-42b", "jamba-v0.1-52b", "xlstm-1.3b")


def _launch(tmp):
    """The launcher's debug mesh in this world: 3 steps of each arch's
    smoke config on (data=2, model=4)."""
    from repro_torch.launch import train
    out = {}
    for arch in LAUNCHED:
        tr = train.main(["--arch", arch, "--smoke", "--mesh", "debug",
                         "--device", "cpu", "--steps", "3", "--batch", "8",
                         "--seq", "16", "--ckpt-dir", str(tmp / "launch"),
                         "--ckpt-every", "100"])
        out[arch] = {"step": tr.step, "rows": tr.metrics_log,
                     "losses": [r["total_loss"] for r in tr.metrics_log]}
    return out


def _served(key):
    """The cases served on mesh ``key``: ``SERVE``'s and the Ulysses,
    recurrent and frontend cases on it (not ``xlstm-u``, whose model is
    ``xlstm-dm``'s: no attention layer reads ``use_ulysses``)."""
    return (SERVE[key],) + tuple(
        c for c in ULYSSES + RECURRENT_CASES + FRONTEND_CASES
        if CASES[c][0] == key and c not in UNSERVED)


# Ulysses over model = 4 with a length it does not divide: (case, its
# config changes, tokens a row, frames a row)
REFUSED = {"frames": ("whisper-u", {}, SEQ, 15),
           "decoder": ("whisper-u", {}, 18, None),
           "f+s": ("internvl-dm", dict(use_ulysses=True), 18, None)}


def _refusals(mesh, torch):
    """What ``loss`` raises on this rank for each of ``REFUSED``: raised
    before anything runs (no parameters are read, no collective
    issued)."""
    from repro_torch.models import build_model, config
    out = {}
    for tag, (name, changes, S, F) in REFUSED.items():
        cfg = _cfg(config, name).replace(**changes)
        F = F or cfg.n_frontend_tokens
        batch = {"tokens": torch.zeros((2, S), dtype=torch.int32),
                 "labels": torch.zeros((2, S), dtype=torch.int32),
                 "frontend_embeds": torch.zeros((2, F, cfg.d_model))}
        try:
            build_model(cfg).loss({}, batch, mesh=mesh)
            out[tag] = None
        except ValueError as exc:
            out[tag] = str(exc)
    return out


def _ranks(rank, n, key, init, batch, tokens, tmp):
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.parallel.sharding import ShardingRules
    mesh = cart_create(n, *MESHES[key], device_type="cpu")
    name = WHOLE[key]
    out = {"cases": {name: _case(rank, mesh, torch, name, init[name], batch)
                     for name, spec in CASES.items() if spec[0] == key},
           "whole": _case(rank, mesh, torch, name, init[name], batch,
                          ShardingRules().override(embed_fsdp=())),
           "serve": {served: _serve(rank, mesh, torch, served, init[served],
                                    tokens)
                     for served in _served(key)}}
    if key == "pdm":
        out["checkpoint"] = _checkpoint(mesh, torch, Path(tmp))
    else:
        out["refusals"] = _refusals(mesh, torch)
        out["launch"] = _launch(Path(tmp))
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
dims, names, cases, opts, serve, lr, steps, prompt, ticks = eval(
    sys.argv[2])


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
rules = ShardingRules()
rows = NamedSharding(mesh, P(tuple(a for a in ("pod", "data")
                                   if a in mesh.shape)))
batch = {k: jax.device_put(jnp.asarray(data[k]), rows)
         for k in ("tokens", "labels", "mask")}
out = {}
for name, fields in cases.items():
    cfg = config.ModelConfig(**fields)
    model = build_model(cfg)
    params = jax.device_put(unflat(name), param_shardings(model.specs(),
                                                          mesh, rules))
    frames = None
    if f"frames|{name}" in data.files:
        frames = jax.device_put(jnp.asarray(data[f"frames|{name}"]), rows)
    batch_c = batch if frames is None else dict(batch,
                                                frontend_embeds=frames)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(model, mesh, rules), has_aux=True))(params, batch_c)
    out[f"{name}|loss|total"] = np.asarray(total)
    for k, v in flat(grads).items():
        out[f"{name}|grad|{k}"] = v
    if name in serve:
        toks = jax.device_put(jnp.asarray(data["serve"]), rows)
        out[f"{name}|serve|prefill"] = np.asarray(jax.jit(make_prefill_fn(
            model, mesh, rules))(params, toks[:, :prompt], frames))
        memory = None
        if cfg.encoder_layers:
            memory = jax.jit(lambda p, f: model.encode(
                p, f, mesh=mesh, rules=rules))(params, frames)
        caches = model.init_caches(toks.shape[0], prompt + ticks)
        step = jax.jit(make_serve_step(model, mesh, rules))
        got = []
        for t in range(prompt + ticks):
            _, logits, caches = step(params, caches, toks[:, t:t + 1],
                                     memory)
            if t >= prompt - 1:
                got.append(np.asarray(logits[:, 0]))
        out[f"{name}|serve|ticks"] = np.stack(got, 1)
    opt = AdamW(AdamWConfig(lr=lr, **opts[name]))
    state = jax.jit(opt.init)(params)
    # the state in and out of every step in the parameters' shardings:
    # one compile of the step
    shardings = param_shardings(model.specs(), mesh, rules)
    replicated = NamedSharding(mesh, P())
    layout = (shardings, {"mu": shardings, "nu": shardings,
                          "step": replicated})
    state = jax.device_put(state, layout[1])
    step = jax.jit(make_train_step(model, opt, mesh, rules),
                   out_shardings=(*layout, replicated))
    for s in range(steps):
        params, state, m = step(params, state, batch_c)
        for k, v in m.items():
            out[f"{name}|step{s}|{k}"] = np.asarray(v)
    for k, v in flat(params).items():
        out[f"{name}|params|{k}"] = v
np.savez(sys.argv[3], **out)
"""


# the recurrent mixers' matmul weights, contracted over their
# second-to-last dim (as the mLSTM's 3-dim wq / wk / wv / wo are)
_MIXER_WEIGHTS = ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w", "up",
                  "down", "wif", "w_gates", "r_gates", "up1", "up2")


def _numpy_init(specs, seed, d_model):
    """A parameter tree drawn with numpy from ``seed``, f32: every matmul
    weight at std 1 / sqrt(its contraction size), the tied embedding at
    1 / sqrt(d_model), norms at ones, the attention biases (zero at the
    reference's init) and the spectral mixer's ``B`` / ``C`` (as the
    reference draws them at one superblock) at std 1, and the mLSTM's
    gate weights ``wif`` at a tenth of the fan-in std: small gate
    pre-activations, as xLSTM's own init keeps them.  At the fan-in std
    the stabilized exponential gates make xlstm's gradients move by up to
    1e-3 of a leaf's largest when every parameter's last bit flips, in
    the reference as in the port
    (:func:`test_xlstm_case_is_conditioned_for_the_tolerance`).  (At the
    reference's init, whose stacked weights take their fan-in from the
    layer dim, activations are O(100) and the reference's own gradients on the mesh and on one
    device differ by about the tolerance on a leaf here: rounding, not
    sharding, would decide the gates.)"""
    from repro_torch.models.common import tree_leaves, tree_with_leaves
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in tree_leaves(specs):
        name, shape = path.rsplit("/", 1)[-1], spec.shape
        if name in ("bq", "bk", "bv", "B", "C"):
            out[path] = rng.standard_normal(shape).astype(np.float32)
            continue
        if spec.init in ("ones", "zeros"):
            out[path] = (np.ones if spec.init == "ones" else np.zeros)(
                shape, np.float32)
            continue
        fan_in = d_model if name == "embed" else \
            shape[-2] if name in _MIXER_WEIGHTS or len(shape) == 3 and \
            name in ("wq", "wk", "wv", "wo") else \
            shape[1] * shape[2] if name == "wo" else \
            shape[-2] if name in ("w1", "w2", "w3") else shape[1]
        out[path] = (rng.standard_normal(shape) * (
            0.1 if name == "wif" else 1.0) / np.sqrt(fan_in)).astype(
            np.float32)
    return tree_with_leaves(specs, out)


def _jax_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_jax_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _jax_groups():
    """The reference's subprocesses: per mesh, its recurrent cases and its
    frontend cases apart from the others, so that the three groups
    compile side by side."""
    groups = {}
    for name, (key, _) in CASES.items():
        tag = "recurrent" if name in RECURRENT_CASES else \
            "frontend" if name in FRONTEND_CASES else "base"
        groups.setdefault(f"{key}-{tag}", (key, []))[1].append(name)
    return groups


def _start_jax(tmp, group, key, names, init):
    """The reference's cases ``names`` on mesh ``key`` in a subprocess of
    8 forced host devices; returns (process, output path)."""
    arrays = dict(_batch(), serve=_serve_tokens())
    for name in names:
        arrays.update({f"{name}|{p}": v
                       for p, v in _jax_flat(init[name]).items()})
        if _frames(name) is not None:
            arrays[f"frames|{name}"] = _frames(name)
    np.savez(tmp / f"in_{group}.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    args = (*MESHES[key], {n: _fields(n) for n in names},
            {n: _opt_fields(n) for n in names},
            tuple(n for n in _served(key) if n in names), LR, STEPS, PROMPT,
            TICKS)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / f"in_{group}.npz"),
         repr(args), str(tmp / f"out_{group}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp / f"out_{group}.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references started first (:func:`_jax_groups`), then the
    port's two worlds: ``({mesh: per-rank results}, {case: reference
    results})``."""
    from repro_torch.models import build_model, config
    tmp = tmp_path_factory.mktemp("tp")
    init = {name: _numpy_init(build_model(_cfg(config, name)).specs(), k,
                              _cfg(config, name).d_model)
            for k, name in enumerate(CASES)}
    procs = {group: _start_jax(tmp, group, key, names, init)
             for group, (key, names) in _jax_groups().items()}
    try:
        with ThreadPoolExecutor(len(MESHES)) as pool:   # both worlds at once
            futures = {key: pool.submit(
                run_world, _ranks, 8, tmp / key, key, init, _batch(),
                _serve_tokens(), str(tmp / key), timeout=480)
                for key in MESHES}
            world = {key: f.result() for key, f in futures.items()}
        ref = {}
        for proc, path in procs.values():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err
            for k, v in np.load(path).items():
                case, what, leaf = k.split("|")
                ref.setdefault(case, {}).setdefault(what, {})[leaf] = v
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    return world, ref


def _results(runs, case):
    world, ref = runs
    return [r["cases"][case] for r in world[CASES[case][0]]], ref[case]


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
def test_model_ranks_agree_bit_for_bit(runs, case):
    """The ``model`` ranks of a row block: the same router probabilities
    and top-k choices in every layer (forward and remat recompute), the
    same loss, the same reduced gradients and parameters of every leaf
    whole over ``model`` (FSDP shards included: the ``model`` ranks of a
    row block hold the same block); and each gathered tree is the same
    on every rank."""
    from repro_torch.models import config
    ranks, _ = _results(runs, case)
    moe = _cfg(config, case).n_experts > 0
    first = {}
    for r in ranks:
        f = first.setdefault(r["block"], r)
        assert r["loss"] == f["loss"]
        assert len(r["routed"]) == len(f["routed"])
        assert len(r["routed"]) > 0 or not moe
        for (p, idx), (fp, fidx) in zip(r["routed"], f["routed"]):
            np.testing.assert_array_equal(p, fp)
            np.testing.assert_array_equal(idx, fidx)
        for what in ("whole_grads", "whole_params"):
            assert set(r[what]) == set(f[what])
            for path, v in r[what].items():
                np.testing.assert_array_equal(v, f[what][path], err_msg=path)
        for what in ("grads", "params"):
            for path, v in r[what].items():
                np.testing.assert_array_equal(v, ranks[0][what][path])
    assert len(first) == (2 if CASES[case][0] == "dm" else 4)


@pytest.mark.parametrize("case", list(CASES))
def test_resolver_matches_the_reference(case):
    """``parallel.sharding.resolve_spec`` against the reference's on every
    leaf of the case's model and its mesh shape (the reference's resolver
    reads only ``mesh.shape``), and ``fsdp_dim`` against the dim the
    reference's spec gives the FSDP rule's axes (with those axes)."""
    from types import SimpleNamespace
    from repro.parallel.sharding import resolve_spec as jax_resolve
    from repro_torch.models import build_model, config
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import fsdp_dim, resolve_spec
    dims, names = MESHES[CASES[case][0]]
    shape = dict(zip(names, dims))
    for path, spec in tree_leaves(build_model(_cfg(config, case)).specs()):
        want = tuple(jax_resolve(spec.shape, spec.logical,
                                 SimpleNamespace(shape=shape)))
        assert resolve_spec(spec.shape, spec.logical, shape) == want, path
        split = None
        for i, (name, part) in enumerate(zip(spec.logical, want)):
            axes = (part,) if isinstance(part, str) else part or ()
            if name == "embed_fsdp" and np.prod([shape[a] for a in axes]) > 1:
                split = (i, tuple(axes))
        assert fsdp_dim(spec.shape, spec.logical, shape) == split, path


def _flip_sensitivity(case, gate_scale):
    """The largest change, of a leaf's largest |g|, of the port's
    one-device gradients of case ``case`` (the tests' batch, with the
    mLSTM's ``wif`` times ``gate_scale``) when every parameter's last bit
    flips, each up or down at random."""
    import torch
    from repro_torch.models import build_model, config
    from repro_torch.models.common import (tree_leaves, tree_map,
                                           tree_with_leaves)
    from repro_torch.models.convert import params_from_jax
    cfg = _cfg(config, case)
    model = build_model(cfg)
    init = _numpy_init(model.specs(), list(CASES).index(case), cfg.d_model)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def grads(flip):
        def leaf(path, a):
            a = a * np.float32(gate_scale) if path.endswith("/wif") else a
            if flip:
                a = np.nextafter(a, np.where(rng.uniform(size=a.shape) < .5,
                                             np.inf, -np.inf).astype(a.dtype))
            return a
        tree = tree_with_leaves(init, {p: leaf(p, a) for p, a in
                                       tree_leaves(init)})
        params = params_from_jax(tree, cfg, "cpu")
        tree_map(lambda t: t.requires_grad_(True), params)
        leaves = tree_leaves(params)
        total, _ = model.loss(params, batch)
        return [g.numpy() for g in torch.autograd.grad(
            total, [t for _, t in leaves])]
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(grads(True), grads(False)))


def test_xlstm_case_is_conditioned_for_the_tolerance():
    """Why the xlstm cases draw ``wif`` at a tenth of the fan-in std: there
    a last-bit flip of every parameter moves no gradient leaf by 1e-4 of
    its largest |g|, so the 2e-4 gates compare the sharding, not f32
    rounding; at the fan-in std the same flip moves them by over 5e-4."""
    assert _flip_sensitivity("xlstm-dm", 1.0) < 1e-4
    assert _flip_sensitivity("xlstm-dm", 10.0) > 5e-4


def test_head_cases_shard_as_resolved(runs):
    """On (data=2, model=4): which attention leaves each rank holds as
    slices in the three head cases (their ``d_model`` dim split over
    ``data`` by FSDP), which kv leaves whole over ``model`` are partial,
    and the vocab and expert splits; under Ulysses every attention leaf
    whole over ``model`` and partial."""
    world, _ = runs
    mixer = "blocks/pos0/mixer/"
    for case, wq, wk, partial in (
            ("a-8/4", (2, 16, 2, 4), (2, 16, 1, 4), []),
            ("b-4/2", (2, 16, 1, 8), (2, 16, 2, 8),
             [mixer + "wk", mixer + "wv"]),
            ("c-2/2", (2, 16, 2, 16), (2, 16, 2, 16), []),
            ("u-8/4", (2, 16, 8, 4), (2, 16, 4, 4),
             [mixer + w for w in ("wk", "wo", "wq", "wv")]),
            ("u-4/2", (2, 16, 4, 8), (2, 16, 2, 8),
             [mixer + w for w in ("wk", "wo", "wq", "wv")])):
        for r in world["dm"]:
            got = r["cases"][case]
            assert got["shards"][mixer + "wq"] == wq
            assert got["shards"][mixer + "wk"] == wk
            assert got["partial"] == partial
            assert got["shards"]["embed"] == (32, 16)
            assert got["shards"]["blocks/pos0/ffn/w1"] == (2, 2, 32, 16)
            assert got["shards"]["blocks/pos0/ffn/router"] == (2, 32, 4)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_layout(runs, case):
    """Every rank holds block ``pod * |data| + data`` (over the axes the
    resolver kept) of each FSDP leaf, its AdamW moments the same shape;
    the FSDP leaves are exactly the ``embed_fsdp`` leaves the resolver
    splits, expert leaves excluded; all ranks agree on the layout."""
    from repro_torch.models import build_model, config
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import fsdp_dim
    ranks, _ = _results(runs, case)
    dims, names = MESHES[CASES[case][0]]
    shape = dict(zip(names, dims))
    want, kept = {}, set()
    for path, spec in tree_leaves(build_model(_cfg(config, case)).specs()):
        split = fsdp_dim(spec.shape, spec.logical, shape)
        if split is not None and "expert" not in spec.logical:
            want[path] = split[0]
            kept.add(split[1])
    assert want and len(kept) == 1
    kept = kept.pop()
    assert kept == (("pod",) if case == "dense" else
                    tuple(a for a in ("pod", "data") if a in shape))
    for rank, r in enumerate(ranks):
        got = r["fsdp"]
        assert got["axes"] == want and got["kept"] == kept
        assert not set(got["experts"]) & set(got["axes"])
        bad = [p for p, ok in got["blocks"].items() if not ok]
        assert set(got["blocks"]) == set(want) and not bad, (rank, bad)


@pytest.mark.parametrize("key", list(MESHES))
def test_fsdp_matches_the_whole_leaf_run(runs, key):
    """The FSDP run against the same case with ``embed_fsdp=()`` (every
    such leaf whole on every rank): reduced gradients (gathered),
    ``grad_norm``, metrics and the parameters after 2 steps."""
    world, _ = runs
    for rank, r in enumerate(world[key]):
        fsdp, whole = r["cases"][WHOLE[key]], r["whole"]
        assert whole["fsdp"]["axes"] == {} and fsdp["fsdp"]["axes"]
        np.testing.assert_allclose(fsdp["grad_norm"], whole["grad_norm"],
                                   **TOL)
        for what in ("grads", "params"):
            assert set(fsdp[what]) == set(whole[what])
            for path, w in whole[what].items():
                np.testing.assert_allclose(
                    fsdp[what][path], w, **TOL,
                    err_msg=f"{key} {what} {path} rank {rank}")
        for s, m in enumerate(fsdp["steps"]):
            for k, v in m.items():
                np.testing.assert_allclose(v, whole["steps"][s][k], **TOL,
                                           err_msg=f"step {s} {k}")


@pytest.mark.parametrize("key", list(MESHES))
def test_prefill_and_decode_logits_match(runs, key):
    """Full-vocab logits of ``make_prefill_fn`` and of each decode tick
    (the last prompt token and 4 more) on the mesh, row blocks in
    order, against the reference on the mesh and the port without one;
    equal bits on the ``model`` ranks of a block."""
    _check_served(runs, key, SERVE[key])


@pytest.mark.parametrize("case", ULYSSES)
def test_ulysses_prefill_and_decode_logits_match(runs, case):
    """As above for the Ulysses cases: prefill sequence-parallel over
    ``model`` through the tiled all-to-all, decode whole attention on
    every rank with a cache of every kv head."""
    _check_served(runs, CASES[case][0], case)


@pytest.mark.parametrize("case", [c for c in RECURRENT_CASES
                                  if c not in UNSERVED])
def test_recurrent_prefill_and_decode_logits_match(runs, case):
    """As above for the recurrent cases: the prefill's scans and the
    decode ticks' state updates on this rank's channels or heads, the
    recurrent states in ``init_caches(mesh=)``'s slices."""
    _check_served(runs, CASES[case][0], case)


def _check_served(runs, key, name):
    from repro_torch.models import config
    world, ref = runs
    V = _cfg(config, name).vocab
    blocks = {}
    for r in world[key]:
        s = r["serve"][name]
        if s["block"] in blocks:
            for a, b in zip(s["mesh"], blocks[s["block"]]):
                np.testing.assert_array_equal(a, b)
        blocks[s["block"]] = s["mesh"]
    pre = np.concatenate([blocks[i][0] for i in sorted(blocks)])
    ticks = np.concatenate([blocks[i][1] for i in sorted(blocks)])
    assert pre.shape == (GB, V) and ticks.shape == (GB, TICKS + 1, V)
    np.testing.assert_allclose(pre, ref[name]["serve"]["prefill"], **TOL)
    np.testing.assert_allclose(ticks, ref[name]["serve"]["ticks"], **TOL)
    one_pre, one_ticks = world[key][0]["serve"][name]["one"]
    np.testing.assert_allclose(pre, one_pre, **TOL)
    np.testing.assert_allclose(ticks, one_ticks, **TOL)
    # the last prompt token's decode logits are the prefill's, where the
    # ticks see what the prefill saw (a frontend's patches they do not)
    if name not in FRONTEND_CASES or "whisper" in name:
        np.testing.assert_allclose(ticks[:, 0], pre, **TOL)


def test_checkpoint_round_trip_with_and_without_the_mesh(runs):
    """The MoE state (EP, ``model`` and FSDP splits) and whisper-tiny's
    (``model`` and FSDP) saved on (pod=2, data=2, model=2) and restored
    with and without the mesh, bit for bit."""
    world, _ = runs
    for rank, r in enumerate(world["pdm"]):
        assert set(r["checkpoint"]) == set(CHECKPOINTED)
        for name, checks in r["checkpoint"].items():
            bad = [k for k, v in checks.items() if not v]
            assert not bad, (rank, name, bad)


@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_frontend_prefill_and_decode_logits_match(runs, case):
    """As above for the frontend and encoder-decoder cases: the prefill
    with the frontend's embeddings (internvl2's patches before the text,
    whisper's frames through the encoder) over this rank's heads, or
    under Ulysses its rows, and whisper's ticks reading the encoder's
    memory of the rank's rows, its KV cache of the rank's kv heads."""
    _check_served(runs, CASES[case][0], case)


@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_opt_state_from_jax_on_the_mesh(runs, case):
    """``opt_state_from_jax(mesh=)``: each rank's f32 moments are its
    shard of the reference's global state, as ``params_from_jax``'s
    parameters are, and the step carries over."""
    ranks, _ = _results(runs, case)
    assert all(r["opt_state_from_jax"] for r in ranks)


@pytest.mark.parametrize("tag", list(REFUSED))
def test_ulysses_refuses_lengths_model_does_not_divide(runs, tag):
    """On (data=2, model=4) under Ulysses, whisper's 15 frames or 18
    decoder tokens and internvl2's F + S = 8 + 18 are refused by ``loss``
    on every rank before anything runs, naming the length and
    ``model``."""
    world, _ = runs
    _, _, S, F = REFUSED[tag]
    n = {"frames": F, "decoder": S, "f+s": 8 + S}[tag]
    for r in world["dm"]:
        msg = r["refusals"][tag]
        assert msg is not None and f"({n}) divisible by model (4)" in msg, msg
        if tag == "f+s":
            assert f"F + S = 8 + {S}" in msg


def test_launch_train_on_the_debug_mesh(runs):
    world, _ = runs
    losses = [r["launch"]["phi3.5-moe-42b"]["losses"] for r in world["dm"]]
    for r in world["dm"]:
        assert r["launch"]["phi3.5-moe-42b"]["step"] == 3
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in losses)
    # every rank logs the batch mean: one value across the world
    assert len({v[0] for v in losses}) == 1


@pytest.mark.parametrize("arch", LAUNCHED[1:])
def test_launch_train_recurrent_on_the_debug_mesh(runs, arch):
    """The recurrent archs through the same launcher: 3 steps, and every
    rank logs the same row.  jamba's loss is finite; xlstm's SMOKE config
    at the reference's std-1 init gives NaN gradients on one device as
    in the reference (ROADMAP.md), so its row is held only for being the
    same bits on every rank."""
    world, _ = runs
    runs_ = [r["launch"][arch] for r in world["dm"]]
    for r in runs_:
        assert r["step"] == 3 and len(r["rows"]) == 1
        row = {k: v for k, v in r["rows"][0].items() if k != "seconds"}
        want = {k: v for k, v in runs_[0]["rows"][0].items()
                if k != "seconds"}
        assert set(row) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(row[k], v, err_msg=k)
    if arch == "jamba-v0.1-52b":
        assert np.isfinite(runs_[0]["losses"][0])
