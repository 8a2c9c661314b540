"""Training launcher of the port: config -> model -> AdamW -> Trainer.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b \
      --smoke --steps 50                                    # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b \
      --smoke --steps 4 --device cpu                        # on the CPU

``--device`` defaults to ``cuda`` and raises on a machine without a card.

On a mesh, ``build_training(cfg, mesh, rules)`` trains with expert
parallelism over ``ep_axes(mesh)``, data parallelism over the "batch"
rule's axes, tensor parallelism over ``model`` and FSDP over the
``embed_fsdp`` rule's axes (the embedding's and attention's ``d_model``
dim over ``pod`` / ``data``; ``rules=ShardingRules().override(
embed_fsdp=())`` keeps those leaves whole): every rank of an
initialised process group (gloo or NCCL) calls it with the same
``DeviceMesh`` (``core.cache.cart_create``, or ``launch.mesh``), draws
the same global parameters from ``seed`` and keeps its shard, and
``Trainer`` (given ``sharding=``) and ``SyntheticLM(mesh=...)`` run on
it.  The CLI's ``--mesh debug`` / ``debug_multi`` are the reference's
debug meshes, ``(data=2, model=4)`` and ``(pod=2, data=2, model=4)``: run
under a launcher that starts 8 or 16 ranks (environment init), e.g.

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch phi3.5-moe-42b --smoke --mesh debug --device cpu --steps 3

or in a process group the caller initialised; a world of another size
is refused.  The launcher's group is NCCL where every local rank has a
card of its own, else gloo (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import CopyTaskConfig, SyntheticLM
from repro_torch.launch.mesh import check_trainable, debug_shape, make_mesh
from repro_torch.models import build_model, make_train_step
from repro_torch.models.common import (param_shardings, resolve_device,
                                       tree_map)
from repro_torch.optim import AdamW, AdamWConfig, cosine_with_warmup
from repro_torch.runtime import Trainer, TrainerConfig


def build_training(cfg, mesh=None, rules=None, *, lr=3e-4, warmup=100,
                   total=10000, grad_accum=1, seed=0, device="cuda"):
    """(model, optimizer, params, opt_state, step_fn): parameters drawn
    from ``seed`` with ``requires_grad``, AdamW with a cosine schedule,
    and ``make_train_step``.  On a mesh (collective) every rank draws the
    same global parameters and keeps its shard
    (``common.param_shardings``), and the AdamW state is the shard's."""
    device = resolve_device(device)
    if mesh is not None:
        check_trainable(mesh, cfg)
    model = build_model(cfg)
    opt = AdamW(AdamWConfig(lr=cosine_with_warmup(lr, warmup, total)))
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    if mesh is not None:
        params = param_shardings(model.specs(), mesh, rules) \
            .shard_tree(params)
    tree_map(lambda t: t.requires_grad_(True), params)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, mesh, rules, grad_accum=grad_accum)
    return model, opt, params, opt_state, step_fn


def _join_world(shape: dict, device) -> bool:
    """Make sure a process group of ``prod(shape)`` ranks is up: the
    caller's, or one from the environment a launcher such as torchrun
    sets.  Returns whether this call initialised it."""
    n = math.prod(shape.values())
    started = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"the mesh {shape} needs {n} ranks: start this module under "
                f"a launcher, e.g. torchrun --nproc-per-node {n} -m "
                f"repro_torch.launch.train ...")
        nccl = device.type == "cuda" and torch.cuda.device_count() >= int(
            os.environ.get("LOCAL_WORLD_SIZE", 1))
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group("nccl" if nccl else "gloo")
        started = True
    if dist.get_world_size() != n:
        raise SystemExit(f"the mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return started


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--task", choices=("lm", "copy"), default="copy")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("none", "debug", "debug_multi"),
                    default="none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh, started = None, False
    if args.mesh != "none":
        shape = debug_shape(multi_pod=args.mesh == "debug_multi")
        check_trainable(shape, cfg, args.seq)
        started = _join_world(shape, device)
        mesh = make_mesh(shape, device_type=device.type)
    model, opt, params, opt_state, step_fn = build_training(
        cfg, mesh, lr=args.lr, total=args.steps,
        warmup=min(20, args.steps // 5 or 1), grad_accum=args.grad_accum,
        device=device)
    data = SyntheticLM(CopyTaskConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch), mesh=mesh,
                       task=args.task, device=device)
    tr = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_dir=f"{args.ckpt_dir}/{cfg.name}",
                      checkpoint_every=args.ckpt_every, log_every=10),
        step_fn, data, params, opt_state,
        sharding=None if mesh is None
        else param_shardings(model.specs(), mesh))
    tr.install_preemption_handler()
    say = mesh is None or tr.ckpt.sharding.writer
    if args.resume and tr.try_restore() and say:
        print(f"[train] resumed from step {tr.step}")
    status = tr.run()
    if say:
        for row in tr.metrics_log:
            print(json.dumps(row))
        where = device if mesh is None else \
            f"{device} x {dist.get_world_size()} ranks, mesh {shape}"
        print(f"[train] {status} at step {tr.step} on {where}; median step "
              f"{tr.watchdog.median * 1e3:.1f} ms")
    if started:
        dist.destroy_process_group()
    return tr


if __name__ == "__main__":
    main()
