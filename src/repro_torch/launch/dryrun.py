"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device.

The port of ``repro.launch.dryrun``, for the records that have a torch
meaning.  The reference lowers and compiles each cell on 256 / 512
forced devices and records XLA's memory and cost analyses and the HLO's
collective bytes; torch has no compile step to ask.  Here each cell
builds its model, its parameters, AdamW moments, inputs and decode
states as ``meta`` tensors (shapes and dtypes, no storage), with no
process group and no world, and records per device of the production
mesh (``launch.mesh.production_shape``: (data=16, model=16) single-pod,
(pod=2, data=16, model=16) multi-pod), as ``parallel.sharding
.resolve_spec`` splits each leaf:

* ``status`` — ``ok``, or ``skipped`` with ``configs.applicable``'s
  reason (``long_500k`` on a full-attention arch);
* ``params_total`` / ``params_active`` — the spec tree's element count
  and ``ModelConfig.param_count_estimate(active_only=True)``;
* ``bytes_per_device`` — the parameters in their dtypes (``cfg.pdtype``
  unless a spec names its own), for train cells AdamW's ``mu`` / ``nu``
  in f32 beside them, the inputs of ``configs.input_specs`` (split over
  the batch rule), and for decode cells the KV caches and recurrent
  states of ``init_caches`` on ``meta`` with their logical axes
  (``models.transformer.cache_logical_axes``; the encoder-decoder's as
  the reference names them) and the encoder memory;
* ``a2a_plans`` — for an MoE arch the ``describe()`` of the dispatch /
  combine plan of its EP group on the production shape at the cell's
  capacity, resolved from the dims alone as the cost model (or a tuning
  DB record) picks it; ``a2a_plan_cache`` the plan registry's counts.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh single --set rules.embed_fsdp=

One JSON per cell goes to ``--out`` (default ``dryrun_out/`` at the
repo root, which git ignores); ``--tag`` suffixes the file names.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, applicable, get_config,
                                 input_specs)
from repro_torch.core.comm import torus_comm
from repro_torch.core.plan import plan_cache_stats
from repro_torch.launch.mesh import production_shape
from repro_torch.models import build_model
from repro_torch.models.common import (abstract_params, param_count,
                                       tree_leaves)
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.moe import _capacity
from repro_torch.models.transformer import cache_logical_axes
from repro_torch.parallel.sharding import ShardingRules, resolve_spec

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "dryrun_out"


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in ("true", "True", "false", "False"):
        v = v in ("true", "True")
    elif v == "none":
        v = None
    else:
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
    return k, v


def apply_overrides(cfg, rules, overrides):
    """``--set key=value`` config overrides; ``rules.<logical>=axis1+axis2``
    (or ``rules.<logical>=`` for replicated) rewires the sharding rules."""
    rule_kw, cfg_kw = {}, {}
    for kv in overrides or ():
        k, v = _parse_override(kv)
        if k.startswith("rules."):
            axes = tuple(a for a in str(v or "").split("+") if a)
            rule_kw[k[len("rules."):]] = axes
        else:
            cfg_kw[k] = v
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    if rule_kw:
        rules = (rules or ShardingRules()).override(**rule_kw)
    return cfg, rules


def device_bytes(t: torch.Tensor, logical, shape: dict[str, int],
                 rules: ShardingRules) -> int:
    """Bytes of one device's block of ``t`` split as ``resolve_spec``
    splits a leaf of its shape and ``logical`` axes on ``shape``."""
    n = t.numel()
    for part in resolve_spec(tuple(t.shape), logical, shape, rules):
        for a in (part,) if isinstance(part, str) else part or ():
            n //= shape[a]
    return n * t.element_size()


def _tree_bytes(tensors, logical, shape, rules) -> int:
    """Per-device bytes of a tree of tensors whose logical axes lie at the
    same paths of ``logical`` (a tree of tuples)."""
    axes = dict(tree_leaves(logical))
    return sum(device_bytes(t, axes[p], shape, rules)
               for p, t in tree_leaves(tensors))


def _cache_logical(model, cfg):
    if not isinstance(model, EncDecModel):
        return cache_logical_axes(cfg)
    # enc-dec: states {k, v, slot_pos} stacked over decoder layers
    kv = (None, "batch", "kv_heads", "seq_sp", None)
    return {"states": {"k": kv, "v": kv,
                       "slot_pos": (None, "batch", "seq_sp")},
            "pos": ("batch",)}


def _batch_ranks(shape, rules) -> int:
    part = resolve_spec((math.prod(shape.values()),), ("batch",), shape,
                        rules)[0]
    return math.prod(shape[a] for a in ((part,) if isinstance(part, str)
                                        else part or ()))


def _moe_plans(cfg, cell, shape, rules) -> list:
    """The MoE dispatch / combine plan a rank of this cell builds
    (``models.moe.moe_a2a_plan``, or the ragged plan when dropless),
    resolved on the EP group's dims: experts over ``data``, replicas over
    ``pod``."""
    axes = tuple(a for a in ("data", "pod") if a in shape)
    if not cfg.n_experts or not axes:
        return []
    G = math.prod(shape[a] for a in axes)
    E_loc = max(1, cfg.n_experts // G)
    spec = input_specs(cfg, cell)
    B = spec["batch"] if cell.kind == "decode" else spec["tokens"].shape[0]
    S = 1 if cell.kind == "decode" else spec["tokens"].shape[1] + (
        cfg.n_frontend_tokens if "frontend_embeds" in spec
        and not cfg.encoder_layers else 0)
    n_loc = B // _batch_ranks(shape, rules) * S
    C = _capacity(cfg, n_loc, max(cfg.n_experts, G))
    comm = torus_comm(tuple(shape[a] for a in axes), axes,
                      variant=cfg.a2a_variant)
    if cfg.capacity_factor is None:
        window = E_loc * C
        return [comm.ragged_all_to_all(
            row_shape=(cfg.d_model,), dtype=cfg.cdtype, max_count=window,
            avg_count=min(float(window), max(1.0, cfg.top_k * n_loc / G)),
            backend=cfg.a2a_backend, n_chunks=cfg.a2a_chunks,
            max_chunks=cfg.a2a_chunks or 4)]
    return [comm.all_to_all(block_shape=(E_loc, C, cfg.d_model),
                            dtype=cfg.cdtype, backend=cfg.a2a_backend,
                            n_chunks=cfg.a2a_chunks,
                            max_chunks=cfg.a2a_chunks or 4)]


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rules: ShardingRules | None = None, overrides=None) -> dict:
    """One cell's record (module docstring); host only, on ``meta``."""
    cfg, rules = apply_overrides(get_config(arch), rules, overrides)
    cell = SHAPES[shape_name]
    ok, reason = applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    t0 = time.perf_counter()
    shape = production_shape(multi_pod=mesh_kind == "multi")
    rules = rules or ShardingRules()
    model = build_model(cfg)
    specs = model.specs()

    logical = {p: s.logical for p, s in tree_leaves(specs)}
    params = abstract_params(specs, cfg.pdtype)
    nbytes = {"params": sum(device_bytes(t, logical[p], shape, rules)
                            for p, t in tree_leaves(params))}
    if cell.kind == "train":
        # AdamW's mu and nu: f32, split as their parameters
        nbytes["opt_state"] = 2 * sum(
            device_bytes(t.to(torch.float32), logical[p], shape, rules)
            for p, t in tree_leaves(params))
    spec = input_specs(cfg, cell)
    inputs = {k: v for k, v in spec.items() if isinstance(v, torch.Tensor)}
    if cell.kind == "decode":
        B, W = spec["batch"], spec["cache_len"]
        caches = model.init_caches(B, W, "meta")
        nbytes["caches"] = _tree_bytes(caches, _cache_logical(model, cfg),
                                       shape, rules)
        if cfg.encoder_layers:
            inputs["memory"] = torch.empty(
                (B, cfg.n_frontend_tokens, cfg.d_model), dtype=cfg.cdtype,
                device="meta")
    nbytes["inputs"] = sum(
        device_bytes(v, ("batch",) + (None,) * (v.dim() - 1), shape, rules)
        for v in inputs.values())
    nbytes["total"] = sum(nbytes.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "kind": cell.kind,
        "n_devices": math.prod(shape.values()), "mesh_shape": shape,
        "param_dtype": cfg.param_dtype,
        "params_total": param_count(specs),
        "params_active": cfg.param_count_estimate(active_only=True),
        "bytes_per_device": nbytes,
        "a2a_plans": [pl.describe() for pl in
                      _moe_plans(cfg, cell, shape, rules)],
        "a2a_plan_cache": plan_cache_stats(),
        "seconds": time.perf_counter() - t0,
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="KEY=VALUE",
                    help="config override (e.g. a2a_backend=direct, "
                         "capacity_factor=none, rules.embed_fsdp=)")
    ap.add_argument("--tag", default="",
                    help="file name suffix for variant runs")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help="directory for one JSON per cell")
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_NAMES if args.all or not args.arch else [args.arch]
    shapes = tuple(SHAPES) if args.all or not args.shape else [args.shape]
    tag = f"__{args.tag}" if args.tag else ""
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                name = f"{arch}__{shape}__{mesh_kind}{tag}.json"
                try:
                    rec = run_cell(arch, shape, mesh_kind,
                                   overrides=args.overrides)
                except Exception as e:  # noqa: BLE001 - record, go on
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(name)
                if args.tag:
                    rec.update(tag=args.tag, overrides=args.overrides)
                (args.out / name).write_text(json.dumps(rec, indent=1))
                records.append(rec)
                if rec["status"] == "ok":
                    print(f"[dryrun] {arch} x {shape} x {mesh_kind}: "
                          f"{rec['bytes_per_device']['total'] / 2**30:.3f} "
                          f"GiB/device")
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print(f"dry-run complete: {len(records)} cells in {args.out}")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
