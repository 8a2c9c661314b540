"""What one rounding of tensor parallelism does to the training gradients
of phi3.5-moe on one card.

Run on one H100 from the repo root (about 1 minute; it gates nothing, so
it is not part of chip_smoke.py, whose set-up it reuses):

    python3 tools/tp_numerics.py

Tensor parallelism over ``model`` = 2 splits the experts' F, so each rank
holds a bf16 partial of the ``w2`` product and the two are summed
(``parallel.sharding.tp_reduce``; the reference's ``psum`` does the same).
One device rounds the whole product once.  This tool runs
``chip_smoke.py [train_tp]``'s one-process step (full width, 1 layer, its
filled copy-task batch, remat) three times at the reference init and at
chip_smoke's fan-in init: as it is, once more (the same bits expected),
and with the ``w2`` product computed as two bf16 partials over the halves
of F summed in f32 and rounded once more, replaying the first run's
routing.  For each leaf it prints the relative norm gap of the second and
third runs to the first: what that rounding alone moves, with nothing
else of TP in the way.

Exits 2 without a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_numerics: no CUDA device; this tool runs only on a card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.phase_build()
    cfg = cs._train_ep_config()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3),
                        "cuda")
    E_loc = cfg.n_experts // cs.TP_BLOCKS
    fill = cs._pick_fill(model, params, E_loc, cs.TP_BLOCKS)
    batch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=cs.TRAIN_EP_S, global_batch=cs.TP_BLOCKS),
        0, "cuda")
    for v, t in enumerate(fill):
        batch["tokens"][v, :cs.TRAIN_EP_FILL] = t
    whole = kops.expert_matmul
    F = cfg.d_ff

    def split_w2(lhs, rhs, impl=None):
        """The w2 product (contraction F) as two bf16 partials."""
        if rhs.shape[1] != F:
            return whole(lhs, rhs, impl=impl)
        h = F // 2
        a = whole(lhs[..., :h].contiguous(), rhs[:, :h].contiguous(),
                  impl=impl)
        b = whole(lhs[..., h:].contiguous(), rhs[:, h:].contiguous(),
                  impl=impl)
        return (a.float() + b.float()).to(lhs.dtype)

    def run(replay=None, split=False):
        tree_map(lambda t: t.requires_grad_(True), params)
        leaves = tree_leaves(params)
        kops.expert_matmul = split_w2 if split else whole
        rec = []
        try:
            with cs._routing(record=rec, replay=replay) as stats:
                total, _ = model.loss(params, batch)
                grads = torch.autograd.grad(total, [t for _, t in leaves])
        finally:
            kops.expert_matmul = whole
        tree_map(lambda t: t.requires_grad_(False), params)
        return (float(total), {p: g.float() for (p, _), g
                               in zip(leaves, grads)}, rec, dict(stats))

    gap = lambda a, b: float((a - b).norm() / b.norm())
    for init in cs.TP_INITS:
        if init == "fan-in":
            cs._fan_in_scale(params, model.specs(), cfg)
        loss, grads, routes, _ = run()
        loss2, grads2, _, _ = run(replay=routes)
        loss3, grads3, _, stats = run(replay=routes, split=True)
        print(f"[tp_numerics] {init} init: loss {loss:.6g}, again "
              f"{loss2:.6g}, w2 as two bf16 partials {loss3:.6g} (routing "
              f"replayed; it would have switched {stats['switched']} of "
              f"{stats['tokens']} choices)", flush=True)
        for path, g in grads.items():
            print(f"[tp_numerics]   {init:9s} {path:30s} again "
                  f"{gap(grads2[path], g):.3e}, two partials "
                  f"{gap(grads3[path], g):.3e}", flush=True)
    cs.log(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
