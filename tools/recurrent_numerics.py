"""How far bf16 alone moves jamba-v0.1-52b's prefill logits on one card,
and where the kernel path sits inside that.

Run on one H100 from the repo root (about 1 minute; it gates nothing, so
it is not part of chip_smoke.py, whose set-up it reuses):

    python3 tools/recurrent_numerics.py

``chip_smoke.py [recurrent]`` holds jamba's last-position prefill logits
(full width, one superblock of 8 layers, B=2, S=2048, fan-in init)
against the plain versions at 2e-2 of the largest logit.  This tool
prints, at the config's capacity factor and dropless:

* the kernel path against the plain path, as it stands and with the
  plain run replaying the kernel run's routing (how many (token, router
  call) top-k sets the plain run would have chosen otherwise);
* the same gap at every position of the sequence (worst, median, 99th
  percentile, relative to each position's largest logit);
* at the config's capacity factor, both bf16 paths against the plain path
  in f32 (parameters and compute) with the same routing: the floor that
  bf16 rounding sets under both.

Exits 2 without a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _gap(a, b) -> float:
    return float((a - b).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("recurrent_numerics: no CUDA device; this tool runs only on a "
              "card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, make_prefill_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.phase_build()
    cfg, model, params, _ = cs._arch_model(cs.JAMBA, cs.JAMBA_LAYERS)
    del params
    torch.cuda.empty_cache()
    soft = cs._fan_in_init(model, cfg, seed=1)
    tokens = cs.prefill_tokens(cfg, cs.RECURRENT_B, cs.RECURRENT_S)
    kept = None
    for cf in (cfg.capacity_factor, None):
        m = build_model(cfg.replace(capacity_factor=cf))
        prefill = make_prefill_fn(m)
        routes = []
        with cs._routing(record=routes):
            out = prefill(soft, tokens)
        with ops.plain_versions():
            plain = prefill(soft, tokens)
            with cs._routing(replay=routes) as switched:
                replayed = prefill(soft, tokens)
        with torch.no_grad():
            all_routes = []
            with cs._routing(record=all_routes):
                full_k = m.forward(soft, tokens)[0]
            with ops.plain_versions(), cs._routing(replay=all_routes):
                full_p = m.forward(soft, tokens)[0]
        per_pos = ((full_k - full_p).abs().amax(-1)
                   / full_p.abs().amax(-1)).flatten()
        del full_k, full_p
        torch.cuda.empty_cache()
        print(f"[recurrent_numerics] {cfg.name} x{cfg.n_layers} capacity "
              f"factor {cf}: last position, kernel~plain "
              f"{_gap(out, plain):.4g}, kernel~plain with the routing "
              f"replayed {_gap(out, replayed):.4g}, of max |logit| "
              f"{float(plain.abs().max()):.4g} ({switched['switched']} of "
              f"{switched['tokens']} (token, router call) pairs choose "
              f"otherwise); every position (replayed): worst "
              f"{float(per_pos.max()):.4g}, median "
              f"{float(per_pos.median()):.4g}, 99th "
              f"{float(per_pos.quantile(0.99)):.4g} of its largest",
              flush=True)
        if kept is None:
            kept = (out, replayed, routes)
    out, replayed, routes = kept
    del model
    cs._cast_in_place(soft, torch.float32)
    torch.cuda.empty_cache()
    m32 = build_model(cfg.replace(param_dtype="float32",
                                  compute_dtype="float32"))
    with ops.plain_versions(), cs._routing(replay=routes):
        ref32 = make_prefill_fn(m32)(soft, tokens)
    print(f"[recurrent_numerics] against the plain path in f32 (the same "
          f"routing), last position: kernel {_gap(out, ref32):.4g}, plain "
          f"bf16 {_gap(replayed, ref32):.4g}, of max |logit| "
          f"{float(ref32.abs().max()):.4g}; {cs._card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
