"""Where the wgmma flash forward re-sums logits, what that costs, and what
the tensor cores' summation order alone does to the training gradients.

Run on one H100 from the repo root (about 3 minutes; it gates nothing,
so it is not part of chip_smoke.py, whose model set-up it reuses):

    python3 tools/flash_numerics.py

[logits]  phi3.5-moe-42b at full width, 4 layers, one prefill of
          chip_smoke's tokens (B=2, S=2048) at the reference init and at a
          fan-in init (``chip_smoke._fan_in_init``).  For each layer's
          attention inputs: the median |largest logit x = S * scale| of a
          row, the share of rows in which the kernel's re-summation fires
          (running max |x| at least ``resum_min``), the share of unmasked
          logits it re-sums (within ``resum_window`` of the running max at
          their kv tile; counted from torch's f32 logits, which may differ
          from the kernel's sums in the last bits), and the kernel's
          CUDA-event ms on those inputs beside its ms on randn inputs of
          the same shape and SDPA's on the same inputs.  The thresholds
          are read from the built kernel (``flash_attention.numerics()``).
[witness] The training model at full width, 2 layers, reference init, one
          loss + backward on chip_smoke's copy-task batch: each gradient
          leaf's relative norm gap to the plain path (expert matmul on the
          tensor cores, chip_smoke's reference) of the kernel path and of
          the plain path with its attention logits summed on the tensor
          cores (the f32 score product with TF32 allowed, on bf16-valued q
          and k: every product exact, only the order of summing differs),
          both replaying the kernel run's routing.

Exits 2 without a card.
"""

from __future__ import annotations

import contextlib
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds src/ to sys.path)

TILE = 128          # the wgmma variant's kv tile


@contextlib.contextmanager
def _capture(record: list):
    """``ops.flash_attention`` appending each call's (q, k, v, kwargs)."""
    from repro_torch.kernels import ops
    real = ops.flash_attention

    def flash(q, k, v, **kw):
        record.append((q, k, v, kw))
        return real(q, k, v, **kw)
    ops.flash_attention = flash
    try:
        yield
    finally:
        ops.flash_attention = real


def _logits(q, k, *, causal=True, window=None, scale=None, kv_offset=0):
    """x = q k^T * scale in f32, masked logits -inf: (B, Hq, Sq, Skv)."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(B, Hkv, Hq // Hkv, Sq, Dh).float(), k.float())
    x = s.reshape(B, Hq, Sq, Skv) * (scale or 1.0 / math.sqrt(Dh))
    rows = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return x.masked_fill(~mask, -math.inf), mask


def resum_stats(q, k, lo: float, width: float, **kw) -> dict:
    """The rows and logits the wgmma variant re-sums on these inputs."""
    x, mask = _logits(q, k, **kw)
    B, Hq, Sq, Skv = x.shape
    n_tiles = -(-Skv // TILE)
    xt = F.pad(x, (0, n_tiles * TILE - Skv), value=-math.inf).view(
        B, Hq, Sq, n_tiles, TILE)
    top = xt.amax(-1).cummax(-1).values      # running max, this tile's in
    fires = (top > -1e30) & (top.abs() >= lo)
    redo = fires[..., None] & (xt >= (top - width)[..., None])
    live = mask.any(-1).expand(B, Hq, Sq)
    row_max = x.amax(-1)[live]
    return {"median_max": float(row_max.abs().median()),
            "rows": float(fires.any(-1)[live].float().mean()),
            "logits": float(redo.sum()) / float(mask.sum() * B * Hq)}


def part_logits(gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     numerics)
    from repro_torch.models import build_model, make_prefill_fn
    num = numerics()
    lo, width = num["resum_min"], num["resum_window"]
    cfg = get_config(cs.ARCH).replace(n_layers=cs.N_LAYERS)
    model = build_model(cfg)
    tokens = cs.prefill_tokens(cfg)
    prefill = make_prefill_fn(model)
    cs.log(f"[logits] wgmma variant: {num}")
    for init in ("reference", "fan-in"):
        params = (model.init(torch.Generator(device=cs.DEVICE).manual_seed(0),
                             cs.DEVICE) if init == "reference"
                  else cs._fan_in_init(model, cfg, seed=1))
        calls = []
        with torch.no_grad(), _capture(calls):
            prefill(params, tokens)
        del params
        for layer, (q, k, v, kw) in enumerate(calls):
            st = resum_stats(q, k, lo, width, **kw)
            ms = cs.cuda_ms(lambda: flash_attention(q, k, v, **kw))
            rq, rk, rv = (cs._randn(gen, *t.shape) for t in (q, k, v))
            randn_ms = cs.cuda_ms(lambda: flash_attention(rq, rk, rv, **kw))
            sdpa_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw.get("causal", True), enable_gqa=True))
            cs.log(f"[logits] {init} init, layer {layer}, q "
                   f"{tuple(q.shape)} {kw}: median |largest logit| of a row "
                   f"{st['median_max']:.4g}; rows re-summed {st['rows']:.4g}; "
                   f"unmasked logits re-summed {st['logits']:.4g}; wgmma "
                   f"{ms:.3f} ms on these inputs, {randn_ms:.3f} ms on "
                   f"randn, sdpa {sdpa_ms:.3f} ms")
            del rq, rk, rv
        del calls
    del model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _tensor_core_scores():
    """The plain attention with its logits summed on the tensor cores (the
    f32 score product with TF32 allowed, on bf16-valued q and k, exact in
    TF32); the rest of the plain attention unchanged."""
    from repro_torch.kernels import flash_attention as fa
    ref = fa.ref_attention

    def attention(q, k, v, *, causal=True, window=None, scale=None,
                  kv_offset=0):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            x, _ = _logits(q, k, causal=causal, window=window, scale=scale,
                           kv_offset=kv_offset)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        B, Hq, Sq, Dh = q.shape
        Hkv = k.shape[1]
        probs = torch.nan_to_num(torch.softmax(x, dim=-1), nan=0.0)
        out = torch.einsum(
            "bhgqk,bhkd->bhgqd",
            probs.to(v.dtype).float().reshape(B, Hkv, Hq // Hkv, Sq, -1),
            v.float())
        return out.reshape(B, Hq, Sq, Dh).to(q.dtype)
    fa.ref_attention = attention
    try:
        yield
    finally:
        fa.ref_attention = ref


def part_witness():
    from repro_torch.configs import get_config
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = get_config(cs.ARCH).replace(n_layers=cs.TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cs.DEVICE).manual_seed(0),
                        cs.DEVICE)
    tree_map(lambda t: t.requires_grad_(True), params)
    leaves = tree_leaves(params)
    batch = make_copy_task_batch(
        CopyTaskConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_S,
                       global_batch=cs.TRAIN_B), 0, cs.DEVICE)

    def grads():
        total, _ = model.loss(params, batch)
        return torch.autograd.grad(total, [t for _, t in leaves])
    routes = []
    with cs._routing(record=routes):
        got = grads()
    with ops.plain_versions(), cs._tensor_core_gmm(), \
            cs._routing(replay=routes):
        want = grads()
    with ops.plain_versions(), cs._tensor_core_gmm(), _tensor_core_scores(), \
            cs._routing(replay=routes):
        scores = grads()
    kern, tc = cs._rel_gaps(got, want), cs._rel_gaps(scores, want)
    cs.log(f"[witness] {cfg.name} x{cfg.n_layers} layers, reference init, "
           f"B={cs.TRAIN_B} S={cs.TRAIN_S}: relative norm gap per leaf to "
           f"the plain path (gmm on the tensor cores): kernels, plain with "
           f"attention's logits summed on the tensor cores; the latter "
           f"{min(tc):.3g}-{max(tc):.3g}, the kernels {min(kern):.3g}-"
           f"{max(kern):.3g}")
    for (path, _), a, b in zip(leaves, kern, tc):
        cs.log(f"[witness]   {path:32s} {a:.3e} {b:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_numerics: no CUDA device; this script runs only on a "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(f"[env] torch {torch.__version__}; "
           f"{smi.stdout.strip().splitlines()[0]}; tf32 off")
    part_logits(torch.Generator(device=cs.DEVICE).manual_seed(0))
    part_witness()
    return 0


if __name__ == "__main__":
    sys.exit(main())
