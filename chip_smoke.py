#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``.  Phases, each
of which ends the run with a non-zero exit code and no result line when
it fails:

1. build   — compile every ``src/repro_torch/csrc/*.cu`` with nvcc for
             sm_90a, one nvcc per source, all started together.
2. kernels — call each kernel's wrapper on card tensors at the shapes the
             main path gives it, plus the CPU test sweep's odd shapes,
             windows and kv offsets, and hold the result against the
             kernel's plain PyTorch version on the same inputs (bf16:
             rtol = atol = 2e-2, the reference's bf16 tolerance, as both
             sum in f32 and differ by the summation order and one bf16
             rounding; f32: 1e-4).  Times the kernel, the plain version
             and one PyTorch library call of the same function (a
             yardstick only; the port never calls it).
3. prefill — ``make_prefill_fn`` on phi3.5-moe-42b at full width cut to 4
             layers, bf16, B=2, S=2048, random weights from a seed.  The
             last-position logits must match the same model run on the
             plain versions (``ops.plain_versions()``) within 2e-2 of the
             largest logit, and both kernels must have been launched.
4. serve   — the launcher's colocated body (``build_model`` ->
             ``make_serve_step`` -> ``ContinuousBatcher``) answers 4
             requests (prompts of 8-16 tokens, 16 new tokens each); the
             grouped-matmul count must grow by 3 * 4 layers * ticks.
5. profile — where the time goes: a warm prefill call and 4 warm decode
             ticks under torch.profiler (device time by op, busy share).

Then it prints one JSON line of per-kernel numbers (``bound_ms`` is the
larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, the H100 SXM's
published peaks), the card's name and power limit from nvidia-smi, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16, published
DEVICE = "cuda"
ARCH = "phi3.5-moe-42b"
N_LAYERS = 4
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) of bf16 work on an H100, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(what: str, got, want, tol: float) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if bool((err > tol + tol * w.abs()).any()):
        fail(f"{what}: max |kernel - plain| = {worst:.3g} exceeds rtol = "
             f"atol = {tol}")
    return worst


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} sources in {secs:.1f} s "
        f"({', '.join(build.SOURCES)}; rebuilt: {sorted(logs) or 'none'})")
    for name, text in logs.items():
        used = sorted({line.split("info    :")[-1].strip()
                       for line in text.splitlines() if "registers" in line})
        log(f"[build] {name} (ptxas, per instantiation): {'; '.join(used)}")
    for name in build.SOURCES:
        build.load(name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def phase_kernels(gen):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.moe_gmm import (grouped_matmul,
                                             grouped_matmul_plain)
    F = torch.nn.functional
    results = {}

    # ---- grouped matmul: the main path's shapes (phi3.5-moe: E=16,
    # D=4096, F=6400; C=4 at decode on 4 slots, C=640 at prefill B*S=4096)
    cases = []
    for phase, C in (("decode", 4), ("prefill", 640)):
        for K, N in ((4096, 6400), (6400, 4096)):
            a, b = _randn(gen, 16, C, K), _randn(gen, 16, K, N)
            what = f"gmm {phase} (16,{C},{K})x(16,{K},{N}) bf16"
            err = compare(what, grouped_matmul(a, b),
                          grouped_matmul_plain(a, b), TOL[torch.bfloat16])
            n_bytes = 2 * (16 * C * K + 16 * K * N + 16 * C * N)
            b_ms, b_by = bound(n_bytes, 2 * 16 * C * K * N)
            case = {"shape": what, "max_abs_err": err,
                    "ms": cuda_ms(lambda: grouped_matmul(a, b)),
                    "plain_ms": cuda_ms(lambda: grouped_matmul_plain(a, b)),
                    "library_ms": cuda_ms(lambda: torch.bmm(a, b)),
                    "bound_ms": b_ms, "bound_by": b_by}
            cases.append(case)
            log(f"[kernels] {what}: max_abs_err {err:.3g}, kernel "
                f"{case['ms']:.3f} ms, plain {case['plain_ms']:.3f} ms, "
                f"torch.bmm {case['library_ms']:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by})")
            del a, b
    # the CPU sweep's shapes (incl. the non-divisible (16,4,12,20)) and
    # ragged edges of both tile shapes, in both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, K, N in ((4, 16, 32, 24), (2, 128, 64, 128), (8, 8, 8, 8),
                           (1, 256, 128, 64), (16, 4, 12, 20),
                           (3, 9, 33, 130), (2, 130, 17, 129),
                           (5, 7, 300, 3)):
            a = _randn(gen, E, C, K, dtype=dtype)
            b = _randn(gen, E, K, N, dtype=dtype)
            compare(f"gmm ({E},{C},{K})x({E},{K},{N}) {dtype}",
                    grouped_matmul(a, b), grouped_matmul_plain(a, b),
                    TOL[dtype])
    log("[kernels] gmm sweep: 16 odd shapes in f32 and bf16 agree")
    main = cases[0]
    results["grouped_matmul"] = dict(
        name="grouped_matmul", route="cuda",
        source="src/repro_torch/csrc/grouped_matmul.cu",
        replaces="src/repro/kernels/moe_gmm.py:48",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        shape=main["shape"], cases=cases)

    # ---- flash attention: the prefill's shape (B=2, S=2048, 32 q heads,
    # 8 kv heads, hd=128, causal)
    B, Hq, Hkv, S, Dh = 2, 32, 8, 2048, 128
    q = _randn(gen, B, Hq, S, Dh)
    k, v = _randn(gen, B, Hkv, S, Dh), _randn(gen, B, Hkv, S, Dh)
    what = f"flash q({B},{Hq},{S},{Dh}) kv({B},{Hkv},{S},{Dh}) causal bf16"
    err = compare(what, flash_attention(q, k, v, causal=True),
                  flash_attention_plain(q, k, v, causal=True),
                  TOL[torch.bfloat16])
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                       4 * B * Hq * Dh * pairs)
    fa = {"shape": what, "max_abs_err": err,
          "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True)),
          "plain_ms": cuda_ms(
              lambda: flash_attention_plain(q, k, v, causal=True)),
          "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True, enable_gqa=True)),
          "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] {what}: max_abs_err {err:.3g}, kernel {fa['ms']:.3f} "
        f"ms, plain {fa['plain_ms']:.3f} ms, sdpa "
        f"{fa['library_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    del q, k, v
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        sweep = [((Bb, Hq_, Hk_, Ss, Ss, D), dict(causal=c))
                 for Bb, Hq_, Hk_, Ss, D in ((1, 2, 2, 64, 32),
                                             (2, 4, 2, 32, 16),
                                             (1, 4, 1, 64, 32),
                                             (1, 8, 8, 128, 64),
                                             (2, 6, 3, 48, 64),
                                             (1, 4, 2, 100, 128))
                 for c in (True, False)]
        sweep += [((1, 2, 2, 64, 64, 32), dict(causal=True, window=w))
                  for w in (1, 8, 16, 64)]
        sweep += [((1, 2, 2, 8, 64, 32), dict(causal=True, kv_offset=56)),
                  ((1, 4, 2, 37, 77, 64), dict(causal=False)),
                  ((1, 4, 2, 37, 77, 64), dict(causal=True, kv_offset=40)),
                  ((2, 4, 4, 150, 150, 16), dict(causal=False, window=20)),
                  ((1, 2, 1, 16, 16, 16), dict(causal=True, kv_offset=-4))]
        for (Bb, Hq_, Hk_, Sq, Sk, D), kw in sweep:
            q = _randn(gen, Bb, Hq_, Sq, D, dtype=dtype)
            k = _randn(gen, Bb, Hk_, Sk, D, dtype=dtype)
            v = _randn(gen, Bb, Hk_, Sk, D, dtype=dtype)
            compare(f"flash q{(Bb, Hq_, Sq, D)} kv{(Bb, Hk_, Sk, D)} {kw} "
                    f"{dtype}", flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw), TOL[dtype])
            n += 1
    log(f"[kernels] flash sweep: {n} cases (GQA, causal, windows, kv "
        f"offsets, ragged S, Dh 16-128, fully masked rows) agree")
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:86",
        **{k: fa[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")},
        shape=fa["shape"])
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    return grouped_matmul, flash_attention


def _reset_counts():
    for fn in _counters():
        fn.launches = 0


def _read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _counters()}


def _host_ms(fn):
    """Host-clock ms of one call of ``fn`` that ends in a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def prefill_tokens(cfg, B: int = 2, S: int = 2048):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S))).to(DEVICE)


def phase_prefill(model, params, cfg, tokens):
    from repro_torch.kernels import ops
    from repro_torch.models import make_prefill_fn
    B, S = tokens.shape
    prefill = make_prefill_fn(model)
    _reset_counts()
    out, cold_ms = _host_ms(lambda: prefill(params, tokens))
    counts = _read_counts()
    want = {"grouped_matmul": 3 * cfg.n_layers,
            "flash_attention": cfg.n_layers}
    if counts != want:
        fail(f"prefill launched {counts}, expected {want}")
    _, warm_ms = _host_ms(lambda: prefill(params, tokens))
    with ops.plain_versions():
        ref, plain_ms = _host_ms(lambda: prefill(params, tokens))
    if out.shape != (B, cfg.vocab) or not torch.isfinite(out).all():
        fail(f"prefill logits {tuple(out.shape)} not finite (B, V)")
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if err > 2e-2 * scale:
        fail(f"prefill logits differ from the plain run by {err:.4g} "
             f"(largest logit {scale:.4g}; limit 2e-2 of it)")
    same_top = bool((out.argmax(-1) == ref.argmax(-1)).all())
    log(f"[prefill] {ARCH} x{cfg.n_layers} layers B={B} S={S}: first call "
        f"{cold_ms:.1f} ms, second {warm_ms:.1f} ms, plain versions "
        f"{plain_ms:.1f} ms (host clock); launches {counts}; max |logit - "
        f"plain| {err:.4g} of max |logit| {scale:.4g}; same argmax: "
        f"{same_top}")
    return counts


def phase_serve(model, params, cfg):
    from repro_torch.launch.serve import batcher_step, serve_colocated
    from repro_torch.models import make_serve_step
    from repro_torch.runtime.serving import Request
    rng = np.random.default_rng(2)
    lengths, gen_len = (8, 11, 13, 16), 16
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, L)],
                    gen_len) for i, L in enumerate(lengths)]
    step = batcher_step(make_serve_step(model))
    finite, stamps = [], []

    def checked_step(params, toks, caches):
        stamps.append(time.perf_counter())
        logits, caches = step(params, toks, caches)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    _reset_counts()
    batcher, secs = serve_colocated(
        model, params, reqs, max_batch=len(reqs),
        max_seq=max(lengths) + gen_len, device=DEVICE,
        serve_step=checked_step)
    counts = _read_counts()
    ticks = batcher.ticks
    want = {"grouped_matmul": 3 * cfg.n_layers * ticks, "flash_attention": 0}
    if counts != want:
        fail(f"serve launched {counts} in {ticks} ticks, expected {want}")
    if sorted(batcher.done) != list(range(len(reqs))):
        fail(f"answered {sorted(batcher.done)} of {len(reqs)} requests")
    for rid, toks in batcher.done.items():
        if len(toks) != gen_len or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"request {rid}: tokens {toks} out of range or short")
    if not bool(torch.stack(finite).all()):
        fail("non-finite decode logits")
    tick_ms = np.diff(stamps) * 1e3
    log(f"[serve] {len(reqs)} requests (prompts {lengths}, {gen_len} new "
        f"tokens each) in {ticks} ticks, {secs * 1e3 / ticks:.2f} ms/tick "
        f"overall, median tick {float(np.median(tick_ms)):.2f} ms; launches "
        f"{counts}; request 0 tokens {batcher.done[0]}")
    return counts


def _profile(fn, label: str, per: int = 1):
    """Run ``fn`` under torch.profiler and print the device time by
    kernel: total kernel time against the host-clock wall time (the
    device's busy share; one stream, so kernels do not overlap) and the
    largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = _host_ms(fn)
    # kernels only: a CPU op's entry repeats the device time of its kernels
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device time")
        return
    log(f"[profile] {label}: wall {wall_ms / per:.2f} ms, device busy "
        f"{busy / per:.2f} ms ({100 * busy / wall_ms:.0f}%) per call; top:")
    for ms, key, count in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms / per:8.3f} ms {100 * ms / busy:5.1f}% "
            f"x{count // per} {key[:90]}")


def phase_profile(model, params, cfg, tokens):
    """Where the time goes: one warm prefill call and 4 warm decode
    ticks (4 slots) under the profiler."""
    from repro_torch.models import make_prefill_fn, make_serve_step
    prefill = make_prefill_fn(model)
    _profile(lambda: prefill(params, tokens), f"prefill B,S="
             f"{tuple(tokens.shape)}")
    serve = make_serve_step(model)
    caches = model.init_caches(4, 32, DEVICE)
    toks = tokens[:, :1].repeat(2, 1)[:4]
    nxt, _, caches = serve(params, caches, toks)      # warm-up tick

    def ticks():
        nonlocal nxt, caches
        for _ in range(4):
            nxt, _, caches = serve(params, caches, nxt[:, None])
    _profile(ticks, "decode tick (4 slots)", per=4)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}; tf32 off")
    phase_build()
    kernels = phase_kernels(torch.Generator(device=DEVICE).manual_seed(0))

    cfg = get_config(ARCH).replace(n_layers=N_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    log(f"[model] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} F={cfg.d_ff} E={cfg.n_experts} "
        f"top{cfg.top_k} vocab={cfg.vocab} layers={cfg.n_layers} "
        f"{cfg.param_dtype}: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tokens = prefill_tokens(cfg)
    prefill_counts = phase_prefill(model, params, cfg, tokens)
    serve_counts = phase_serve(model, params, cfg)
    log(f"[model] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase_profile(model, params, cfg, tokens)
    for name, entry in kernels.items():
        entry["launches"] = prefill_counts[name] + serve_counts[name]
        entry["launches_by_path"] = {"prefill": prefill_counts[name],
                                     "serve": serve_counts[name]}
        if entry["launches"] == 0:
            fail(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
