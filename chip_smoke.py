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
6. collective — a 4-rank gloo world on the one card (every rank on
             cuda:0; NCCL refuses two ranks on one device).  The port's
             ``TorusComm`` on dims (2,2) and (4,): direct, factorized
             (natural and paper, every round order), reverse, tiled,
             all-gather and reduce-scatter must equal the definition of
             each collective bit for bit on CUDA tensors, and each round
             must launch the pack and the unpack kernel once.
7. moe_ep  — in the same world, phi3.5-moe's MoE layer at full width with
             expert parallelism over (data=2, pod=2): each rank holds 4 of
             the 16 experts and 512 tokens (B=1, S=512).  Cuts: one layer,
             capacity_factor 8 (no token drops), a2a_backend "factorized"
             (the config's "tuned" resolves to the overlap engine, not
             ported).  The gathered output must match the same layer with
             mesh=None on all 2048 tokens in one process within 2e-2 of
             the largest |y|, the aux loss within 1e-3; the gmm, pack and
             unpack kernels must have been launched (8 block-reorder
             launches per rank per call: 2 directions x 2 rounds x
             pack + unpack).

Phase 2 also holds the block-reorder kernel (the round-k datatype pack and
unpack) against its plain version, bit for bit, at every buffer phases 6-7
pack (their shapes derived from the same constants and config), at the EP
buffers of phi3.5-moe serving, the paper's tori and odd sizes.

Then it prints one JSON line of per-kernel numbers (``bound_ms`` is the
larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, the H100 SXM's
published peaks), the card's name and power limit from nvidia-smi, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))       # torch_dist: the spawn helper

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16, published
DEVICE = "cuda"
ARCH = "phi3.5-moe-42b"
N_LAYERS = 4
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
WORLD = 4                          # ranks of the collective phases
EP_TOKENS = 512                    # tokens per rank in [moe_ep]
COLL_TORI = (((2, 2), ("data", "pod")), ((4,), ("x",)))   # [collective]
COLL_B = 1000                      # [collective]'s f32 block per rank pair
COLL_TILED = (2, 2 * WORLD, 2)     # [collective]'s tiled input, split dim 1


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
    results.update(_reorder_kernels(gen))
    torch.cuda.synchronize()
    return results


def _abs_err(got, want) -> float:
    """max |got - want| (in f64, exact for int32 and every float dtype)."""
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def _reorder_case(gen, dims, B, dtype, label="", timed=(0,)):
    """Pack and unpack of a (p, B) buffer on the torus ``dims``: every
    round and both variants must equal the plain versions bit for bit
    (pure data movement: tolerance 0).  Rounds in ``timed`` are timed
    (natural variant, the path's default) against the plain versions,
    ``index_select`` / ``index_copy_`` and the bound."""
    from repro_torch.kernels.block_reorder import (
        VARIANTS, datatype_pack, datatype_pack_plain, datatype_unpack,
        datatype_unpack_plain, round_positions)
    p = math.prod(dims)
    if dtype.is_floating_point:
        x = _randn(gen, p, B, dtype=dtype)
    else:
        x = torch.randint(-2**31, 2**31 - 1, (p, B), generator=gen,
                          device=DEVICE, dtype=torch.int64).to(dtype)
    what = f"reorder dims {dims} B={B} {dtype}{label}"
    rows = []
    for k in range(len(dims)):
        err = 0.0      # max |kernel - plain| over both variants, both ways
        for v in VARIANTS:
            y = datatype_pack(x, dims=dims, k=k, variant=v)
            want = datatype_pack_plain(x, dims=dims, k=k, variant=v)
            err = max(err, _abs_err(y, want))
            if not torch.equal(y, want):
                fail(f"{what}: pack round {k} ({v}) differs from its "
                     f"plain version by up to {err:.3g}")
            u = datatype_unpack(y, dims=dims, k=k, variant=v)
            want = datatype_unpack_plain(y, dims=dims, k=k, variant=v)
            err = max(err, _abs_err(u, want))
            if not (torch.equal(u, x) and torch.equal(u, want)):
                fail(f"{what}: unpack round {k} ({v}) differs from its "
                     f"plain version (by up to {err:.3g}) or from x")
        if k not in timed:
            continue
        kw = dict(dims=dims, k=k, variant="natural")
        pos, ext = round_positions(tuple(dims), k, "natural")
        idx = (torch.tensor(pos, device=DEVICE)[None, :]
               + torch.arange(dims[k], device=DEVICE)[:, None] * ext)
        idx = idx.reshape(-1)
        y = datatype_pack(x, **kw)
        out = torch.empty_like(x)
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), 0)
        row = {"shape": f"{what} round {k}", "max_abs_err": err,
               "bound_ms": b_ms, "bound_by": b_by,
               "pack_ms": cuda_ms(lambda: datatype_pack(x, **kw)),
               "pack_plain_ms": cuda_ms(lambda: datatype_pack_plain(x, **kw)),
               "pack_library_ms": cuda_ms(
                   lambda: torch.index_select(x, 0, idx)),
               "unpack_ms": cuda_ms(lambda: datatype_unpack(y, **kw)),
               "unpack_plain_ms": cuda_ms(
                   lambda: datatype_unpack_plain(y, **kw)),
               "unpack_library_ms": cuda_ms(
                   lambda: out.index_copy_(0, idx, y))}
        rows.append(row)
        log(f"[kernels] {row['shape']}: pack {row['pack_ms']:.4f} ms "
            f"(plain {row['pack_plain_ms']:.4f}, index_select "
            f"{row['pack_library_ms']:.4f}); unpack {row['unpack_ms']:.4f} "
            f"ms (plain {row['unpack_plain_ms']:.4f}, index_copy_ "
            f"{row['unpack_library_ms']:.4f}); bound {b_ms:.4f} ms")
    return rows


def _path_reorder_cases():
    """(dims, B, dtype, label) of every (p, B) buffer that phases 6-7
    pack and unpack, derived from the same constants and config."""
    from repro_torch.models.moe import _capacity
    cfg = _ep_config()
    E_loc = cfg.n_experts // WORLD
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, WORLD))
    cases = [((2, 2), E_loc * C * cfg.d_model, cfg.cdtype,
              f" (moe_ep, C={C})")]
    for dims, _ in COLL_TORI:
        cases += [(dims, COLL_B, torch.float32, " (collective)"),
                  (dims, math.prod(COLL_TILED) // WORLD, torch.float32,
                   " (collective, tiled)")]
    return cases


def _reorder_kernels(gen):
    """Phase 2's block-reorder part: the buffers of phases 6-7 (the
    main row is [moe_ep]'s), the EP buffers of phi3.5-moe serving on a
    (2,2) torus (E_loc=4, D=4096, bf16; C=4 at decode on 4 slots, C=640
    at prefill B*S=4096), the paper's tori at the sweep of
    benchmarks/zero_copy_cost.py, (36,32), and the CPU sweep's odd
    sizes, dtypes and a misaligned base."""
    (dims, B, dtype, label), *coll = _path_reorder_cases()
    main = _reorder_case(gen, dims, B, dtype, label, timed=(0, 1))
    cases = list(main)
    for dims, B, dtype, label in coll:
        cases += _reorder_case(gen, dims, B, dtype, label)
    cases += _reorder_case(gen, (2, 2), 4 * 640 * 4096, torch.bfloat16,
                           " (MoE EP prefill, C=640)", timed=(0, 1))
    cases += _reorder_case(gen, (2, 2), 4 * 4 * 4096, torch.bfloat16,
                           " (MoE EP decode, C=4)", timed=(0, 1))
    for dims in ((5, 4), (2, 3, 4), (4, 3, 3, 4), (4, 4, 4)):
        for B in (16, 256, 4096, 65536):
            cases += _reorder_case(gen, dims, B, torch.float32)
    cases += _reorder_case(gen, (36, 32), 256, torch.float32)
    n = 0
    for dims in ((5, 4), (2, 3, 4), (4, 3, 3, 4), (2, 2, 2, 2), (6,),
                 (3, 2)):
        for B in (1, 5, 7, 9, 33):
            for dtype in (torch.bfloat16, torch.int32):
                _reorder_case(gen, dims, B, dtype, timed=())
                n += 1
    # a base that is 2-byte aligned only (rows of 13 bf16, offset one row)
    from repro_torch.kernels.block_reorder import (datatype_pack,
                                                   datatype_pack_plain)
    buf = _randn(gen, 7, 13)
    if not torch.equal(datatype_pack(buf[1:], dims=(3, 2), k=0),
                       datatype_pack_plain(buf[1:], dims=(3, 2), k=0)):
        fail("reorder: pack of a misaligned view differs")
    log(f"[kernels] reorder sweep: {n} odd cases (bf16, int32) and a "
        f"misaligned base agree bit for bit, both variants, every round")
    # the kernel's own device time at a small buffer, against the wall
    # time of a call (the wrapper's host work)
    dec = _randn(gen, 4, 4 * 4 * 4096)
    _profile(lambda: [datatype_pack(dec, dims=(2, 2), k=0, variant="natural")
                      for _ in range(20)],
             "pack of the 512 KiB decode buffer (20 calls)", per=20)
    out = {}
    for name, op, line in (("datatype_pack", "pack", 56),
                           ("datatype_unpack", "unpack", 101)):
        m = main[0]
        out[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/block_reorder.cu",
            replaces=f"src/repro/kernels/block_reorder.py:{line}",
            max_abs_err=m["max_abs_err"], ms=m[f"{op}_ms"],
            plain_ms=m[f"{op}_plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m[f"{op}_library_ms"],
            shape=m["shape"],
            cases=[{"shape": c["shape"], "ms": c[f"{op}_ms"],
                    "plain_ms": c[f"{op}_plain_ms"],
                    "library_ms": c[f"{op}_library_ms"],
                    "bound_ms": c["bound_ms"]} for c in cases])
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def _counters():
    from repro_torch.kernels.block_reorder import (datatype_pack,
                                                   datatype_unpack)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    return grouped_matmul, flash_attention, datatype_pack, datatype_unpack


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
            "flash_attention": cfg.n_layers, "datatype_pack": 0,
            "datatype_unpack": 0}
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
    want = {"grouped_matmul": 3 * cfg.n_layers * ticks, "flash_attention": 0,
            "datatype_pack": 0, "datatype_unpack": 0}
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


# ---------------------------------------------------------------------------
# phases 6 and 7: the collective and expert-parallel MoE, 4 ranks on one card
# ---------------------------------------------------------------------------


def _expert_weights(cfg, e: int, seed: int):
    """Expert ``e``'s (w1, w3, w2), drawn from a generator seeded by
    (seed, e), so a rank can make its own experts alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed * 1000 + e)
    D, F_ = cfg.d_model, cfg.d_ff
    w = [torch.randn(shape, generator=gen, device=DEVICE) / math.sqrt(fan)
         for shape, fan in (((D, F_), D), ((D, F_), D), ((F_, D), F_))]
    return [t.to(cfg.pdtype) for t in w]


def _ep_inputs(cfg, rank: int, seed: int):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen,
                         device=DEVICE) / math.sqrt(cfg.d_model)
    gen.manual_seed(seed + 1 + rank)
    x = torch.randn((1, EP_TOKENS, cfg.d_model), generator=gen,
                    device=DEVICE).to(cfg.cdtype)
    return router, x


def _ep_config():
    from repro_torch.configs import get_config
    return get_config(ARCH).replace(capacity_factor=8.0,
                                    a2a_backend="factorized")


def _rank_collective(rank: int, n: int) -> dict:
    """[collective] on one rank: every check against the definition,
    and the block-reorder launches of each factorized call."""
    import itertools
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.kernels.block_reorder import (datatype_pack,
                                                   datatype_unpack)
    ok, launches = {}, {"datatype_pack": 0, "datatype_unpack": 0}
    B = COLL_B
    gen = torch.Generator(device="cpu").manual_seed(5)
    X = torch.randn((n, n, B), generator=gen).to(DEVICE)
    Xi = torch.randint(-2**20, 2**20, (n, n, B), generator=gen,
                       dtype=torch.int32).to(DEVICE)
    x, want = X[rank].contiguous(), X[:, rank]
    for dims, names in COLL_TORI:
        mesh = cart_create(n, dims, names, device_type=DEVICE)
        comm = torus_comm(mesh, names)
        tag = "x".join(map(str, dims))
        ok[f"{tag} rank order"] = comm.rank == dist.get_rank() == rank
        ok[f"{tag} direct"] = torch.equal(comm.all_to_all(
            (B,), torch.float32, backend="direct").forward(x), want)
        for variant in ("natural", "paper"):
            vcomm = torus_comm(mesh, names, variant=variant)
            for order in itertools.permutations(range(len(dims))):
                plan = vcomm.all_to_all((B,), torch.float32,
                                        backend="factorized",
                                        round_order=order)
                for fn in (datatype_pack, datatype_unpack):
                    fn.launches = 0
                y, back = plan.forward(x), plan.reverse(x)
                counts = (datatype_pack.launches, datatype_unpack.launches)
                key = f"{tag} factorized {variant} {order}"
                ok[key] = torch.equal(y, want) and torch.equal(back, want)
                ok[f"{key} launches {counts}"] = \
                    counts == (2 * len(dims),) * 2
                launches["datatype_pack"] += counts[0]
                launches["datatype_unpack"] += counts[1]
        w = math.prod(COLL_TILED) // n          # elements per rank pair
        t = X[rank, :, :w].reshape(COLL_TILED).contiguous()
        c = COLL_TILED[1] // n
        want_t = torch.cat([X[s, :, :w].reshape(COLL_TILED)
                            [:, rank * c:(rank + 1) * c] for s in range(n)])
        for backend in ("direct", "factorized"):
            plan = comm.all_to_all(backend=backend)
            ok[f"{tag} tiled {backend}"] = torch.equal(
                plan.tiled(t, 1, 0), want_t)
            ok[f"{tag} all_gather {backend}"] = torch.equal(
                comm.all_gather((B,), torch.int32, backend=backend)
                .forward(Xi[rank, 0]), Xi[:, 0])
            ok[f"{tag} reduce_scatter {backend}"] = torch.equal(
                comm.reduce_scatter((B,), torch.int32, backend=backend)
                .forward(Xi[rank]), Xi[:, rank].sum(0, dtype=torch.int32))
    return {"ok": {k: bool(v) for k, v in ok.items()},
            "launches": launches}


def _rank_moe_ep(rank: int, n: int, seed: int) -> dict:
    """[moe_ep] on one rank: its 4 experts and 512 tokens through
    ``moe_block`` with the (data=2, pod=2) mesh."""
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import _group_geometry, moe_block, \
        moe_ep_comm
    cfg = _ep_config()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    v = moe_ep_comm(cfg, mesh, axes).rank
    router, x = _ep_inputs(cfg, rank, seed)
    w = [_expert_weights(cfg, e, seed) for e in
         range(v * E_loc, (v + 1) * E_loc)]
    p = {"router": router,
         **{name: torch.stack([we[i] for we in w])
            for i, name in enumerate(("w1", "w3", "w2"))}}
    torch.cuda.synchronize()
    _reset_counts()
    (y, aux), cold_ms = _host_ms(lambda: moe_block(p, x, cfg, mesh=mesh))
    counts = _read_counts()
    warm = [_host_ms(lambda: moe_block(p, x, cfg, mesh=mesh))[1]
            for _ in range(3)]
    if rank == 0:     # the other ranks run the same call unprofiled
        _profile(lambda: moe_block(p, x, cfg, mesh=mesh),
                 "moe_ep layer call, rank 0 of 4")
    else:
        moe_block(p, x, cfg, mesh=mesh)
    return {"y": y.float().cpu().numpy(), "aux": float(aux),
            "counts": counts, "cold_ms": cold_ms, "warm_ms": warm,
            "weight_gb": sum(t.numel() * t.element_size()
                             for t in p.values()) / 1e9,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _world_rank(rank: int, n: int, seed: int) -> dict:
    """One rank of the 4-rank gloo world: phases 6 and 7."""
    torch.cuda.set_device(0)
    return {"collective": _rank_collective(rank, n),
            "moe_ep": _rank_moe_ep(rank, n, seed)}


def run_world(seed: int, timeout: float = 600.0) -> list:
    """Spawn the 4-rank world with ``tests/torch_dist.py`` (FileStore
    init, killed at ``timeout``) and return each rank's result."""
    import torch_dist
    with tempfile.TemporaryDirectory() as tmp:
        try:
            return torch_dist.run_world(_world_rank, WORLD, tmp, seed,
                                        timeout=timeout)
        except (AssertionError, TimeoutError) as exc:
            fail(f"the {WORLD}-rank world: {exc}")


def phase_collective(results) -> dict:
    bad = sorted({k for r in results for k, v in r["collective"]["ok"]
                  .items() if not v})
    if bad:
        fail(f"[collective] wrong on CUDA tensors: {bad}")
    n_checks = len(results[0]["collective"]["ok"])
    launches = {k: sum(r["collective"]["launches"][k] for r in results)
                for k in ("datatype_pack", "datatype_unpack")}
    log(f"[collective] gloo took CUDA tensors; {n_checks} checks per rank "
        f"x {WORLD} ranks agree bit for bit (direct, factorized natural/"
        f"paper in every round order, reverse, tiled, all_gather, "
        f"reduce_scatter on (2,2) and (4,)); pack and unpack launched once "
        f"per round; launches over all ranks {launches}")
    return launches


def phase_moe_ep(results, seed: int) -> dict:
    """Hold the gathered EP output against the same layer with mesh=None
    on all tokens in this process; check the launch counts."""
    from repro_torch.models.moe import moe_block
    cfg = _ep_config()
    per_rank = {"grouped_matmul": 3, "flash_attention": 0,
                "datatype_pack": 4, "datatype_unpack": 4}
    for rank, r in enumerate(results):
        if r["moe_ep"]["counts"] != per_rank:
            fail(f"[moe_ep] rank {rank} launched {r['moe_ep']['counts']}, "
                 f"expected {per_rank}")
    router, _ = _ep_inputs(cfg, 0, seed)
    x = torch.cat([_ep_inputs(cfg, rank, seed)[1] for rank in range(WORLD)])
    w = [_expert_weights(cfg, e, seed) for e in range(cfg.n_experts)]
    p = {"router": router,
         **{name: torch.stack([we[i] for we in w])
            for i, name in enumerate(("w1", "w3", "w2"))}}
    del w
    y_ref, aux_ref = moe_block(p, x, cfg)
    y_ref = y_ref.float().cpu().numpy()
    y = np.concatenate([r["moe_ep"]["y"] for r in results])
    if y.shape != y_ref.shape or not np.isfinite(y).all():
        fail(f"[moe_ep] output {y.shape} not finite {y_ref.shape}")
    scale = float(np.abs(y_ref).max())
    err = float(np.abs(y - y_ref).max())
    if err > 2e-2 * scale:
        fail(f"[moe_ep] EP output differs from the one-process layer by "
             f"{err:.4g} (largest |y| {scale:.4g}; limit 2e-2 of it)")
    aux = [r["moe_ep"]["aux"] for r in results]
    if any(abs(a - float(aux_ref)) > 1e-3 * abs(float(aux_ref))
           for a in aux):
        fail(f"[moe_ep] aux {aux} vs {float(aux_ref):.6g}")
    warm = [t for r in results for t in r["moe_ep"]["warm_ms"]]
    r0 = results[0]["moe_ep"]
    log(f"[moe_ep] {ARCH} MoE layer, EP over (data=2, pod=2), "
        f"{EP_TOKENS} tokens x {WORLD} ranks, E_loc=4 ({r0['weight_gb']:.3f}"
        f" GB of expert weights per rank): max |y - one-process y| "
        f"{err:.4g} of max |y| {scale:.4g}; aux {aux[0]:.6f} vs "
        f"{float(aux_ref):.6f}; host ms per call: first "
        f"{max(r['moe_ep']['cold_ms'] for r in results):.1f}, then median "
        f"{float(np.median(warm)):.1f} (4 ranks share the card); launches "
        f"per rank per call {r0['counts']}; peak memory per rank "
        f"{r0['peak_gib']:.2f} GiB")
    del p
    return {k: sum(r["moe_ep"]["counts"][k] for r in results)
            for k in per_rank}


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
    del model, params
    torch.cuda.empty_cache()

    seed = 3
    world = run_world(seed)
    paths = {"prefill": prefill_counts, "serve": serve_counts,
             "collective": phase_collective(world),
             "moe_ep": phase_moe_ep(world, seed)}
    for name, entry in kernels.items():
        entry["launches_by_path"] = {path: counts.get(name, 0)
                                     for path, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
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
