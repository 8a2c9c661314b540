"""The FA2 backward's variants on one H100, without the rest of
chip_smoke.py: quick to run while the kernels change.

Run on one H100 from the repo root (about a minute with the build; it
gates nothing that chip_smoke.py does not gate too):

    python3 tools/flash_bwd_bench.py [--quick]

[sweep]  chip_smoke's backward sweep (``_FLASH_BWD_SWEEP``) in f32 and
         bf16: each case through the variant it takes and, where that is
         wgmma, through mma too, against the plain version at chip_smoke's
         tolerances, two runs equal bit for bit.
[shapes] Every training shape (``chip_smoke._flash_train_shapes``): wgmma
         and mma against the plain version, two runs equal bit for bit,
         and (without ``--quick``) their CUDA-event ms in turns (wgmma,
         mma, mma, wgmma) beside the bound, SDPA's backward (a yardstick
         only), the split the wgmma dkv kernel takes (``dkv_splits``)
         and, from ``torch.profiler``, each of the wgmma variant's kernels'
         device µs a call (delta, the dq and dkv blocks' one launch, the
         group sum).

The card's name and power limit go on the first line.  Every case runs;
exits 2 without a card, 1 if any case disagrees.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the agreement checks only, no timings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs      # adds this checkout's src/ to sys.path
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention_bwd import (
        _sm_count, dkv_splits, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_plain)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[env] {card.strip()}; torch {torch.__version__}; kernels from "
          f"{build.CSRC}", flush=True)
    logs = build.build_all(("flash_attention", "flash_attention_bwd"))
    for line in logs.get("flash_attention_bwd", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []

    def held(what, fn):
        """``fn()``, a chip_smoke check; a failure is printed and counted,
        and the run goes on."""
        try:
            return fn()
        except SystemExit as e:
            print(f"[FAIL] {what}: {e}", flush=True)
            failed.append(what)
            return float("nan")

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Hq, Hkv, Sq, Skv, D), kw in cs._FLASH_BWD_SWEEP:
            kw = dict(kw)
            q_scale = kw.pop("q_scale", 1.0)
            q = cs._randn(gen, B, Hq, Sq, D, dtype=dtype) * q_scale
            k, v = (cs._randn(gen, B, Hkv, Skv, D, dtype=dtype)
                    for _ in range(2))
            do = cs._randn(gen, B, Hq, Sq, D, dtype=dtype)
            out, lse = flash_attention_fwd_plain(q, k, v, **kw)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
            for which in cs._bwd_variants(q, k, v, do):
                label = (f"q{(B, Hq, Sq, D)} kv{(B, Hkv, Skv, D)} {kw} "
                         f"x{q_scale:g} {dtype} [{which}]")
                got = flash_attention_bwd(q, k, v, out, lse, do, force=which,
                                          **kw)
                again = flash_attention_bwd(q, k, v, out, lse, do,
                                            force=which, **kw)
                torch.cuda.synchronize()
                err = max(held(f"{label} d{x}", lambda: cs.compare(
                    f"{label} d{x}", g, w, cs.TOL[dtype], of_max=True))
                          for x, g, w in zip("qkv", got, want))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    held(label, lambda: cs.fail(f"{label}: two runs differ"))
                print(f"[sweep] {label}: max_abs_err {err:.3g}", flush=True)
                n += 1
    print(f"[sweep] {n} runs, {len(failed)} failed", flush=True)

    F = torch.nn.functional
    sms = _sm_count(torch.cuda.current_device())
    for B, Hq, Hkv, S, Dh, label, window, causal, Skv in \
            cs._flash_train_shapes():
        Skv = Skv or S
        kw = dict(causal=causal, window=window)
        q, do = (cs._randn(gen, B, Hq, S, Dh) for _ in range(2))
        k, v = (cs._randn(gen, B, Hkv, Skv, Dh) for _ in range(2))
        out, lse = flash_attention_fwd_plain(q, k, v, **kw)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        shape = (f"q({B},{Hq},{S},{Dh}) kv({B},{Hkv},{Skv},{Dh}) "
                 f"{'causal' if causal else 'non-causal'}"
                 f"{f' window {window}' if window else ''} ({label})")
        for which in ("wgmma", "mma"):
            got = flash_attention_bwd(q, k, v, out, lse, do, force=which,
                                      **kw)
            again = flash_attention_bwd(q, k, v, out, lse, do, force=which,
                                        **kw)
            torch.cuda.synchronize()
            what = f"{shape} [{which}]"
            err = max(held(f"{what} d{x}", lambda: cs.compare(
                f"{what} d{x}", g, w, cs.TOL[torch.bfloat16], of_max=True))
                      for x, g, w in zip("qkv", got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                held(what, lambda: cs.fail(f"{what}: two runs differ"))
            print(f"[shapes] {shape} [{which}]: max_abs_err {err:.3g}, two "
                  f"runs equal", flush=True)
        del got, again, want
        if args.quick:
            continue
        pairs = cs._pairs(S, Skv=Skv, **kw)
        b_ms, b_by = cs.bound(2 * (4 * q.numel() + 4 * k.numel())
                              + 4 * lse.numel(), 10 * B * Hq * Dh * pairs)
        times = {"wgmma": [], "mma": []}
        for which in ("wgmma", "mma", "mma", "wgmma"):
            times[which].append(cs.cuda_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, do, force=which, **kw), iters=10))
        if window is None:
            lib_k, lib_v, lib_kw = k, v, dict(is_causal=causal,
                                              enable_gqa=True)
        else:
            mask, lib_k, lib_v = cs._window_sdpa(Hq, k, v, window)
            lib_kw = dict(attn_mask=mask)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, lib_k, lib_v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, **lib_kw)
        lib_ms = cs.cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do, retain_graph=True), iters=10)
        split = dkv_splits(B, Hq, Hkv, Skv, sms)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_attention_bwd(q, k, v, out, lse, do, force="wgmma",
                                    **kw)
            torch.cuda.synchronize()
        per = {name: sum(e.device_time_total for e in prof.key_averages()
                         if name in e.key) / 5
               for name in ("delta_kernel", "bwd_wgmma", "group_sum")}
        print(f"[shapes] {shape}: wgmma "
              f"{', '.join(f'{t:.3f}' for t in times['wgmma'])} ms, mma "
              f"{', '.join(f'{t:.3f}' for t in times['mma'])} ms, sdpa "
              f"backward {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
              f"dkv split {split}; device µs a call "
              f"{ {k: round(v, 1) for k, v in per.items()} }", flush=True)
        del q, k, v, do, out, lse, qs, ks, vs, o_lib
        torch.cuda.empty_cache()
    print(f"[done] {len(failed)} failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
