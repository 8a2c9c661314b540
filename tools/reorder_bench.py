"""Time the block-reorder passes of one (2,2) all-to-all on the card, for
this checkout's port or another checkout's, and split a decode-size
call's host time into its steps.

Run on a machine with one CUDA card, from the repo root (under a minute;
it gates nothing beyond bit-equality with the plain versions):

    python3 tools/reorder_bench.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so two versions of the port can be timed in
one call on one card (run them in turns: A, B, B, A).  The buffers are
phi3.5-moe's EP dispatch blocks on a (2,2) torus, bf16, E_loc = 4,
D = 4096: C = 512 (the ``[moe_ep]`` buffer, 64 MiB), C = 640 (EP
prefill, 80 MiB) and C = 4 (EP decode, 512 KiB).

For each buffer it times, with CUDA events (mean of 20 launches after a
warm-up), every pass one forward (rounds 0, 1) and one reverse (1, 0)
call makes: a port with ``datatype_repack`` runs
``core.factorized.round_schedule``'s passes, an older one the pack and
the unpack of both rounds.  It sums them per call and gives the byte
bound (each byte read and written once at 3.35 TB/s).  At the decode
buffer it also gives the host µs of a call enqueued back to back and the
median ns of each step of the wrapper's launch path.  It prints one JSON
line (and writes it to ``--out``).  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
E_LOC, D_MODEL = 4, 4096
BUFFERS = (("moe_ep", 512), ("prefill", 640), ("decode", 4))


def cuda_ms(fn, iters: int = 20) -> float:
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


def host_us(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / iters / 1e3


def passes(br):
    """(name, call, plain) of every pass of a forward and a reverse
    call, and which of them each call runs."""
    dims, v = (2, 2), "natural"
    if hasattr(br, "datatype_repack"):
        from repro_torch.core.factorized import round_schedule
        out, calls = {}, {}
        for order in ((0, 1), (1, 0)):
            calls[order] = []
            for ku, kp in round_schedule(dims, order, v):
                if ku is None:
                    kw = dict(dims=dims, k=kp, variant=v)
                    fns = (br.datatype_pack, br.datatype_pack_plain)
                elif kp is None:
                    kw = dict(dims=dims, k=ku, variant=v)
                    fns = (br.datatype_unpack, br.datatype_unpack_plain)
                else:
                    kw = dict(dims=dims, k_unpack=ku, k_pack=kp, variant=v)
                    fns = (br.datatype_repack, br.datatype_repack_plain)
                name = f"{fns[0].__name__[9:]} {(ku, kp)}"
                out[name] = (fns, kw)
                calls[order].append(name)
        return out, calls
    out = {}
    for k in (0, 1):
        out[f"pack {k}"] = ((br.datatype_pack, br.datatype_pack_plain),
                            dict(dims=dims, k=k, variant=v))
        out[f"unpack {k}"] = ((br.datatype_unpack,
                               br.datatype_unpack_plain),
                              dict(dims=dims, k=k, variant=v))
    return out, {order: list(out) for order in ((0, 1), (1, 0))}


def host_steps(br, x, iters: int = 200) -> dict:
    """Median ns of each step of a decode-size pack's launch path, the
    wrapper's own steps done one by one (the library call included)."""
    from repro_torch.kernels import build
    dims, k, v = (2, 2), 0, "natural"
    steps: dict = {}

    def note(name, t0):
        t1 = time.perf_counter_ns()
        steps.setdefault(name, []).append(t1 - t0)
        return t1

    for _ in range(iters):
        if hasattr(br, "_PLANS"):
            key = ((2, 2), None, k, v, None, None)
            t = time.perf_counter_ns()
            plan = br._PLANS.get((key, x.shape, x.dtype, x.device))
            if plan is None:
                plan = br._plan(x, key)
            t = note("plan lookup", t)
            out = torch.empty_like(x)
            t = note("empty_like", t)
            fn, stream_of = br._kernel()
            t = note("kernel fn", t)
            stream = stream_of(plan[3])
            t = note("current stream", t)
            err = fn(x.data_ptr(), out.data_ptr(), plan[2], stream)
            note("ctypes call (launch)", t)
        else:
            t = time.perf_counter_ns()
            sigma, Dk, sizes, strides = br._check(x, dims, k, v)
            t = note("_check / round_tiles", t)
            out = torch.empty_like(x)
            t = note("empty_like", t)
            tile_bytes = sigma * x.shape[1] * x.element_size()
            size_arr = (ctypes.c_longlong * br.MAX_DIMS)(*sizes)
            stride_arr = (ctypes.c_longlong * br.MAX_DIMS)(*strides)
            t = note("ctypes arrays", t)
            fn = build.load("block_reorder").repro_block_reorder
            fn.argtypes, fn.restype = br._ARGTYPES, ctypes.c_int
            t = note("load, argtypes", t)
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                t = note("device context, current_stream", t)
                err = fn(x.data_ptr(), out.data_ptr(), tile_bytes, Dk,
                         math.prod(sizes), len(sizes), size_arr,
                         stride_arr, 0, stream)
                t = note("ctypes call (launch)", t)
            note("device context exit", t)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    torch.cuda.synchronize()
    return {name: statistics.median(ns) for name, ns in steps.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reorder_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import block_reorder as br
    from repro_torch.kernels import build
    build.build_all(["block_reorder"])
    smi = torch.cuda.get_device_name(0)
    result = {"label": args.label, "src": args.src, "device": smi,
              "buffers": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    table, calls = passes(br)
    for name, C in BUFFERS:
        x = torch.randn((4, E_LOC * C * D_MODEL), generator=gen,
                        device="cuda").to(torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        row = {"bytes": nbytes, "bound_ms": 2 * nbytes / HBM_BYTES_PER_S
               * 1e3, "passes": {}}
        for pname, ((fn, plain), kw) in table.items():
            got, want = fn(x, **kw), plain(x, **kw)
            if not torch.equal(got, want):
                raise SystemExit(f"reorder_bench: {pname} at {name} "
                                 f"differs from its plain version")
            entry = {"ms": cuda_ms(lambda: fn(x, **kw))}
            if name == "decode":
                entry["host_us"] = host_us(lambda: fn(x, **kw))
            row["passes"][pname] = entry
        row["call_ms"] = {str(o): sum(row["passes"][p]["ms"] for p in ps)
                          for o, ps in calls.items()}
        if name == "decode":
            row["host_steps_ns"] = host_steps(br, x)
        result["buffers"][name] = row
        print(f"[reorder_bench] {args.label} {name} ({nbytes / 2**20:.1f} "
              f"MiB, bound {row['bound_ms']:.4f} ms): "
              + "; ".join(f"{p} {e['ms']:.4f} ms"
                          + (f" (host {e['host_us']:.1f} us)"
                             if "host_us" in e else "")
                          for p, e in row["passes"].items())
              + f"; per call {row['call_ms']}", flush=True)
        if name == "decode":
            print(f"[reorder_bench] {args.label} decode host steps (median "
                  f"ns): {row['host_steps_ns']}", flush=True)
        del x
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
