"""Sweep the block-reorder kernel's launch shape and a few code variants
on the card, at the (2,2) EP buffers of phi3.5-moe, against a plain
device-to-device copy of the same bytes.

Run on a machine with one CUDA card, from the repo root (about a
minute; it gates nothing):

    python3 tools/reorder_tune.py [--out FILE]

Each variant is a copy of ``csrc/block_reorder.cu`` with one constant or
one access changed (``VARIANTS``), built with the port's nvcc flags into
a temporary directory, all nvcc started together.  Every variant runs
through the port's own launch plan (``kernels/block_reorder._plan``) at
each grid size (``BLOCKS_PER_SM``) and largest chunk (``CHUNK_BYTES``),
on the pack of round 0 and the fused pass (0 -> 1) of the 64 MiB
``[moe_ep]`` and 80 MiB EP-prefill buffers (bf16, E_loc = 4, D = 4096,
C = 512 / 640); each output is checked bit for bit against the plain
version.  Times are CUDA-event means of 20 launches after a warm-up; the
yardsticks are ``Tensor.copy_`` of the whole buffer (the card's own
device-to-device copy) and the byte bound at 3.35 TB/s.  Prints the
rows, fastest first per buffer, and one JSON line.  Exits 2 without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
VARIANTS = {
    "ship": {},
    "unroll 4": {"kUnroll = 8;": "kUnroll = 4;"},
    "unroll 16": {"kUnroll = 8;": "kUnroll = 16;"},
    "512 threads": {"kThreads = 256;": "kThreads = 512;"},
    "streaming stores": {"*p = v;": "__stcs(p, v);"},
    "streaming loads and stores": {"return __ldg(p);": "return __ldcs(p);",
                                   "*p = v;": "__stcs(p, v);"},
}
BLOCKS_PER_SM = (1, 2, 4, 8)
CHUNK_MAX = (32768, 65536, 131072, 262144)


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


def build_variants(tmp: Path) -> dict:
    from repro_torch.kernels import build
    text = (build.CSRC / "block_reorder.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits.items():
            if old not in src:
                raise SystemExit(f"reorder_tune: {old!r} not in the source")
            src = src.replace(old, new)
        stem = name.replace(" ", "_")
        cu, so = tmp / f"{stem}.cu", tmp / f"lib{stem}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"reorder_tune: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_block_reorder
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reorder_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import block_reorder as br
    shipped = br.BLOCKS_PER_SM, br.CHUNK_BYTES[1]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(0)
        result = {"device": torch.cuda.get_device_name(0), "buffers": {}}
        for label, C in (("moe_ep", 512), ("prefill", 640)):
            x = torch.randn((4, 4 * C * 4096), generator=gen,
                            device="cuda").to(torch.bfloat16)
            out = torch.empty_like(x)
            nbytes = x.numel() * x.element_size()
            bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            rows = [{"variant": "Tensor.copy_ (whole buffer)",
                     "ms": cuda_ms(lambda: out.copy_(x))}]
            for key, plain in (
                    (((2, 2), None, 0, "natural", None, None),
                     br.datatype_pack_plain(x, dims=(2, 2), k=0,
                                            variant="natural")),
                    (((2, 2), 0, 1, "natural", None, None),
                     br.datatype_repack_plain(x, dims=(2, 2), k_unpack=0,
                                              k_pack=1, variant="natural"))):
                for per_sm in BLOCKS_PER_SM:
                    for chunk in CHUNK_MAX:
                        br.BLOCKS_PER_SM = per_sm
                        br.CHUNK_BYTES = (4096, chunk)
                        br._PLANS.clear()
                        plan = br._plan(x, key)
                        for name, fn in libs.items():
                            def run():
                                err = fn(x.data_ptr(), out.data_ptr(),
                                         plan[2], stream)
                                if err:
                                    raise SystemExit(f"launch failed {err}")
                            run()
                            if not torch.equal(out, plain):
                                raise SystemExit(
                                    f"reorder_tune: {name} {per_sm} "
                                    f"{chunk} differs from the plain version")
                            rows.append({"variant": name, "pass": key[1:3],
                                         "blocks_per_sm": per_sm,
                                         "chunk_max": chunk,
                                         "chunk": plan[1].chunk_bytes,
                                         "ms": cuda_ms(run)})
            for row in rows:
                row["of_bound"] = bound / row["ms"]
            rows.sort(key=lambda r: r["ms"])
            result["buffers"][label] = {"bytes": nbytes, "bound_ms": bound,
                                        "rows": rows}
            print(f"[reorder_tune] {label}: {nbytes / 2**20:.0f} MiB, bound "
                  f"{bound:.4f} ms; fastest first:", flush=True)
            for row in rows[:12] + [r for r in rows if r["variant"] == "ship"
                                    and (r["blocks_per_sm"],
                                         r["chunk_max"]) == shipped]:
                print(f"[reorder_tune]   {row['ms']:.4f} ms "
                      f"{100 * row['of_bound']:.1f}% {row['variant']} "
                      f"{row.get('pass', '')} blocks/SM "
                      f"{row.get('blocks_per_sm', '-')} chunk "
                      f"{row.get('chunk', '-')}", flush=True)
            del x, out
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line[:2000], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
