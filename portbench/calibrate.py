"""Readings that the limits of ``correct`` are set from, on the card at
the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds a,b,c,... \
        [--control N] [--seconds S]

For each seed: the program's numbers from a run with a short window
(the same drive and comparison as ``run.py``); for the first ``N`` seeds
of a prefill cell also the control's (the reference with float8
products put in the program's place, its first token read at every
position of the sampled prompts), judged by the cell's limits as the
program's are: one JSON line per reading on standard output, with
``correct``.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time

START = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from run import _import_paths
    _import_paths()
    import importlib
    from portbench import manifest
    from portbench.reference import model as ref
    from portbench.runtime import judge
    cell = manifest.cell(args.workload)
    drv = importlib.import_module(f"portbench.drivers.{cell.kind}")
    m = cell.config["model"]
    clean = lambda r: {k: v for k, v in r.items() if not k.startswith("_")
                       or k in ("_errs", "_errs_own", "_gaps", "_branches",
                                 "_router_margins")}

    def show(seed, who, r, **more):
        correct, _ = judge(r, cell.limits)
        print(json.dumps({"seed": seed, "who": who, "readings": clean(r),
                          "correct": correct, **more}), flush=True)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = drv.run(cell, seed, args.seconds, False,
                      start=time.perf_counter())
        show(seed, "program", out["readings"])
        if i >= args.control:
            continue
        if cell.kind == "prefill":
            chk = out["_check"]
            fp8 = ref.prefill_last_logits(m, seed, chk["prompts"], "cuda",
                                          precision="fp8")
            r = drv.readings([c[0][0] for c in fp8], chk["ref"])
            # a served model's control: its first token at every position
            r["token_gap"] = max(ref.control_gaps(m, seed, chk["prompts"],
                                                  "cuda"))
            show(seed, "control_fp8", r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
