"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` runs a
bounded profiled window instead and reports the per-layer metrics, the
device's busy and window seconds and a breakdown.  Both judge the
program's outputs against the plain reference (``correct``).  The last
line of standard output is the result (one JSON object); the last lines
of standard error are the numbers compared, each beside its limit.

Exits non-zero, printing no result, where no card (or too few) is
found, where the program is missing, or where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _import_paths() -> None:
    """The checkout's root and ``src`` first; this folder itself off the
    path, so its modules never shadow a top-level module of that name."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


class MultiTrace:
    """The traces of a cell's cards read as one: device times summed, the
    busy and window seconds averaged over the cards."""

    def __init__(self, traces):
        self.traces = traces
        self.window_s = sum(t.window_s for t in traces) / len(traces)

    def device_seconds(self, patterns=None):
        return sum(t.device_seconds(patterns) for t in self.traces)

    def busy_s(self):
        return sum(t.busy_s() for t in self.traces) / len(self.traces)

    def top_ops(self, n=10):
        by = {}
        for t in self.traces:
            for name, s in t.top_ops(10 * n):
                by[name] = by.get(name, 0.0) + s / len(self.traces)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n=10):
        gaps = [[f"rank {r}: {what}", s] for r, t in enumerate(self.traces)
                for what, s in t.idle_gaps(n)]
        return sorted(gaps, key=lambda g: -g[1])[:n]


class Ctx:
    """What a per-layer reader gets: the cell, the traced window, the
    trace and the work counts of the window."""

    def __init__(self, cell, out):
        tr = out.get("trace")
        self.cell = cell
        self.trace = MultiTrace(tr) if isinstance(tr, list) else tr
        self.work = out.get("work", {})
        self.window_s = out.get("window_s")


def result_line(cell, out: dict, trace: bool) -> dict:
    from portbench.manifest import metric_reader
    from portbench.runtime import device_info
    import torch
    dev = device_info(torch.device("cuda"), cell.chips)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    metrics, extra = {}, {}
    if trace:
        ctx = Ctx(cell, out)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        extra["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                              "idle_gaps": ctx.trace.idle_gaps(10)}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    line.update(extra)
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _import_paths()
    from portbench import manifest
    from portbench.runtime import forbidden_modules
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"portbench.drivers.{cell.kind}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     start=START)
    line = result_line(cell, out, bool(args.trace))
    bad = sorted(set(forbidden_modules()) | set(out.get("forbidden", [])))
    if bad:
        print(f"[portbench] modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    info = {k: v for k, v in out["readings"].items() if k.startswith("_")}
    for key in ("plan", "requests", "window_s"):
        if key in out:
            info[key] = out[key]
    print(f"[portbench] {args.workload} seed {args.seed}: "
          f"{json.dumps(info, default=str)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
