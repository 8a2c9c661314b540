"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<config>.json`` (the file the manifest's
  ``file`` names): the model as run (``model``: the port's
  ``ModelConfig`` fields), its source and its cuts;
* a traffic mix: ``traffic/<traffic>.json``: parameters that the one
  generator (``traffic.py``) and the driver of its ``kind``
  (``drivers/<kind>.py``) read;
* a cell's limits: ``limits/<cell>.json``: each number that decides
  ``correct``, with its limit and the readings it was set from;
* a per-layer metric: ``metrics/<metric>.py`` with ``read(ctx)``.

A later change adds a cell, a mix or a metric by adding such files and an
entry in ``BENCHMARK.json``; no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest with everything it names."""
    name: str
    chips: int
    config: dict          # the configuration file's content
    traffic: dict         # the traffic file's content
    limits: dict          # the limits file's content
    end_to_end: tuple     # the manifest's end-to-end entries of this cell
    per_layer: tuple      # the manifest's per-layer entries of this cell

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _in_cell(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell (an end-to-end metric) or every cell that
    reports the metric it ``moves`` (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    m = manifest if manifest is not None else load_manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = tuple(e for e in m["end_to_end"] if _in_cell(e, name))
    names = {e["name"] for e in e2e}
    per = tuple(p for p in m["per_layer"] if _in_cell(p, name, names))
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((Path(root) / cfg_entry["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per)


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_manifest(m: dict, root: Path = ROOT) -> list[str]:
    """What in ``m`` breaks the benchmark's schema (empty: nothing)."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    for key in ("command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"):
        need(key in m, f"missing key {key}")
    need(set(m) == {"command", "paths", "run_seconds", "configs",
                    "workloads", "end_to_end", "per_layer"},
         f"extra keys {sorted(set(m) - {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'})}")
    need(isinstance(m.get("run_seconds"), int)
         and 1 <= m["run_seconds"] <= 51, "run_seconds out of 1..51")
    names = [c["name"] for c in m["configs"]] \
        + [w["name"] for w in m["workloads"]] \
        + [e["name"] for e in m["end_to_end"]] \
        + [p["name"] for p in m["per_layer"]]
    for n in names:
        need(bool(NAME.match(n)), f"bad name {n!r}")
    metric_names = [e["name"] for e in m["end_to_end"]] \
        + [p["name"] for p in m["per_layer"]]
    need(len(set(metric_names)) == len(metric_names), "duplicate metric")
    need(len({w["name"] for w in m["workloads"]}) == len(m["workloads"]),
         "duplicate workload")
    files = [c["file"] for c in m["configs"]]
    need(len(set(files)) == len(files), "two configs share a file")
    for c in m["configs"]:
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config {c['name']} keys {sorted(c)}")
        need(any(c["file"].startswith(p.rstrip("/") + "/")
                 for p in m["paths"]), f"{c['file']} outside paths")
        need((Path(root) / c["file"]).is_file(), f"missing {c['file']}")
        need(len(c["reduced"]) <= 16, f"{c['name']}: reduced > 16")
        for k in c["reduced"]:
            need(bool(NAME.match(k)), f"bad reduced key {k!r}")
            need(not (k.endswith("_dim") or k.endswith("_rank")
                      or "size" in k or "heads" in k),
                 f"{c['name']}: reduced names a width ({k})")
        need(any(w["config"] == c["name"] for w in m["workloads"]),
             f"config {c['name']} unused")
    pairs = set()
    for w in m["workloads"]:
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"workload {w['name']} keys {sorted(w)}")
        need(w["chips"] in (1, 4), f"{w['name']}: chips {w['chips']}")
        need(1 <= len(w["why"]) <= 200, f"{w['name']}: why length")
        need((w["config"], w["traffic"]) not in pairs,
             f"{w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        need((HERE / "traffic" / f"{w['traffic']}.json").is_file(),
             f"missing traffic {w['traffic']}")
        need((HERE / "limits" / f"{w['name']}.json").is_file(),
             f"missing limits of {w['name']}")
    four = sum(w["chips"] == 4 for w in m["workloads"])
    need(four <= max(1, len(m["workloads"]) // 4), "too many 4-chip cells")
    need(any(e["name"] == "setup_s" for e in m["end_to_end"]),
         "no setup_s")
    for e in m["end_to_end"]:
        need(set(e) <= {"name", "unit", "better", "bound", "source",
                        "workloads"}, f"{e['name']} keys")
        need(e["source"] in ("host_clock", "device_trace"),
             f"{e['name']}: source {e['source']}")
        need(0.01 <= e["bound"] <= 0.25, f"{e['name']}: bound {e['bound']}")
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for p in m["per_layer"]:
        need(set(p) <= {"name", "unit", "better", "source", "layer", "moves",
                        "workloads"}, f"{p['name']} keys")
        need(p["source"] in SOURCES, f"{p['name']}: source")
        need(p["moves"] in e2e, f"{p['name']}: moves {p['moves']}")
        need((HERE / "metrics" / f"{p['name']}.py").is_file(),
             f"missing reader of {p['name']}")
        target = e2e.get(p["moves"], {})
        for w in p.get("workloads", [w["name"] for w in m["workloads"]]):
            need("workloads" not in target or w in target["workloads"],
                 f"{p['name']}: {w} does not report {p['moves']}")
    for metric in list(m["end_to_end"]) + list(m["per_layer"]):
        need(bool(UNIT.match(metric["unit"])), f"bad unit {metric['unit']}")
        need(metric["better"] in ("lower", "higher"), "better")
    for w in m["workloads"]:
        reported = [e for e in m["end_to_end"]
                    if "workloads" not in e or w["name"] in e["workloads"]]
        need(len(reported) >= 2, f"{w['name']}: needs setup_s and another")
        need(any(w["name"] in p.get("workloads", [w["name"]])
                 for p in m["per_layer"]), f"{w['name']}: no per-layer")
    return bad
