"""The manifest's schema, and that a cell, mix or metric added as files
alone is found by name."""

import json
import shutil

import pytest

from portbench import manifest


def test_manifest_meets_schema():
    assert manifest.check_manifest(manifest.load_manifest()) == []


@pytest.mark.parametrize("name,ok", [
    ("phi35moe-train", True), ("gmm_roofline.train", True),
    ("3d", True), ("_x", True), ("has space", False), ("a,b", False),
    ("a/b", False), (".dot", False), ("x" * 65, False), ("μs", False)])
def test_names(name, ok):
    assert bool(manifest.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("tokens/s", True), ("%", True), ("GB/s", True), ("us", True),
    ("ms", True), ("tokens per second", False), ("µs", False)])
def test_units(unit, ok):
    assert bool(manifest.UNIT.match(unit)) is ok


def test_every_moves_target_reported_where_its_metric_is():
    m = manifest.load_manifest()
    for w in m["workloads"]:
        c = manifest.cell(w["name"], m)
        e2e = {e["name"] for e in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for p in c.per_layer:
            assert p["moves"] in e2e, (w["name"], p["name"])


def test_schema_catches_a_bad_entry():
    m = manifest.load_manifest()
    bad = json.loads(json.dumps(m))
    bad["per_layer"][0]["moves"] = "a2a_GBps"
    bad["end_to_end"][0]["bound"] = 0.5
    bad["workloads"][0]["why"] = ""
    found = manifest.check_manifest(bad)
    assert len(found) >= 3


def test_files_added_alone_are_found(tmp_path, monkeypatch):
    """A new configuration, traffic mix, limits and per-layer reader,
    added as files with their manifest entries, are found by name with
    no edit to an existing file."""
    root = tmp_path / "repo"
    bench = root / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(manifest.HERE / sub, bench / sub)
    m = manifest.load_manifest()
    cfg = json.loads((manifest.HERE / "configs" / "grok-1-314b.json")
                     .read_text())
    cfg["model"]["n_layers"] = 2
    (bench / "configs" / "grok-1-314b-d2.json").write_text(json.dumps(cfg))
    mix = json.loads((manifest.HERE / "traffic" / "prefill-lognormal-1k.json")
                     .read_text())
    mix["lengths"]["median"] = 4096
    (bench / "traffic" / "prefill-lognormal-4k.json").write_text(
        json.dumps(mix))
    (bench / "limits" / "grok1-prefill-4k.json").write_text(
        (manifest.HERE / "limits" / "grok1-prefill.json").read_text())
    (bench / "metrics" / "new_metric.prefill.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "grok-1-314b-d2", "source": "https://x.y",
                         "file": "portbench/configs/grok-1-314b-d2.json",
                         "reduced": ["num_layers"], "why": "test"})
    m["workloads"].append({"name": "grok1-prefill-4k",
                           "config": "grok-1-314b-d2",
                           "traffic": "prefill-lognormal-4k", "chips": 1,
                           "why": "test"})
    for e in m["end_to_end"]:
        if e.get("workloads") == ["grok1-prefill"]:
            e["workloads"].append("grok1-prefill-4k")
    m["per_layer"].append({"name": "new_metric.prefill", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels",
                           "moves": "prefill_tokens_per_s",
                           "workloads": ["grok1-prefill-4k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(manifest, "HERE", bench)
    assert manifest.check_manifest(m, root) == []
    c = manifest.cell("grok1-prefill-4k", root=root)
    assert c.kind == "prefill"
    assert c.config["model"]["n_layers"] == 2
    assert c.traffic["lengths"]["median"] == 4096
    assert "new_metric.prefill" in [p["name"] for p in c.per_layer]
    assert manifest.metric_reader("new_metric.prefill")(None) == 42.0
