"""The port's dry run (repro_torch.launch.dryrun) against the JAX
package, on the ``meta`` device with no world.

For every cell of ``configs/shapes.py`` on both production meshes
((data=16, model=16) and (pod=2, data=16, model=16)): the status and
skip reason equal the reference's ``applicable``; ``params_total`` /
``params_active`` equal what the reference's dry run records
(``param_count`` of its specs, ``param_count_estimate(active_only=
True)``); the per-device parameter bytes equal the reference's
``resolve_spec`` on its own specs and the production shape (it reads
only ``mesh.shape``, so a stand-in with a ``.shape`` dict serves and no
512-device JAX process is needed), with and without a ``--set
rules.<logical>=`` override.  ``main`` writes one JSON per cell to
``--out`` and nothing elsewhere.  ``repro.launch.dryrun`` itself is not
imported: importing it sets ``XLA_FLAGS``, which the pytest session must
not set (``tests/conftest.py``).
"""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import is_spec as jax_is_spec
from repro.models.common import param_count as jax_param_count
from repro.parallel.sharding import ShardingRules as JaxRules
from repro.parallel.sharding import resolve_spec as jax_resolve_spec
from repro_torch.configs import ARCH_NAMES, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_shape

MESHES = {"single": production_shape(), "multi":
          production_shape(multi_pod=True)}
CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]


def _jax_param_bytes(arch, shape, rules=None, itemsize=None):
    """Per-device parameter bytes by the reference's resolver on its own
    specs (each element ``itemsize`` bytes where given)."""
    import jax
    cfg = jax_get_config(arch)
    mesh = SimpleNamespace(shape=shape)
    total = 0
    for s in jax.tree.leaves(jax_build_model(cfg).specs(),
                             is_leaf=jax_is_spec):
        n = math.prod(s.shape)
        for part in jax_resolve_spec(s.shape, s.logical, mesh, rules):
            for a in (part,) if isinstance(part, str) else part or ():
                n //= shape[a]
        total += n * (itemsize or jnp.dtype(s.dtype or cfg.pdtype).itemsize)
    return total


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cell_matches_reference(arch, shape_name):
    jcfg = jax_get_config(arch)
    ok, reason = jax_applicable(jcfg, JAX_SHAPES[shape_name])
    for mesh_kind, shape in MESHES.items():
        rec = dryrun.run_cell(arch, shape_name, mesh_kind)
        assert (rec["arch"], rec["shape"], rec["mesh"]) == \
            (arch, shape_name, mesh_kind)
        if not ok:
            assert rec == {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "status": "skipped",
                           "reason": reason}
            continue
        assert rec["status"] == "ok" and rec["mesh_shape"] == shape
        assert rec["n_devices"] == math.prod(shape.values())
        assert rec["params_total"] == jax_param_count(
            jax_build_model(jcfg).specs())
        assert rec["params_active"] == jcfg.param_count_estimate(
            active_only=True)
        nb = rec["bytes_per_device"]
        assert nb["params"] == _jax_param_bytes(arch, shape)
        kind = SHAPES[shape_name].kind
        assert set(nb) == {"params", "inputs", "total"} | (
            {"opt_state"} if kind == "train" else
            {"caches"} if kind == "decode" else set())
        if kind == "train":            # f32 mu and nu, split alike
            assert nb["opt_state"] == 2 * _jax_param_bytes(arch, shape,
                                                           itemsize=4)
        assert nb["total"] == sum(v for k, v in nb.items() if k != "total")
        assert all(v > 0 for v in nb.values())
        assert bool(rec["a2a_plans"]) == bool(jcfg.n_experts)


@pytest.mark.parametrize("override,rule", [("rules.embed_fsdp=", "embed_fsdp"),
                                           ("rules.vocab=", "vocab"),
                                           ("rules.heads=data", "heads")])
def test_rule_overrides_match_reference(override, rule):
    axes = tuple(a for a in override.split("=", 1)[1].split("+") if a)
    for mesh_kind, shape in MESHES.items():
        rec = dryrun.run_cell("qwen2.5-3b", "train_4k", mesh_kind,
                              overrides=[override])
        want = _jax_param_bytes("qwen2.5-3b", shape,
                                JaxRules().override(**{rule: axes}))
        assert rec["bytes_per_device"]["params"] == want
        assert want != _jax_param_bytes("qwen2.5-3b", shape)


def test_config_overrides_parse():
    cfg, rules = dryrun.apply_overrides(
        dryrun.get_config("phi3.5-moe-42b"), None,
        ["capacity_factor=none", "a2a_backend=direct", "remat=false",
         "a2a_chunks=4", "rope_theta=5e5", "rules.batch=data"])
    assert (cfg.capacity_factor, cfg.a2a_backend, cfg.remat, cfg.a2a_chunks,
            cfg.rope_theta) == (None, "direct", False, 4, 5e5)
    assert rules.lookup("batch") == ("data",)
    rec = dryrun.run_cell("phi3.5-moe-42b", "train_4k", "multi",
                          overrides=["capacity_factor=none"])
    assert [p["kind"] for p in rec["a2a_plans"]] == ["ragged"]


def test_main_writes_one_json_per_cell_to_out(tmp_path):
    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    before = sorted(p for p in bench.rglob("*"))
    records = dryrun.main(["--all", "--out", str(tmp_path), "--tag", "t"])
    assert len(records) == len(CELLS) * len(MESHES)
    files = sorted(tmp_path.iterdir())
    assert len(files) == len(records)
    for rec in records:
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__t.json"
        assert json.loads((tmp_path / name).read_text()) == rec
    assert {r["status"] for r in records} == {"ok", "skipped"}
    assert sorted(p for p in bench.rglob("*")) == before
    assert dryrun.DEFAULT_OUT.name == "dryrun_out" and \
        "benchmarks" not in dryrun.DEFAULT_OUT.parts
