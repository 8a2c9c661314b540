"""Expert-parallel MoE of the port on a 4-rank gloo world against the JAX
reference.

The world is a (data=2, pod=2) torus (the configuration of
tests/device_scripts/check_moe_ep.py without its "model" axis): every rank
holds its batch shard and its experts (``expert_shard``) and runs
``moe_block`` with the mesh, so dispatch and combine go through the
factorized all-to-all.  The reference is JAX's ``moe_block(mesh=None)`` on
the whole batch with the same weights (``init_params`` of the JAX package,
carried over as numpy): the outputs agree to 2e-4, the aux loss to 1e-3,
as in that script.  ``capacity_factor=8`` keeps every token.  Also covered:
experts replicated over the group (``n_experts=2`` < G = 4), the paper
variant, the direct, tuned and overlap backends (the overlap engine
pipelines dispatch, expert FFN and combine per capacity chunk), dropless
dispatch (``capacity_factor=None``: the ragged Alltoallv, and the sparse
one through ``_moe_inner``), ``a2a_backend="autotune"`` after a measured
search in the world (the plan replays the winner on every rank and
measures nothing), and a (data=2, model=2) mesh, where the experts' F is
split over "model" and the expert FFN's output summed over it.  The overlap, tuned and dropless cases are also held against the
JAX ``moe_block`` on the same (data=2, pod=2) mesh, run on 4 forced host
devices in a subprocess.
"""

import numpy as np
import pytest

from torch_dist import run_world

# name: (n_experts, a2a_backend, variant, capacity_factor); None = dropless
CASES = {
    "E4-factorized-natural": (4, "factorized", "natural", 8.0),
    "E8-factorized-natural": (8, "factorized", "natural", 8.0),
    "E2-factorized-natural": (2, "factorized", "natural", 8.0),  # replicas
    "E4-factorized-paper": (4, "factorized", "paper", 8.0),
    "E4-direct": (4, "direct", "natural", 8.0),
    "E2-direct": (2, "direct", "natural", 8.0),
    "E4-tuned": (4, "tuned", "natural", 8.0),
    "E4-overlap": (4, "overlap", "natural", 8.0),
    "E8-overlap-paper": (8, "overlap", "paper", 8.0),
    "E2-overlap": (2, "overlap", "natural", 8.0),
    "E4-dropless-tuned": (4, "tuned", "natural", None),
    "E8-dropless-overlap": (8, "overlap", "natural", None),
    "E2-dropless-factorized": (2, "factorized", "natural", None),
    "E4-dropless-sparse": (4, "factorized", "natural", None),
    "E4-autotune": (4, "autotune", "natural", 8.0),
    "E4-dropless-autotune": (4, "autotune", "natural", None),
}
SPARSE = "E4-dropless-sparse"      # dropless through the SparseA2APlan
MESH_CASES = [c for c in CASES if ("overlap" in c or "tuned" in c
              or "dropless" in c and c != SPARSE) and "autotune" not in c]
B, S, D = 8, 4, 32


def _cfg(module, n_experts, backend="factorized", variant="natural",
         capacity_factor=8.0):
    return module.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=n_experts, top_k=2,
        capacity_factor=capacity_factor, param_dtype="float32",
        compute_dtype="float32", a2a_backend=backend, a2a_variant=variant)


def _sparse_moe(p, xs, cfg, mesh):
    """The dropless layer with its collective forced to the sparse plan
    (the density choice picks the ragged one at this size)."""
    from repro_torch.core.cache import mesh_shape
    from repro_torch.core.comm import torus_comm
    from repro_torch.models import moe

    axes, G, E_loc, R = moe._group_geometry(cfg, mesh)
    B_, S_, _ = xs.shape
    C = moe._capacity(cfg, B_ * S_, max(cfg.n_experts, G))
    comm = moe.moe_ep_comm(cfg, mesh, axes)
    sparse = comm.sparse_all_to_all((cfg.d_model,), cfg.cdtype,
                                    max_count=E_loc * C, density=0.5)
    batch = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return moe._moe_inner(xs, p["router"], p["w1"][None], p["w3"][None],
                          p["w2"][None], cfg=cfg, G=G, E_loc=E_loc, R=R,
                          C=C, ragged_plan=sparse,
                          reduce_group=torus_comm(mesh, batch[::-1])
                          .fact.group)


def _autotune_searches(mesh, config, xs):
    """The measured searches ``a2a_backend="autotune"`` replays, run in
    the world before the cases: the dense one at the capacity path's
    block, the ragged-vs-sparse one at the dropless window and density.
    Returns the autotune counters afterwards."""
    import math
    from repro_torch.core.autotune import (autotune, autotune_ragged,
                                           autotune_stats)
    from repro_torch.models.moe import _capacity, _group_geometry
    N = xs.shape[0] * xs.shape[1]
    for cf in (8.0, None):
        cfg = _cfg(config, 4, "autotune", capacity_factor=cf)
        axes, G, E_loc, _ = _group_geometry(cfg, mesh)
        C = _capacity(cfg, N, max(cfg.n_experts, G))
        if cf is None:
            density = min(1.0, max(1e-6, 1.0 - math.exp(
                -cfg.top_k * N / G)))
            autotune_ragged(mesh, axes, (D,), cfg.cdtype,
                            max_count=E_loc * C, density=density, warmup=0,
                            repeats=1)
        else:
            autotune(mesh, axes, (E_loc, C, D), cfg.cdtype, warmup=0,
                     repeats=1, budget_seconds=60)
    return autotune_stats()


def _ep_ranks(rank, n, params, x, db_path):
    """Runs on every rank: each case's (y shard, aux), the refusals, and
    the autotune cases' plans."""
    import os

    import torch
    from repro_torch.core.autotune import autotune_stats
    from repro_torch.core.cache import cart_create
    from repro_torch.models import config
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        expert_shard, moe_a2a_plan,
                                        moe_block, moe_dropless_a2a_plan)

    os.environ["REPRO_TORCH_TUNING_DB"] = db_path
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type="cpu")
    xs = torch.from_numpy(x[rank * 2:(rank + 1) * 2])   # batch over (pod,
    out = {}                                              # data)
    searched = _autotune_searches(mesh, config, xs)
    for name, (E, backend, variant, cf) in CASES.items():
        cfg = _cfg(config, E, backend, variant, cf)
        p = expert_shard({k: torch.from_numpy(v) for k, v in
                          params[E].items()}, cfg, mesh)
        if name == SPARSE:
            y, aux = _sparse_moe(p, xs, cfg, mesh)
        else:
            y, aux = moe_block(p, xs, cfg, mesh=mesh)
        out[name] = (y.numpy(), float(aux))
    # the autotune cases' plans: what the DB hit built, and that the
    # replay measured nothing
    tuned = {"timing_executions": autotune_stats()["timing_executions"]
             - searched["timing_executions"]}
    N = xs.shape[0] * xs.shape[1]
    for cf in (8.0, None):
        cfg = _cfg(config, 4, "autotune", capacity_factor=cf)
        axes, G, E_loc, _ = _group_geometry(cfg, mesh)
        C = _capacity(cfg, N, max(cfg.n_experts, G))
        plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C) if cf else \
            moe_dropless_a2a_plan(cfg, mesh, axes, E_loc, C, N)
        tuned[cf] = (type(plan).__name__, plan.describe())
    from repro_torch.parallel.sharding import batch_split
    tp = cart_create(n, (2, 2), ("data", "model"), device_type="cpu")
    p = expert_shard({k: torch.from_numpy(v) for k, v in params[4].items()},
                     _cfg(config, 4), tp)
    blocks, i = batch_split(tp)                  # rows over data alone
    rows = x.shape[0] // blocks
    y, aux = moe_block(p, torch.from_numpy(x[i * rows:(i + 1) * rows]),
                       _cfg(config, 4), mesh=tp)
    return out, ((i, tuple(p["w1"].shape), y.numpy(), float(aux)), tuned)


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.models import config as jconfig
    from repro.models.common import init_params
    from repro.models.moe import moe_block, moe_specs

    x = np.random.default_rng(1).standard_normal((B, S, D)) \
        .astype(np.float32)
    params, refs = {}, {}
    for E, cf in sorted({(c[0], c[3] or 0) for c in CASES.values()}):
        cfg = _cfg(jconfig, E, capacity_factor=cf or None)
        p = init_params(moe_specs(cfg), jax.random.PRNGKey(E),
                        jnp.float32)
        params[E] = jax.tree.map(np.asarray, p)
        y, aux = moe_block(p, jnp.asarray(x), cfg, mesh=None)
        refs[E, cf or None] = (np.asarray(y), float(aux))
    tmp = tmp_path_factory.mktemp("ep")
    ranks = run_world(_ep_ranks, 4, tmp, params, x, str(tmp / "tuning.json"))
    return ranks, refs


@pytest.mark.parametrize("case", list(CASES))
def test_ep_moe_matches_reference(ep, case):
    ranks, refs = ep
    E, _, _, cf = CASES[case]
    y_ref, aux_ref = refs[E, cf]
    y = np.concatenate([out[case][0] for out, _ in ranks])
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    for out, _ in ranks:
        np.testing.assert_allclose(out[case][1], aux_ref, rtol=1e-3)


def test_unported_ep_paths_raise(ep):
    """A "model" axis runs: on (data=2, model=2) each rank holds 2 of the
    4 experts and half of F, the two "model" ranks of a row block give
    the same bits, and the row blocks match the one-process layer
    (y within 2e-4, aux within 1e-3).  ``a2a_backend="autotune"`` runs
    (its outputs are checked in test_ep_moe_matches_reference): every
    rank replays the same measured winners, and the replay times
    nothing."""
    ranks, refs = ep
    y_ref, aux_ref = refs[4, 8.0]
    by_block = {}
    for _, ((i, w1_shape, y, aux), _tuned) in ranks:
        assert w1_shape == (2, D, 32)
        if i in by_block:
            np.testing.assert_array_equal(y, by_block[i][0])
            assert aux == by_block[i][1]
        by_block[i] = (y, aux)
        np.testing.assert_allclose(aux, aux_ref, rtol=1e-3)
    assert sorted(by_block) == [0, 1]
    np.testing.assert_allclose(
        np.concatenate([by_block[i][0] for i in (0, 1)]), y_ref, rtol=2e-4,
        atol=2e-4)
    tuned = [t for _, (_, t) in ranks]
    assert all(t == tuned[0] for t in tuned)
    assert tuned[0]["timing_executions"] == 0
    kind, dense = tuned[0][8.0]
    assert kind == "A2APlan" and dense["tuned_from"] == "measured"
    assert dense["backend"] in ("direct", "factorized", "overlap")
    kind, dropless = tuned[0][None]
    assert kind in ("RaggedA2APlan", "SparseA2APlan")


_JAX_MESH_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.cache import cart_create
from repro.models import config
from repro.models.moe import moe_block

data = np.load(sys.argv[1])
cases, D = eval(sys.argv[2])
mesh = cart_create(4, (2, 2), ("data", "pod"))
x = jax.device_put(jnp.asarray(data["x"]),
                   NamedSharding(mesh, P(("pod", "data"))))
out = {}
for name, (E, backend, variant, cf) in cases.items():
    cfg = config.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=E, top_k=2,
        capacity_factor=cf, param_dtype="float32", compute_dtype="float32",
        a2a_backend=backend, a2a_variant=variant)
    p = {k: jnp.asarray(data[f"{E}_{k}"]) for k in ("router", "w1", "w3",
                                                   "w2")}
    y, aux = jax.jit(lambda p, x: moe_block(p, x, cfg, mesh=mesh))(p, x)
    out[f"{name}_y"] = np.asarray(y)
    out[f"{name}_aux"] = np.asarray(aux)
np.savez(sys.argv[3], **out)
"""


def test_ep_moe_matches_jax_on_the_mesh(ep, tmp_path):
    """The overlap, tuned and dropless cases against the JAX moe_block
    with the same (data=2, pod=2) mesh and weights."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import jax
    from repro.models import config as jconfig
    from repro.models.common import init_params
    from repro.models.moe import moe_specs

    ranks, _ = ep
    arrays = {"x": np.random.default_rng(1).standard_normal((B, S, D))
              .astype(np.float32)}
    for E in sorted({CASES[c][0] for c in MESH_CASES}):
        p = init_params(moe_specs(_cfg(jconfig, E)), jax.random.PRNGKey(E),
                        np.float32)
        arrays.update({f"{E}_{k}": np.asarray(v) for k, v in p.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    cases = {c: CASES[c] for c in MESH_CASES}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MESH_SCRIPT, str(tmp_path / "in.npz"),
         repr((cases, D)), str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_out = np.load(tmp_path / "out.npz")
    for case in MESH_CASES:
        y = np.concatenate([out[case][0] for out, _ in ranks])
        np.testing.assert_allclose(y, jax_out[f"{case}_y"], rtol=2e-4,
                                   atol=2e-4, err_msg=case)
        for out, _ in ranks:
            np.testing.assert_allclose(out[case][1],
                                       float(jax_out[f"{case}_aux"]),
                                       rtol=1e-3, err_msg=case)
