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
variant, the direct and tuned backends, and the refusals (overlap, a
"model" axis).
"""

import numpy as np
import pytest

from torch_dist import run_world

CASES = {
    "E4-factorized-natural": (4, "factorized", "natural"),
    "E8-factorized-natural": (8, "factorized", "natural"),
    "E2-factorized-natural": (2, "factorized", "natural"),   # replicas
    "E4-factorized-paper": (4, "factorized", "paper"),
    "E4-direct": (4, "direct", "natural"),
    "E2-direct": (2, "direct", "natural"),
    "E4-tuned": (4, "tuned", "natural"),
}
B, S, D = 8, 4, 32


def _cfg(module, n_experts, backend="factorized", variant="natural"):
    return module.ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=100, n_experts=n_experts, top_k=2,
        capacity_factor=8.0, param_dtype="float32",
        compute_dtype="float32", a2a_backend=backend, a2a_variant=variant)


def _ep_ranks(rank, n, params, x):
    """Runs on every rank: each case's (y shard, aux), and the refusals."""
    import torch
    from repro_torch.core.cache import cart_create
    from repro_torch.models import config
    from repro_torch.models.moe import expert_shard, moe_block

    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type="cpu")
    xs = torch.from_numpy(x[rank * 2:(rank + 1) * 2])   # batch over (pod,
    out = {}                                              # data)
    for name, (E, backend, variant) in CASES.items():
        cfg = _cfg(config, E, backend, variant)
        p = expert_shard({k: torch.from_numpy(v) for k, v in
                          params[E].items()}, cfg, mesh)
        y, aux = moe_block(p, xs, cfg, mesh=mesh)
        out[name] = (y.numpy(), float(aux))
    refusals = []
    p = expert_shard({k: torch.from_numpy(v) for k, v in params[4].items()},
                     _cfg(config, 4), mesh)
    try:
        moe_block(p, xs, _cfg(config, 4, "overlap"), mesh=mesh)
    except NotImplementedError as e:
        refusals.append(str(e))
    tp = cart_create(n, (2, 2), ("data", "model"), device_type="cpu")
    try:
        moe_block(p, xs, _cfg(config, 4), mesh=tp)
    except NotImplementedError as e:
        refusals.append(str(e))
    return out, refusals


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
    for E in sorted({c[0] for c in CASES.values()}):
        cfg = _cfg(jconfig, E)
        p = init_params(moe_specs(cfg), jax.random.PRNGKey(E),
                        jnp.float32)
        params[E] = jax.tree.map(np.asarray, p)
        y, aux = moe_block(p, jnp.asarray(x), cfg, mesh=None)
        refs[E] = (np.asarray(y), float(aux))
    ranks = run_world(_ep_ranks, 4, tmp_path_factory.mktemp("ep"), params,
                      x)
    return ranks, refs


@pytest.mark.parametrize("case", list(CASES))
def test_ep_moe_matches_reference(ep, case):
    ranks, refs = ep
    y_ref, aux_ref = refs[CASES[case][0]]
    y = np.concatenate([out[case][0] for out, _ in ranks])
    np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
    for out, _ in ranks:
        np.testing.assert_allclose(out[case][1], aux_ref, rtol=1e-3)


def test_unported_ep_paths_raise(ep):
    ranks, _ = ep
    for _, refusals in ranks:
        assert len(refusals) == 2
        assert "queue 1 item 6" in refusals[0]
        assert "model" in refusals[1] and "ROADMAP" in refusals[1]
