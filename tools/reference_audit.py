#!/usr/bin/env python3
"""What the JAX reference does at the inputs of the port's parity cases
for the sharding rules and paths it once refused (ROADMAP.md §3 records
the answers; ``tests/test_torch_rules_mesh.py``,
``tests/test_torch_overlap.py`` and ``tests/test_torch_ep_autograd.py``
hold the port against the reference there).

Runs the JAX package alone, on 8 forced host CPU devices, and prints one
line per input: whether the reference computes it and, for the training
inputs, its loss and worst gradient leaf (largest |diff| over the leaf's
largest |g|) against the same model on one device.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tools/reference_audit.py      # ~1 min

The inputs, on (pod 2, data 2, model 2) with a 2-layer d-32 model:
EP axes outside the batch rule (``batch=data``, the MoE's EP over data
and pod); FSDP outside the batch rule and an FSDP rule over ``model``
(dense); FSDP over several axes (``vocab=data``: the embedding keeps
``pod``, the other leaves ``pod, data``); and, on a (2,2) torus, the
overlap engine's compute stage with ``reverse=False`` under
``jax.grad``, against the factorized composition.  The sixth path, a
survivor mesh with a dim other than the EP dims above 1
(``launch.mesh.survivor_mesh``), needs no run: the reference's own
elastic check recovers onto a (data 4, model 2) mesh
(``tests/device_scripts/check_rebuild.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core.cache import cart_create
from repro.core.plan import plan_all_to_all
from repro.models import build_model, config, make_loss_fn
from repro.models.common import param_shardings
from repro.parallel.sharding import ShardingRules

BASE = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, n_experts=4, top_k=2,
            capacity_factor=8.0, param_dtype="float32",
            compute_dtype="float32", a2a_backend="factorized")
DENSE = dict(family="dense", n_experts=0)


def training_case(tag, mesh, tokens, fields, **rule_kw):
    cfg = config.ModelConfig(**{**BASE, **fields})
    model = build_model(cfg)
    rules = ShardingRules().override(**rule_kw)
    params = model.init(jax.random.PRNGKey(1))
    grad = lambda m, r: jax.jit(jax.value_and_grad(make_loss_fn(model, m, r),
                                                   has_aux=True))
    (l1, _), g1 = grad(None, None)(params, tokens)
    try:
        sharded = jax.device_put(params, param_shardings(model.specs(),
                                                         mesh, rules))
        (l2, _), g2 = grad(mesh, rules)(sharded, tokens)
    except Exception as e:  # noqa: BLE001 - the answer is the failure
        print(f"{tag}: fails, {type(e).__name__}: {str(e)[:300]}")
        return
    worst = max(float(jnp.abs(a - b).max() / (jnp.abs(a).max() + 1e-30))
                for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)))
    print(f"{tag}: computes; loss {float(l2):.6f} (one device "
          f"{float(l1):.6f}); worst gradient leaf {worst:.2e}")


def overlap_case(rng):
    mesh = cart_create(4, (2, 2), ("a", "b"))
    kw = dict(block_shape=(6,), dtype=jnp.float32)
    over = plan_all_to_all(mesh, ("a", "b"), backend="overlap", n_chunks=2,
                           **kw)
    fac = plan_all_to_all(mesh, ("a", "b"), backend="factorized", **kw)

    def run(f):
        return jax.shard_map(lambda xl: f(xl[0])[None], mesh=mesh,
                             in_specs=P(("b", "a")), out_specs=P(("b", "a")))
    x = jnp.asarray(rng.standard_normal((4, 4, 6)), jnp.float32)
    stage = lambda c, i=0: jnp.sin(c) * 2.0
    g_over = jax.grad(lambda x: (run(lambda xl: over.overlap(
        xl, stage, reverse=False))(x) ** 2).sum())(x)
    g_comp = jax.grad(lambda x: (run(lambda xl: stage(fac.forward(xl)))(x)
                                 ** 2).sum())(x)
    print(f"overlap(compute_fn, reverse=False) under jax.grad on (2,2): "
          f"computes; largest |gradient - the composition's| "
          f"{float(jnp.abs(g_over - g_comp).max()):.2e}")


def main():
    mesh = cart_create(8, (2, 2, 2), ("model", "data", "pod"))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, 127, (8, 16)), jnp.int32),
             "labels": jnp.asarray(rng.integers(0, 127, (8, 16)), jnp.int32),
             "mask": jnp.ones((8, 16), jnp.float32)}
    training_case("EP axes outside the batch rule (batch=data)", mesh, batch,
                  {}, batch=("data",))
    training_case("FSDP outside the batch rule (dense, batch=data)", mesh,
                  batch, DENSE, batch=("data",))
    training_case("an FSDP rule over model (dense, embed_fsdp=model)", mesh,
                  batch, DENSE, embed_fsdp=("model",))
    training_case("FSDP over several axes (dense, vocab=data)", mesh, batch,
                  DENSE, vocab=("data",))
    overlap_case(rng)


if __name__ == "__main__":
    main()
