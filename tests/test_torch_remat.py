"""The remat policies of the port (``models.remat``: ``nothing``, ``dots``,
``collectives``) against ``remat=False`` and against the JAX reference.

Two configs, each on the reference's weights carried over by
``params_from_jax`` and one numpy copy-task batch: the SMOKE size of
phi3.5-moe-42b (2 layers, d 64, 4 experts, f32) and a dense 2-layer model
(d 32, f32).  For each policy:

* the loss and every gradient leaf equal the port's ``remat=False`` bit
  for bit (a policy moves memory and recompute, never a value);
* they match ``jax.value_and_grad`` of the reference under the same
  ``remat_policy`` (``attention_impl="xla"``), at ``test_torch_train``'s
  tolerances: the loss at 1e-5 relative, each leaf within 2e-4 of its
  largest |g|.

Under ``dots`` the backward's recompute runs none of the kept products
(counted at ``models.remat._product``, the one place a ``dot`` multiplies)
and still runs the grouped matmul and the attention forward (counted at
the kernel modules); under ``nothing`` it runs every product again.  A
forward without grad (serving) takes no remat under any policy.  The MoE
exchanges that ``collectives`` keeps need a mesh:
``tests/test_torch_elastic.py`` counts them on a 4-rank world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.data import CopyTaskConfig, make_copy_task_batch
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import moe_gmm
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import remat
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import params_from_jax

POLICIES = ("nothing", "dots", "collectives")
ARCH = "phi3.5-moe-42b"


def _dense(module):
    return module(name="tiny", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                  param_dtype="float32", compute_dtype="float32")


CONFIGS = {
    "moe": (lambda: jax_get_config(ARCH, smoke=True),
            lambda: get_config(ARCH, smoke=True)),
    "dense": (lambda: _dense(JaxModelConfig), lambda: _dense(ModelConfig)),
}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, (jcfg, _) in CONFIGS.items():
        out[name] = jax_build_model(jcfg().replace(
            attention_impl="xla")).init(jax.random.PRNGKey(0))
    return out


def _batch(vocab):
    b = make_copy_task_batch(CopyTaskConfig(vocab=vocab, seq_len=16,
                                            global_batch=2), 1)
    return {k: v.numpy() for k, v in b.items()}


def _port_grads(cfg, jparams, batch):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    leaves = tree_leaves(params)
    total, _ = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, [t for _, t in leaves])
    return total, {p: g for (p, _), g in zip(leaves, grads)}


_BASE: dict = {}


def _base(name, jparams):
    """The port's remat=False loss and gradients of a config."""
    if name not in _BASE:
        cfg = CONFIGS[name][1]().replace(remat=False)
        _BASE[name] = _port_grads(cfg, jparams, _batch(cfg.vocab))
    return _BASE[name]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_policy_matches_no_remat_and_reference(weights, name, policy):
    jparams = weights[name]
    jcfg = CONFIGS[name][0]().replace(attention_impl="xla", remat=True,
                                      remat_policy=policy)
    cfg = CONFIGS[name][1]().replace(remat=True, remat_policy=policy)
    batch = _batch(cfg.vocab)
    total, grads = _port_grads(cfg, jparams, batch)
    t0, g0 = _base(name, jparams)
    assert torch.equal(total, t0)
    for path, g in g0.items():
        assert torch.equal(grads[path], g), path

    (want, _), wg = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    want_g = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    assert set(grads) == set(want_g)
    for path, g in grads.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=path)


@pytest.mark.parametrize("policy", ("nothing", "dots"))
def test_dots_recompute_skips_the_kept_products(weights, monkeypatch,
                                                policy):
    cfg = CONFIGS["moe"][1]().replace(remat=True, remat_policy=policy)
    params = params_from_jax(jax.tree.map(np.asarray, weights["moe"]), cfg,
                             "cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    calls = {"dot": 0, "gmm": 0, "fwd": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(remat, "_product", counting(remat._product, "dot"))
    monkeypatch.setattr(moe_gmm, "grouped_matmul",
                        counting(moe_gmm.grouped_matmul, "gmm"))
    monkeypatch.setattr(fab, "flash_attention_fwd",
                        counting(fab.flash_attention_fwd, "fwd"))
    leaves = tree_leaves(params)
    total, _ = build_model(cfg).loss(params, batch)
    forward = dict(calls)
    torch.autograd.grad(total, [t for _, t in leaves])
    backward = {k: calls[k] - forward[k] for k in calls}
    n = cfg.n_layers
    # per layer: q, k, v, o and the router (the head's product is outside
    # the superblock and no dot); 3 gmm and one attention forward
    assert forward == {"dot": 5 * n, "gmm": 3 * n, "fwd": n}
    # the backward: the recompute (3 gmm, one attention forward, and
    # under "nothing" the 5 products) and the 6 gmm of the gmm backward
    assert backward == {"dot": 5 * n * (policy == "nothing"),
                        "gmm": (3 + 6) * n, "fwd": n}


@pytest.mark.parametrize("policy", POLICIES)
def test_serving_takes_no_remat(weights, policy):
    cfg = CONFIGS["moe"][1]().replace(remat=True, remat_policy=policy)
    params = params_from_jax(jax.tree.map(np.asarray, weights["moe"]), cfg,
                             "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    with torch.no_grad():
        total, _ = build_model(cfg).loss(params, batch)
    assert torch.equal(total, _base("moe", weights["moe"])[0])


def test_unknown_policy_raises(weights):
    cfg = CONFIGS["dense"][1]().replace(remat=True, remat_policy="all")
    with pytest.raises(ValueError, match="remat_policy"):
        _port_grads(cfg, weights["dense"], _batch(cfg.vocab))
