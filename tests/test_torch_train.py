"""The port's training path (repro_torch) against the JAX reference.

``Model.loss`` and the gradient of every leaf, the remat forward, the
train step with AdamW, AdamW itself, the schedules and transforms, and
the synthetic data.  Both packages run the SMOKE size of phi3.5-moe-42b
(2 layers, d=64, 4 experts, f32) on the reference's weights, carried over
by ``params_from_jax``; batches come from numpy.  The reference runs with
``attention_impl="xla"`` (autodiff of its oracles); the port on the CPU
runs its kernels' plain versions inside ``FlashAttentionFn`` /
``GroupedMatmulFn``, so the gradients come from the port's own backward
formulas.  Router inputs are random f32, so no two probabilities tie.

Tolerances: the loss at 1e-5 relative; each gradient leaf within 2e-4 of
its largest |g| (f32 sums in another order, through two layers of O(100)
activations); after 3 AdamW steps the losses at 1e-4 and the parameters
within 10 lr, because AdamW's first steps turn the sign noise of
gradients near 0 into whole lr-sized steps; one AdamW update from the
same state at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import make_copy_task_batch as jax_copy_batch
from repro.models import build_model as jax_build_model
from repro.models import make_train_step as jax_make_train_step
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import constant as jax_constant
from repro.optim import cosine_with_warmup as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro.optim import linear_warmup as jax_linear_warmup
from repro_torch.configs import get_config
from repro_torch.data import (CopyTaskConfig, DataConfig, SyntheticLM,
                              make_copy_task_batch, make_lm_batch)
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import moe_gmm
from repro_torch.models import ModelConfig, build_model, make_train_step
from repro_torch.models import moe
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import (AdamW, AdamWConfig, clip_by_global_norm,
                               constant, cosine_with_warmup, global_norm,
                               linear_warmup)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "phi3.5-moe-42b"


def _configs(**kw):
    jcfg = jax_get_config(ARCH, smoke=True).replace(attention_impl="xla",
                                                    **kw)
    return jcfg, get_config(ARCH, smoke=True).replace(**kw)


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _configs()
    return jax_build_model(jcfg).init(jax.random.PRNGKey(0))


def _port_params(jparams, cfg):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return tree_map(lambda t: t.requires_grad_(True), params)


def _batch(vocab, step=0, B=2, S=16):
    """A copy-task batch as numpy arrays (fed to both packages)."""
    b = make_copy_task_batch(CopyTaskConfig(vocab=vocab, seq_len=S,
                                            global_batch=B), step)
    return {k: v.numpy() for k, v in b.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    total, metrics = model.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(total, [t for _, t in leaves])
    return total, metrics, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0],
                         ids=["drops", "no_drops"])
def test_loss_and_grads_match_reference(jparams, capacity_factor):
    # 32 tokens on 4 experts, top-2: at factor 0.5 each expert takes 8 of
    # 64 assignments, so tokens drop; at 4.0 the capacity is all 32
    jcfg, cfg = _configs(capacity_factor=capacity_factor)
    assert (moe._capacity(cfg, 32, 4) * 4 < 64) == (capacity_factor < 1)
    batch = _batch(cfg.vocab)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    total, metrics, grads = _grads(build_model(cfg),
                                   _port_params(jparams, cfg), batch)
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    for k in ("ce_loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(wm[k]),
                                   rtol=1e-5)
    want_g = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    assert set(grads) == set(want_g)
    for path, g in grads.items():
        w = want_g[path]
        assert float(np.abs(w).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=path)


def test_remat_gives_the_same_loss_and_grads(jparams, monkeypatch):
    _, cfg = _configs()
    batch = _batch(cfg.vocab, step=1)
    runs = {}
    for remat in (False, True):
        calls = {"fwd": 0, "bwd": 0, "gmm": 0}

        def counting(fn, key):
            def wrapped(*a, **kw):
                calls[key] += 1
                return fn(*a, **kw)
            return wrapped
        with monkeypatch.context() as m:
            m.setattr(fab, "flash_attention_fwd",
                      counting(fab.flash_attention_fwd, "fwd"))
            m.setattr(fab, "flash_attention_bwd",
                      counting(fab.flash_attention_bwd, "bwd"))
            m.setattr(moe_gmm, "grouped_matmul",
                      counting(moe_gmm.grouped_matmul, "gmm"))
            c = cfg.replace(remat=remat)
            runs[remat] = _grads(build_model(c), _port_params(jparams, c),
                                 batch)
        # per layer: the forward kernels once more under remat (its
        # recompute), one attention backward, two gmm per forward gmm
        n = cfg.n_layers
        assert calls == {"fwd": (1 + remat) * n, "bwd": n,
                         "gmm": (3 + 3 * remat + 6) * n}, (remat, calls)
    (t0, _, g0), (t1, _, g1) = runs[False], runs[True]
    assert torch.equal(t0, t1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


def test_train_steps_match_reference(jparams):
    lr = 1e-3
    jcfg, cfg = _configs()
    jopt = JaxAdamW(JaxAdamWConfig(lr=lr))
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jopt))
    opt = AdamW(AdamWConfig(lr=lr))
    step = make_train_step(build_model(cfg), opt)
    jp, js = jparams, jopt.init(jparams)
    p = _port_params(jparams, cfg)
    s = opt.init(p)
    for i in range(3):
        batch = _batch(cfg.vocab, step=i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        p, s, m = step(p, s, _torch_batch(batch))
        # the losses every step; the gradient norm while the parameters
        # are still the same on both sides
        for k in ("total_loss", "ce_loss", "aux_loss") + (
                ("grad_norm",) if i == 0 else ()):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert int(s["step"]) == int(js["step"]) == 3
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(p):
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=0,
                                   atol=10 * lr, err_msg=path)


def _dense_tiny():
    return ModelConfig(name="tiny", family="dense", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False)


def test_grad_accum_matches_full_batch():
    # dense FFN: an MoE's capacity would change with the microbatch
    model = build_model(_dense_tiny())
    opt = AdamW(AdamWConfig(lr=1e-2, weight_decay=0.0))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_copy_task_batch(CopyTaskConfig(vocab=64, seq_len=16,
                                                global_batch=8), 0)
    out = []
    for accum in (1, 4):
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        p, _, m = make_train_step(model, opt, grad_accum=accum)(
            p, opt.init(p), batch)
        out.append((p, m))
    (p1, m1), (p4, m4) = out
    np.testing.assert_allclose(float(m1["ce_loss"]), float(m4["ce_loss"]),
                               rtol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=path)


def test_train_step_raises_on_a_leaf_without_gradient():
    # a leaf the loss does not reach (a detached kernel output would look
    # the same) must raise, not be decayed on a zero gradient
    model = build_model(_dense_tiny())
    opt = AdamW(AdamWConfig(lr=1e-2))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    params["unused"] = torch.ones((4, 4))
    params = tree_map(lambda t: t.requires_grad_(True), params)
    batch = make_copy_task_batch(CopyTaskConfig(vocab=64, seq_len=16,
                                                global_batch=2), 0)
    with pytest.raises(RuntimeError, match="not have been used"):
        make_train_step(model, opt)(params, opt.init(params), batch)


# ---------------------------------------------------------------------------
# AdamW, transforms, schedules
# ---------------------------------------------------------------------------

def test_adamw_update_from_jax_state_matches_reference(jparams):
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    np_params = jax.tree.map(np.asarray, jparams)
    noise = lambda scale: jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(a.dtype),
        np_params)
    grads = noise(1.0)
    state = {"mu": noise(0.01),
             "nu": jax.tree.map(np.abs, noise(1e-3)),
             "step": np.int32(5)}
    cfg_kw = dict(lr=linear_warmup(1e-2, 10), weight_decay=0.1,
                  clip_norm=1.0)
    jopt = JaxAdamW(JaxAdamWConfig(**{**cfg_kw,
                                      "lr": jax_linear_warmup(1e-2, 10)}))
    jp, js, jnorm = jax.jit(jopt.update)(
        jparams, jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state))

    opt = AdamW(AdamWConfig(**cfg_kw))
    p = params_from_jax(np_params, cfg, "cpu")
    s = opt_state_from_jax(state, cfg, "cpu")
    p, s, norm = opt.update(p, params_from_jax(grads, cfg, "cpu"), s)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert int(s["step"]) == int(js["step"]) == 6
    for tree, want in ((p, jp), (s["mu"], js["mu"]), (s["nu"], js["nu"])):
        want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
        for path, t in tree_leaves(tree):
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6,
                                       atol=1e-6, err_msg=path)


def test_opt_state_from_jax_checks_leaves(jparams):
    _, cfg = _configs()
    np_params = jax.tree.map(np.asarray, jparams)
    state = {"mu": np_params, "nu": np_params, "step": np.int32(0)}
    opt_state_from_jax(state, cfg, "cpu")
    bad = dict(state, mu={k: v for k, v in np_params.items()
                          if k != "embed"})
    with pytest.raises(ValueError, match="missing"):
        opt_state_from_jax(bad, cfg, "cpu")
    half = jax.tree.map(lambda a: a.astype(np.float16), np_params)
    with pytest.raises(ValueError, match="nu"):
        opt_state_from_jax(dict(state, nu=half), cfg, "cpu")
    with pytest.raises(ValueError, match="step"):
        opt_state_from_jax(dict(state, step=np.int64(0)), cfg, "cpu")


def test_adamw_decreases_quadratic():
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update(params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clipping_returns_the_pre_clip_norm():
    opt = AdamW(AdamWConfig(lr=0.0, clip_norm=1.0))
    params = {"w": torch.zeros(4)}
    _, _, gnorm = opt.update(params, {"w": torch.full((4,), 100.0)},
                             opt.init(params))
    assert float(gnorm) == pytest.approx(200.0)
    clipped = clip_by_global_norm({"w": torch.full((4,), 100.0)}, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0)


def test_adamw_moments_match_param_structure_and_skip_decay_on_vectors():
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5))
    params = {"a": torch.ones((2, 3)), "b": {"c": torch.ones(5)}}
    state = opt.init(params)
    assert [p for p, _ in tree_leaves(state["mu"])] \
        == [p for p, _ in tree_leaves(params)]
    assert state["mu"]["a"].dtype == torch.float32
    zero = tree_map(torch.zeros_like, params)
    opt.update(params, zero, state)
    assert torch.all(params["b"]["c"] == 1.0)       # ndim < 2: no decay
    assert torch.all(params["a"] < 1.0)


@pytest.mark.parametrize("name", ["constant", "linear_warmup", "cosine"])
def test_schedules_match_reference(name):
    port, ref = {
        "constant": (constant(0.3), jax_constant(0.3)),
        "linear_warmup": (linear_warmup(1.0, 10), jax_linear_warmup(1.0, 10)),
        "cosine": (cosine_with_warmup(1.0, 10, 100, final_frac=0.1),
                   jax_cosine(1.0, 10, 100, final_frac=0.1)),
    }[name]
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert port(s) == pytest.approx(float(ref(jnp.array(s))),
                                        rel=1e-6, abs=1e-7)
    if name == "cosine":
        assert port(0) == 0.0 and port(10) == pytest.approx(1.0)
        assert port(100) == pytest.approx(0.1, rel=1e-3)


def test_global_norm_matches_reference():
    t = {"a": np.full(4, 3.0, np.float32), "b": np.full(9, 4.0, np.float32)}
    got = global_norm({k: torch.from_numpy(v) for k, v in t.items()})
    assert float(got) == pytest.approx(np.sqrt(4 * 9 + 9 * 16))
    assert float(got) == pytest.approx(float(jax_global_norm(t)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_deterministic():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4)
    b1, b2 = make_lm_batch(cfg, 7), make_lm_batch(cfg, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], make_lm_batch(cfg, 8)["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_data_tokens_in_range():
    b = make_lm_batch(DataConfig(vocab=50, seq_len=64, global_batch=8), 0)
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50
    assert torch.all(b["mask"] == 1)


def test_copy_task_structure_matches_reference():
    cfg = CopyTaskConfig(vocab=32, seq_len=16, global_batch=2)
    b = make_copy_task_batch(cfg, 3)
    plen = cfg.plen
    assert torch.equal(b["labels"][:, plen:2 * plen], b["tokens"][:, :plen])
    assert torch.all(b["tokens"][:, plen] == cfg.vocab - 1)
    ref = jax_copy_batch(cfg, 3)        # same task, other random draws
    for k in ("tokens", "labels", "mask"):
        assert b[k].shape == tuple(ref[k].shape)
    np.testing.assert_array_equal(b["mask"].numpy(), np.asarray(ref["mask"]))


def test_cursor_roundtrip():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    s = SyntheticLM(cfg, device="cpu")
    s.next(), s.next()
    s2 = SyntheticLM(cfg, device="cpu")
    s2.load_state_dict(s.state_dict())
    assert torch.equal(s.next()["tokens"], s2.next()["tokens"])
    with pytest.raises(ValueError, match="different data stream"):
        SyntheticLM(cfg, task="copy", device="cpu").load_state_dict(
            s.state_dict())
