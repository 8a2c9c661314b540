"""Port model stack (repro_torch) against the JAX reference.

Both packages run the SMOKE size of phi3.5-moe-42b (2 layers, d=64, 4
experts, f32) on the reference's random weights, carried over by
``params_from_jax``; activations come from numpy with a seed.  The routing
inputs are random f32, so no two router probabilities tie.

Tolerances (``_close``): relative ``tol`` per element plus ``tol`` times
the largest reference magnitude, because an f32 sum summed in another
order errs in proportion to its terms, not to its result (the reference's
init makes activations O(100), so small outputs are differences of large
terms).  Single blocks: 2e-5 (one chain of f32 products); whole-model
logits and 8 decode ticks: 1e-4, for two layers of such chains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import ffn as jax_ffn
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import (build_model, common, ffn, make_prefill_fn,
                                moe)
from repro_torch.models.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "phi3.5-moe-42b"


@pytest.fixture(scope="module")
def smoke():
    """(jax cfg, jax params, port cfg, port params) at the SMOKE size."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(
        attention_impl="pallas_interpret")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_config_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "vocab",
              "n_experts", "top_k", "n_layers", "capacity_factor",
              "superblock", "n_superblocks", "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.n_experts, cfg.vocab) == (4096, 32, 8, 128, 6400, 16, 32064)
    assert cfg.cdtype == torch.bfloat16


@pytest.mark.parametrize("n_tokens,n_slots", [(4, 16), (4096, 16), (16, 4),
                                              (1, 4), (100, 16), (0, 16)])
def test_capacity_matches_reference(n_tokens, n_slots):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert moe._capacity(cfg, n_tokens, n_slots) == \
        jax_moe._capacity(jcfg, n_tokens, n_slots)
    # decode on 4 slots: C = min(8, 4) = 4; prefill B=2, S=2048: C = 640
    assert moe._capacity(cfg, 4, 16) == 4
    assert moe._capacity(cfg, 4096, 16) == 640


def test_unported_paths_raise():
    # the encoder-decoder, the frontends and a recurrent mixer under
    # Ulysses build and take a mesh
    from repro_torch.configs import NOT_PORTED
    from repro_torch.models.encdec import EncDecModel
    assert NOT_PORTED == ()
    whisper = build_model(get_config("whisper-tiny"))
    vlm = build_model(get_config("internvl2-2b"))
    assert isinstance(whisper, EncDecModel)
    assert "frontend_proj" in vlm.specs()
    framed = build_model(get_config(ARCH, smoke=True).replace(
        frontend="vit_stub", n_frontend_tokens=4))
    assert isinstance(build_model(get_config(ARCH, smoke=True).replace(
        encoder_layers=2)), EncDecModel)
    shape = {"pod": 2, "data": 2, "model": 2}
    for model in (whisper, vlm, framed):
        model.check_mesh(shape)
    jamba = build_model(get_config("jamba-v0.1-52b", smoke=True).replace(
        use_ulysses=True))
    assert jamba.check_mesh(shape) is None
    _rules_accepted(shape)


def _rules_accepted(shape):
    """The four rule sets the port once refused on (pod 2, data 2, model
    2): ``make_train_step`` gets past its mesh checks (to the parameters'
    layout, stubbed) and ``param_layout`` gives the layout, for the MoE
    and the dense model: EP and FSDP outside the batch rule
    (``batch=("data",)``), FSDP over ``model`` (``embed_fsdp``) and FSDP
    over two axis sets (``vocab=("data",)``: the embedding's over
    ``pod``, the other leaves' over ``pod, data``)."""
    import pytest
    from repro_torch.models import make_train_step, model_api
    from repro_torch.models.common import param_layout
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import ShardingRules

    class Accepted(Exception):
        pass

    def layout(specs, mesh, rules):
        raise Accepted(param_layout(specs, mesh, rules))
    moe = get_config(ARCH, smoke=True)
    dense = moe.replace(family="dense", n_experts=0)
    for cfg in (moe, dense):
        model = build_model(cfg)
        for kw in ({"batch": ("data",)}, {"embed_fsdp": ("model",)},
                   {"vocab": ("data",)}):
            rules = ShardingRules().override(**kw)
            real, model_api.param_shardings = model_api.param_shardings, \
                layout
            try:
                with pytest.raises(Accepted) as got:
                    make_train_step(model, AdamW(), shape, rules)
            finally:
                model_api.param_shardings = real
            lay = got.value.args[0]
            assert lay == param_layout(model.specs(), shape, rules)
            kept = set(lay["fsdp_kept"].values())
            if "vocab" in kw:
                assert lay["fsdp_kept"]["embed"] == ("pod",)
                assert kept == {("pod",), ("pod", "data")}
            elif "embed_fsdp" in kw:
                assert kept == {("model",)}
            else:
                assert kept == {("pod", "data")}


@pytest.mark.parametrize("seq,ok", [(16, True), (18, False)])
def test_frontend_ulysses_needs_model_to_divide_f_plus_s(seq, ok):
    """Under Ulysses the frontend's F tokens and the text are one sequence
    split over ``model``: internvl2-2b's SMOKE F = 8 plus S = 16 divides
    ``model`` = 4, plus 18 does not, and the launcher's check names F + S
    and ``model``."""
    from repro_torch.launch.mesh import check_trainable
    cfg = get_config("internvl2-2b", smoke=True).replace(use_ulysses=True)
    shape = {"data": 2, "model": 4}
    build_model(cfg).check_mesh(shape)
    if ok:
        check_trainable(shape, cfg, seq)
        return
    with pytest.raises(ValueError, match=r"F \+ S = 8 \+ 18 \(26\) "
                       r"divisible by model \(4\)"):
        check_trainable(shape, cfg, seq)


@pytest.mark.parametrize("name", ["rms_norm", "layer_norm", "dense", "rope",
                                  "gelu", "silu"])
def test_common_layers_match_reference(name):
    x, g, b = _x(5, 2, 6, 16), _x(6, 16) + 1.0, _x(7, 16)
    w = _x(8, 16, 12)
    pos = np.arange(12, dtype=np.int32).reshape(2, 6)
    J, T = jnp.asarray, torch.from_numpy
    pairs = {
        "rms_norm": (lambda: jax_common.rms_norm(J(x), J(g)),
                     lambda: common.rms_norm(T(x), T(g))),
        "layer_norm": (lambda: jax_common.layer_norm(J(x), J(g), J(b)),
                       lambda: common.layer_norm(T(x), T(g), T(b))),
        "dense": (lambda: jax_common.dense(J(x), J(w), J(b[:12]),
                                           jnp.float32),
                  lambda: common.dense(T(x), T(w), T(b[:12]),
                                       torch.float32)),
        "rope": (lambda: jax_common.apply_rope(J(x), J(pos), 500.0),
                 lambda: common.apply_rope(T(x), T(pos), 500.0)),
        "gelu": (lambda: jax_common.gelu(J(x)), lambda: common.gelu(T(x))),
        "silu": (lambda: jax_common.silu(J(x)), lambda: common.silu(T(x))),
    }
    want, got = pairs[name]
    _close(got().numpy(), want(), 2e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_dense_ffn_matches_reference(act):
    jcfg = jax_get_config(ARCH, smoke=True).replace(n_experts=0, act=act)
    cfg = get_config(ARCH, smoke=True).replace(n_experts=0, act=act)
    jp = {k: _x(20 + i, *s.shape) for i, (k, s)
          in enumerate(sorted(ffn.ffn_specs(cfg).items()))}
    x = _x(9, 2, 5, cfg.d_model)
    want = jax_ffn.ffn_block({k: jnp.asarray(v) for k, v in jp.items()},
                             jnp.asarray(x), jcfg)
    got = ffn.ffn_block({k: torch.from_numpy(v) for k, v in jp.items()},
                        torch.from_numpy(x), cfg)
    _close(got.numpy(), want, 2e-5)


@pytest.mark.parametrize("G", [2, 8])
def test_moe_inner_dispatch_layout_matches_reference(smoke, G):
    # the (G, E_loc, C, D) dispatch layout the collective slice will
    # exchange, as device 0 computes it with the exchange left out: G=2
    # partitions the 4 experts, G=8 replicates each twice (E_loc=1, R=2)
    jcfg, jparams, cfg, params = smoke
    E = cfg.n_experts
    E_loc, R = (E // G, 1) if E >= G else (1, G // E)
    x = _x(11, 2, 8, cfg.d_model)
    C = moe._capacity(cfg, 16, max(E, G))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["ffn"])
    p = _layer0(params["blocks"])["pos0"]["ffn"]
    kw = dict(G=G, E_loc=E_loc, R=R, C=C)
    want, want_aux = jax_moe._moe_inner(
        jnp.asarray(x), jp["router"],
        *(jax_moe._virtual_weights(jp[k], G) for k in ("w1", "w3", "w2")),
        cfg=jcfg, axes=(), tp_axis=None, reduce_axes=(), **kw)
    got, aux = moe._moe_inner(
        torch.from_numpy(x), p["router"],
        *(moe._virtual_weights(p[k], G) for k in ("w1", "w3", "w2")),
        cfg=cfg, **kw)
    _close(got.numpy(), want, 2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_params_from_jax_checks_leaves(smoke):
    jcfg, jparams, cfg, params = smoke
    tree = jax.tree.map(np.asarray, jparams)
    assert params["blocks"]["pos0"]["ffn"]["w1"].shape == \
        (cfg.n_superblocks, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert params["blocks"]["pos0"]["ffn"]["router"].dtype == torch.float32
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(extra, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, cfg, "cpu")
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, cfg, "cpu")
    wrong = dict(tree, embed=tree["embed"].astype(np.float16))
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(wrong, cfg, "cpu")


def test_params_from_jax_carries_bf16_bits():
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["embed"].float().numpy(),
        np.asarray(jparams["embed"].astype(jnp.float32)))


def test_moe_block_matches_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    x = _x(0, 2, 8, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["ffn"])
    want_y, want_aux = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_block(_layer0(params["blocks"])["pos0"]["ffn"],
                           torch.from_numpy(x), cfg)
    _close(y.numpy(), np.asarray(want_y), 2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_dropless_moe_block_matches_reference(smoke):
    # capacity_factor=None: C is the worst case (every token fits), the
    # same layer with mesh=None in both packages
    jcfg, jparams, cfg, params = smoke
    jcfg = jcfg.replace(capacity_factor=None)
    cfg = cfg.replace(capacity_factor=None)
    x = _x(2, 1, 64, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["ffn"])
    want_y, want_aux = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_block(_layer0(params["blocks"])["pos0"]["ffn"],
                           torch.from_numpy(x), cfg)
    assert moe._capacity(cfg, 64, cfg.n_experts) == 64
    _close(y.numpy(), np.asarray(want_y), 2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_block_drops_past_capacity(smoke):
    # 64 tokens on 4 experts at capacity factor 0.5: C = 16 < the busiest
    # expert's load, so the drop-scatter / zero-pad combine path runs
    jcfg, jparams, cfg, params = smoke
    jcfg = jcfg.replace(capacity_factor=0.5)
    cfg = cfg.replace(capacity_factor=0.5)
    x = _x(1, 1, 64, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["ffn"])
    want_y, _ = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    p = _layer0(params["blocks"])["pos0"]["ffn"]
    y, _ = moe.moe_block(p, torch.from_numpy(x), cfg)
    probs = torch.softmax(torch.from_numpy(x).reshape(64, -1)
                          @ p["router"], -1)
    load = torch.bincount(torch.topk(probs, 2).indices.reshape(-1),
                          minlength=cfg.n_experts)
    assert int(load.max()) > moe._capacity(cfg, 64, cfg.n_experts)
    _close(y.numpy(), np.asarray(want_y), 2e-5)


def test_attention_block_matches_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    x = _x(2, 2, 16, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["mixer"])
    want = jax_attn.attention_block(jp, jnp.asarray(x), jcfg)
    got = attn.attention_block(_layer0(params["blocks"])["pos0"]["mixer"],
                               torch.from_numpy(x), cfg)
    _close(got.numpy(), np.asarray(want), 2e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_reference(smoke, window):
    # 7 positions through a ring buffer of W = 4 (window) or 8 slots
    jcfg, jparams, cfg, params = smoke
    jcfg, cfg = jcfg.replace(window=window), cfg.replace(window=window)
    W = window or 8
    B = 2
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["mixer"])
    p = _layer0(params["blocks"])["pos0"]["mixer"]
    jcache = jax_attn.init_cache(jax_attn.CacheSpec(B, cfg.n_kv_heads, W,
                                                    cfg.hd, jnp.float32))
    cache = attn.init_cache(attn.CacheSpec(B, cfg.n_kv_heads, W, cfg.hd,
                                           torch.float32), "cpu")
    for t in range(7):
        x = _x(10 + t, B, 1, cfg.d_model)
        pos = np.array([t, t + 1], np.int32)
        want, jcache = jax_attn.decode_attention(
            jp, jnp.asarray(x), jcache, jnp.asarray(pos), jcfg)
        got, cache = attn.decode_attention(p, torch.from_numpy(x), cache,
                                           torch.from_numpy(pos), cfg)
        _close(got.numpy(), np.asarray(want), 2e-5)
    for key in ("k", "v", "slot_pos"):
        _close(cache[key].numpy(), np.asarray(jcache[key]), 2e-5)


def test_forward_logits_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    want, want_aux = jax_build_model(jcfg).forward(
        jparams, jnp.asarray(tokens, jnp.int32))
    model = build_model(cfg)
    got, aux = model.forward(params, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    _close(got.numpy(), np.asarray(want), 1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    last = make_prefill_fn(model)(params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(last.numpy(), got[:, -1].numpy())


def test_decode_steps_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    B, max_seq = 3, 12
    jcaches = jmodel.init_caches(B, max_seq)
    caches = model.init_caches(B, max_seq, "cpu")
    step = jax.jit(jmodel.decode_step)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (8, B, 1))
    for t in range(8):
        want, jcaches = step(jparams, jnp.asarray(toks[t], jnp.int32),
                             jcaches)
        got, caches = model.decode_step(params, torch.from_numpy(toks[t]),
                                        caches)
        _close(got.numpy(), np.asarray(want), 1e-4)
    assert caches["pos"].tolist() == [8] * B
    # sequential prefill through decode_step
    logits, pre = model.prefill(params, torch.from_numpy(toks[:, :, 0].T),
                                model.init_caches(B, max_seq, "cpu"))
    _close(logits.numpy(), want, 1e-4)
    torch.testing.assert_close(pre["states"]["pos0"]["k"],
                               caches["states"]["pos0"]["k"])
    _close(caches["states"]["pos0"]["k"].numpy(),
           np.asarray(jcaches["states"]["pos0"]["k"]), 1e-4)


def test_model_init_is_seeded():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg)

    def init(seed):
        return model.init(torch.Generator().manual_seed(seed), "cpu")
    a, b, c = init(0), init(0), init(1)
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["blocks"]["pos0"]["ffn"]["router"].dtype == torch.float32
    assert a["blocks"]["pos0"]["norm1"]["g"].eq(1).all()


def test_forward_bf16_close_to_reference():
    # the card's dtype: both packages round to bf16 (8-bit mantissa) after
    # every product, at places that differ between XLA and torch, and the
    # differences compound over 2 layers; the check is that the logits stay
    # within 10% of the largest logit and the greedy tokens agree
    jcfg = jax_get_config(ARCH, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        attention_impl="pallas_interpret")
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16",
                                               compute_dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    want, _ = jax_build_model(jcfg).forward(jparams,
                                            jnp.asarray(tokens, jnp.int32))
    got, _ = build_model(cfg).forward(params, torch.from_numpy(tokens))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 0.1 * np.abs(want).max()
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
