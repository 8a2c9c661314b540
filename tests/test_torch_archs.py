"""The archs of the port (deepseek-7b, internlm2-20b, qwen2.5-3b,
h2o-danube-1.8b, grok-1-314b, internvl2-2b with its stub frontend, and
the recurrent jamba-v0.1-52b and xlstm-1.3b) against the JAX reference:
their configs (whisper-tiny's too; its model is
``test_torch_encdec.py``'s), forward logits, ``make_prefill_fn`` and
decode ticks.  internvl2-2b's forward and prefill take patch
embeddings from numpy (``torch_archs.frontend_embeds``); its decode,
as the reference's, reads tokens alone.

Each arch runs its ``SMOKE`` config (2 layers, d 64, f32) on the
reference's random weights, carried over by ``params_from_jax``, with
the attention biases (qwen2.5-3b's ``qkv_bias``; zero at the
reference's init) drawn from numpy so that they count; tokens come from
numpy.  Three cases reach shapes the SMOKE configs do not:
``internlm2-20b-g6`` (12 / 2 heads: groups of 6, as the full config's 48
/ 8), ``h2o-danube-1.8b-dh80`` (d 160 over 2 / 1 heads: head dim 80,
the full config's, window 8) and ``xlstm-1.3b-chunk8`` (the chunkwise
mLSTM, 8 tokens a chunk).  The recurrent archs run at a fan-in init
(``torch_archs.fan_in_init`` says why).  The reference runs
``attention_impl="pallas_interpret"`` (its flash kernel in interpret
mode), the port its kernels' plain versions (CPU tensors).  The
gradients are in ``test_torch_archs_train.py``.

Tolerances as ``test_torch_models.py``'s: logits and decode ticks within
1e-4 of the largest reference magnitude (two layers of f32 sums in
another order over O(100) activations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.models import build_model as jax_build_model
from repro_torch.configs import (ARCH_NAMES, NOT_PORTED, get_config,
                                 list_configs)
from repro_torch.models import build_model, make_prefill_fn
from repro_torch.models.common import tree_leaves
from torch_archs import (ARCHS, CASES, RECURRENT_ARCHS, case_setup,
                         fan_in_init, frontend_embeds)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS + ("whisper-tiny",))
def test_config_matches_reference_field_for_field(arch, smoke):
    jcfg, cfg = jax_get_config(arch, smoke=smoke), get_config(arch, smoke)
    names = [f.name for f in dataclasses.fields(jcfg)]
    assert names == [f.name for f in dataclasses.fields(cfg)]
    for name in names:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for prop in ("hd", "superblock", "n_superblocks", "dropless"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


def test_registry():
    # every reference arch is ported and builds
    assert set(ARCH_NAMES) == set(ARCHS) | {"phi3.5-moe-42b", "whisper-tiny"}
    assert NOT_PORTED == ()
    assert ARCH_NAMES == tuple(jax_list_configs())
    assert {n: c.name for n, c in list_configs().items()} == \
        {n: n for n in ARCH_NAMES}
    for name in ARCH_NAMES:
        model = build_model(get_config(name, smoke=True))
        assert type(model).__name__ == (
            "EncDecModel" if name == "whisper-tiny" else "Model"), name
    assert "frontend_proj" in build_model(get_config("internvl2-2b")).specs()
    assert get_config("h2o-danube-1.8b").hd == 80
    assert get_config("qwen2.5-3b").qkv_bias
    assert get_config("deepseek-7b").n_heads == \
        get_config("deepseek-7b").n_kv_heads
    assert {m for m, _ in get_config("jamba-v0.1-52b").superblock} == \
        {"mamba", "attn"}
    assert get_config("xlstm-1.3b").xlstm_chunk == 128


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_cases_need_the_fan_in_init(arch):
    # flip the last bit of every reference parameter (x (1 +- 1e-7)): at
    # the SMOKE init the reference's own logits move by more than this
    # file's 1e-4 of the largest, at the fan-in init by less
    jcfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(jcfg)
    tokens = jnp.asarray(np.random.default_rng(3).integers(
        0, jcfg.vocab, (2, 16)), jnp.int32)
    forward = jax.jit(lambda p: model.forward(p, tokens)[0])
    init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    moved = {}
    for name, tree in (("smoke", init),
                       ("fan-in", fan_in_init(init, jcfg.d_model))):
        flipped = jax.tree.map(lambda a: (a * (1 + 1e-7 * rng.choice(
            [-1, 1], a.shape))).astype(a.dtype), tree)
        want = np.asarray(forward(_jax(tree)))
        moved[name] = float(np.abs(np.asarray(forward(_jax(flipped)))
                                   - want).max() / np.abs(want).max())
    assert moved["smoke"] > 1e-4 > moved["fan-in"], moved


@pytest.mark.parametrize("case", CASES)
def test_forward_and_prefill_match_reference(case):
    jcfg, jparams, cfg, params = case_setup(case)
    if cfg.qkv_bias:      # params_from_jax carried the bias leaves over
        for path, t in tree_leaves(params):
            if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                assert t.abs().max() > 0, path
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    fe = frontend_embeds(cfg, 2)
    front = {} if fe is None else {"frontend_embeds": fe}
    want, want_aux = jax_build_model(jcfg).forward(
        _jax(jparams), jnp.asarray(tokens, jnp.int32), **_jax(front))
    model = build_model(cfg)
    got, aux = model.forward(params, torch.from_numpy(tokens), **{
        k: torch.from_numpy(v) for k, v in front.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    _close(got.numpy(), np.asarray(want), 1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-7)
    last = make_prefill_fn(model)(params, torch.from_numpy(tokens), *(
        torch.from_numpy(v) for v in front.values()))
    _close(last.numpy(), np.asarray(want)[:, -1], 1e-4)


@pytest.mark.parametrize("case", CASES)
def test_decode_ticks_match_reference(case):
    # 12 ticks; under danube's window of 8 the ring buffer of 8 slots wraps
    jcfg, jparams, cfg, params = case_setup(case)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    B, ticks = 3, 12
    jcaches = jmodel.init_caches(B, ticks)
    caches = model.init_caches(B, ticks, "cpu")
    for j, (mixer, _) in enumerate(cfg.superblock):
        if mixer == "attn":
            slots = caches["states"][f"pos{j}"]["k"].shape[-2]
            assert slots == min(ticks, cfg.window or ticks)
    step = jax.jit(jmodel.decode_step)
    jp = _jax(jparams)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (ticks, B, 1))
    for t in range(ticks):
        want, jcaches = step(jp, jnp.asarray(toks[t], jnp.int32), jcaches)
        got, caches = model.decode_step(params, torch.from_numpy(toks[t]),
                                        caches)
        _close(got.numpy(), np.asarray(want), 1e-4)
    assert caches["pos"].tolist() == [ticks] * B
    want_states = dict(tree_leaves(jax.tree.map(np.asarray,
                                                jcaches["states"])))
    got_states = tree_leaves(caches["states"])
    assert {p for p, _ in got_states} == set(want_states)
    for path, t in got_states:
        _close(t.float().numpy(), want_states[path], 1e-4)
