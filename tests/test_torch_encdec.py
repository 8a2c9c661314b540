"""The encoder-decoder of the port (``repro_torch.models.encdec``,
whisper-tiny) against the JAX reference (``repro.models.encdec``).

Both packages run whisper-tiny's SMOKE config (2 encoder + 2 decoder
layers, d 64, 4 heads, 16 frames, f32) and a bf16 variant of it on the
reference's random weights, carried over by ``params_from_jax``; frame
embeddings and tokens come from numpy.  The reference's attention runs
as its own tests run it on the CPU: its flash kernel in interpret mode
(``attention_impl="pallas_interpret"``) for the forward and decode, and
``"xla"`` (autodiff of its oracle) for the gradients; the port runs its
kernels' plain versions (CPU tensors), inside ``FlashAttentionFn`` under
autograd.

Tolerances: f32 within 1e-4 of the largest reference magnitude (two
layers of f32 sums in another order over O(100) activations; gradient
leaves 2e-4, as ``test_torch_train.py``'s), bf16 within the reference's
2e-2 of it; the position table bit for bit; greedy tokens identical.
The bf16 variant runs on the reference's weights rescaled to fan-in
(``torch_archs.fan_in_init``): at the reference's own init every softmax
is near one-hot, and the packages' bf16 roundings, which fall at other
places, move each other's logits by a third of the largest (0.344;
``test_torch_models.py::test_forward_bf16_close_to_reference`` allows
10% for phi3.5-moe), against 0.8% at the fan-in init.  The gradients
run at the fan-in init in f32 too: at the reference's init the
reference's own two attention impls (``"xla"``, ``"pallas_interpret"``)
give gradients 2.0e-4 of the largest apart, the tolerance itself
(8.6e-7 at the fan-in init).  ``tools/encdec_numerics.py`` prints these
numbers.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _batcher_step as jax_batcher_step
from repro.models import build_model as jax_build_model
from repro.models import make_serve_step as jax_make_serve_step
from repro.models import attention as jax_attn
from repro.models.common import sinusoidal_positions as jax_positions
from repro.runtime.serving import ContinuousBatcher as JaxBatcher
from repro.runtime.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_fwd
from repro_torch.launch import serve
from repro_torch.launch.serve import batcher_step
from repro_torch.models import build_model, make_prefill_fn, make_serve_step
from repro_torch.models import attention as attn
from repro_torch.models.common import sinusoidal_positions, tree_leaves
from repro_torch.models.common import tree_map
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.encdec import EncDecModel
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         _reset_slot)
from torch_archs import fan_in_init

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "whisper-tiny"
# dtype -> (config changes, tolerance)
DTYPES = {"f32": ({}, 1e-4), "bf16": (dict(param_dtype="bfloat16",
                                            compute_dtype="bfloat16"), 2e-2)}
B, S = 2, 12


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _np(t):
    return t.detach().float().numpy()


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.cache
def _setup(dtype: str, impl: str = "pallas_interpret", fan_in: bool = False):
    """(reference model, its numpy params, port config, port params); bf16
    (or ``fan_in``) at the fan-in init."""
    kw = DTYPES[dtype][0]
    jcfg = jax_get_config(ARCH, smoke=True).replace(attention_impl=impl,
                                                    **kw)
    cfg = get_config(ARCH, smoke=True).replace(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if fan_in or dtype == "bf16":
        jparams = fan_in_init(jparams, cfg.d_model)
    return jmodel, jparams, cfg, params_from_jax(jparams, cfg, "cpu")


def _jdtype(cfg):
    return jnp.bfloat16 if cfg.cdtype == torch.bfloat16 else jnp.float32


def _frames(cfg, seed: int = 5, batch: int = B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed: int = 3, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


@pytest.mark.parametrize("max_len,d_model", [(1, 2), (16, 64), (37, 30),
                                             (1500, 384)])
def test_sinusoidal_positions_bit_for_bit(max_len, d_model):
    got = sinusoidal_positions(max_len, d_model)
    assert got.dtype == torch.float32 and got.shape == (max_len, d_model)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_positions(max_len, d_model)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_block_matches_reference(dtype):
    # Sq = 5 queries against an odd Skv = 23 memory rows, non-causal
    jmodel, jparams, cfg, params = _setup(dtype)
    lp = tree_map(lambda t: t[0], params["decoder"]["cross_attn"])
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       jparams["decoder"]["cross_attn"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    memory = rng.standard_normal((B, 23, cfg.d_model)).astype(np.float32)
    want = jax_attn.cross_attention_block(
        jlp, jnp.asarray(x, _jdtype(cfg)), jnp.asarray(memory, _jdtype(cfg)),
        jmodel.cfg)
    got = attn.cross_attention_block(lp, torch.from_numpy(x).to(cfg.cdtype),
                                     torch.from_numpy(memory).to(cfg.cdtype),
                                     cfg)
    assert got.shape == (B, 5, cfg.d_model) and got.dtype == cfg.cdtype
    _close(_np(got), want, DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_forward_and_prefill_match_reference(dtype):
    jmodel, jparams, cfg, params = _setup(dtype)
    tol = DTYPES[dtype][1]
    model = build_model(cfg)
    assert isinstance(model, EncDecModel)
    frames, tokens = _frames(cfg), _tokens(cfg)
    jp = _jax(jparams)
    want_mem = jmodel.encode(jp, jnp.asarray(frames))
    got_mem = model.encode(params, torch.from_numpy(frames))
    assert got_mem.dtype == cfg.cdtype
    _close(_np(got_mem), want_mem, tol)
    want, want_aux = jmodel.forward(jp, jnp.asarray(tokens, jnp.int32),
                                    frontend_embeds=jnp.asarray(frames))
    got, aux = model.forward(params, torch.from_numpy(tokens),
                             frontend_embeds=torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab)
    _close(got.numpy(), want, tol)
    assert float(aux) == float(want_aux) == 0.0
    last = make_prefill_fn(model)(params, torch.from_numpy(tokens),
                                  torch.from_numpy(frames))
    _close(last.numpy(), np.asarray(want)[:, -1], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(dtype):
    jmodel, jparams, cfg, params = _setup(dtype, "xla", fan_in=True)
    tol = DTYPES[dtype][1]
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    batch = {"tokens": _tokens(cfg), "labels": _tokens(cfg, seed=4),
             "frontend_embeds": _frames(cfg)}
    (want, wm), wg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        _jax(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(params)
    total, metrics = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, [t for _, t in leaves])
    np.testing.assert_allclose(total.item(), float(want),
                               rtol=1e-5 if dtype == "f32" else tol)
    assert set(metrics) == set(wm)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(wm[k]),
                                   rtol=1e-5 if dtype == "f32" else tol,
                                   atol=1e-7)
    want_g = dict(tree_leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), wg)))
    assert {p for p, _ in leaves} == set(want_g)
    gtol = 2e-4 if dtype == "f32" else tol
    for (path, _), g in zip(leaves, grads):
        w = want_g[path]
        assert g.dtype == cfg.pdtype, path
        assert float(np.abs(w).max()) > 0, path
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=gtol * float(np.abs(w).max()),
                                   err_msg=path)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_unrematted_gradients(policy):
    _, _, cfg, params = _setup("f32")
    batch = {"tokens": torch.from_numpy(_tokens(cfg)),
             "labels": torch.from_numpy(_tokens(cfg, seed=4)),
             "frontend_embeds": torch.from_numpy(_frames(cfg))}
    grads = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        leaves = [t for _, t in tree_leaves(p)]
        model = build_model(cfg.replace(remat=remat, remat_policy=policy))
        fwd0 = flash_attention_fwd.launches
        total, _ = model.loss(p, batch)
        grads.append(torch.autograd.grad(total, leaves))
        assert flash_attention_fwd.launches == fwd0   # plain versions
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_ticks_and_carried_caches_match_reference(dtype):
    # a cache of 8 slots and 10 ticks: past slot 8 the position table
    # clamps to its last row and the KV buffer wraps, in both packages;
    # after 5 ticks the reference's caches are carried over and both
    # decode on from them
    jmodel, jparams, cfg, params = _setup(dtype)
    tol = DTYPES[dtype][1]
    model = build_model(cfg)
    slots, ticks = 8, 10
    frames = _frames(cfg)
    jp = _jax(jparams)
    jmemory = jmodel.encode(jp, jnp.asarray(frames))
    memory = model.encode(params, torch.from_numpy(frames))
    jcaches = jmodel.init_caches(B, slots)
    caches = model.init_caches(B, slots, "cpu")
    assert {p: tuple(t.shape) for p, t in tree_leaves(caches)} == {
        p: tuple(np.shape(a)) for p, a in tree_leaves(
            jax.tree.map(np.asarray, jcaches))}
    k = caches["states"]["k"]
    assert k.untyped_storage().data_ptr() != \
        caches["states"]["v"].untyped_storage().data_ptr()
    step = jax.jit(jmodel.decode_step)
    toks = _tokens(cfg, seed=6, shape=(ticks, B, 1))
    carried = None
    for t in range(ticks):
        want, jcaches = step(jp, jnp.asarray(toks[t], jnp.int32), jcaches,
                             jmemory)
        got, caches = model.decode_step(params, torch.from_numpy(toks[t]),
                                        caches, memory)
        _close(got.numpy(), want, tol)
        if carried is not None:
            got_c, carried = model.decode_step(
                params, torch.from_numpy(toks[t]), carried, memory)
            _close(got_c.numpy(), want, tol)
        if t == 4:
            carried = caches_from_jax(jax.tree.map(np.asarray, jcaches),
                                      cfg, "cpu")
    assert caches["states"]["k"] is k                 # written in place
    assert caches["pos"].tolist() == [ticks] * B
    want_states = dict(tree_leaves(jax.tree.map(np.asarray,
                                                jcaches["states"])))
    for tree in (caches, carried):
        for path, t in tree_leaves(tree["states"]):
            _close(_np(t), want_states[path], tol)


def test_batcher_with_memory_matches_reference():
    # the launcher's body: B requests on B slots, the memory of B frame
    # sets riding along every tick; greedy tokens identical
    jmodel, jparams, cfg, params = _setup("f32")
    model = build_model(cfg)
    frames = _frames(cfg, batch=4)
    jp = _jax(jparams)
    jb = JaxBatcher(jmodel, jp, max_batch=4, max_seq=16,
                    serve_step=jax_batcher_step(
                        jax.jit(jax_make_serve_step(jmodel)),
                        jmodel.encode(jp, jnp.asarray(frames))))
    with torch.no_grad():
        memory = model.encode(params, torch.from_numpy(frames))
    tb = ContinuousBatcher(model, params, max_batch=4, max_seq=16,
                           device="cpu", serve_step=batcher_step(
                               make_serve_step(model), memory))
    prompts = [[1, 2, 3], [10, 11, 12, 13, 14], [5, 6], [20, 21, 22, 23]]
    for i, (p, m) in enumerate(zip(prompts, [5, 3, 6, 4])):
        jb.submit(JaxRequest(i, list(p), m))
        tb.submit(Request(i, list(p), m))
    want, got = jb.run(), tb.run()
    assert got == want
    assert tb.ticks == jb.ticks


def test_reset_slot_restores_the_stacked_caches_in_place():
    # the batcher's per-slot reset on the encoder-decoder's stacked
    # (n_layers, B, ...) k / v / slot_pos: batch on axis 1, as for Model
    _, _, cfg, params = _setup("f32")
    model = build_model(cfg)
    memory = model.encode(params, torch.from_numpy(_frames(cfg)))
    caches = model.init_caches(B, 8, "cpu")
    fresh = model.init_caches(B, 8, "cpu")
    k = caches["states"]["k"]
    with torch.no_grad():
        for _ in range(3):
            _, caches = model.decode_step(params, torch.tensor([[1], [2]]),
                                          caches, memory)
    out = _reset_slot(caches, fresh, 1)
    assert out["states"]["k"] is k
    assert not k[:, 1].any() and k[:, 0].any()
    assert not out["states"]["v"][:, 1].any()
    assert (out["states"]["slot_pos"][:, 1] == -1).all()
    assert (out["states"]["slot_pos"][:, 0, :3] == torch.arange(3)).all()
    assert out["pos"].tolist() == [3, 0]


def test_serve_main_on_cpu_takes_no_kernel():
    fa0 = flash_attention.launches
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert ((0 <= out) & (out < get_config(ARCH, smoke=True).vocab)).all()
    assert flash_attention.launches == fa0
    # the reference's refusal: the encoder memory is not migrated
    with pytest.raises(SystemExit, match="enc-dec"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--disaggregate"])


MESHES = ({"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2})


@pytest.mark.parametrize("ulysses", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_is_accepted(shape, ulysses):
    """The encoder-decoder on the reference's debug meshes: ``check_mesh``
    and the launcher's ``check_trainable`` accept them, with and without
    Ulysses (4 heads and 16 frames divide ``model``), and a mesh whose
    ``model`` is 1 takes any length; the runs on these meshes are
    ``test_torch_tp.py``'s."""
    from repro_torch.launch.mesh import check_trainable
    cfg = get_config(ARCH, smoke=True).replace(use_ulysses=ulysses)
    build_model(cfg).check_mesh(shape)
    check_trainable(shape, cfg, S + 4)
    odd = cfg.replace(n_frontend_tokens=15, n_heads=3, n_kv_heads=3)
    build_model(odd).check_mesh({"data": 8, "model": 1})
    check_trainable({"data": 8, "model": 1}, odd, 15)


@pytest.mark.parametrize("what,changes,seq,numbers", [
    ("frame count", dict(n_frontend_tokens=15), 16, "(15) divisible by "
     "model (4)"),
    ("n_heads", dict(n_heads=6, n_kv_heads=6), 16, "(6) divisible by model "
     "(4)"),
    ("decoder tokens", {}, 18, "(18) divisible by model (4)")])
def test_ulysses_mesh_that_does_not_divide_is_refused(what, changes, seq,
                                                      numbers):
    """Under Ulysses over ``model`` = 4, a frame count, a query head count
    or a decoder length ``model`` does not divide is refused before
    anything is built, naming the number and ``model``: by ``check_mesh``
    (what the config fixes) and by ``check_trainable`` (the launcher's,
    with the batch's decoder length)."""
    from repro_torch.launch.mesh import check_trainable
    shape = MESHES[0]
    cfg = get_config(ARCH, smoke=True).replace(use_ulysses=True, **changes)
    with pytest.raises(ValueError, match=re.escape(numbers)) as err:
        check_trainable(shape, cfg, seq)
    assert what in str(err.value)
    if seq == 16:
        with pytest.raises(ValueError, match=re.escape(numbers)):
            build_model(cfg).check_mesh(shape)
    else:
        build_model(cfg).check_mesh(shape)
