"""The port's recurrent mixers (``models.mamba``, ``models.xlstm``,
``models.spectral``) against the JAX reference, and the reference's
model-level invariants ported.

* Each block against its JAX function on the same numpy-seeded weights
  and inputs (f32, d 32, S <= 16): mamba on both conv branches (S = 3:
  explicit windows; S = 16: the shifted sum), the per-step and the
  chunkwise mLSTM (chunks of 8), the sLSTM, the spectral block's FFT
  convolution (no state) and its recurrence (a carried state); outputs
  and returned states, from a fresh start and from a state the reference
  carried out of a prefix.  Tolerance: the reference's own for f32
  (``tests/test_kernels.py::_tol``, rtol = atol = 2e-5).
* ``recurrent_step_remat``: the checkpointed scans give the unrematted
  gradients bit for bit.
* The invariants of ``tests/test_models.py`` (forward equals decode,
  scan equals incremental, chunkwise equals per-step, state size
  constant in S) on the port alone, at the reference's tolerances.
* A reference decode state carried across (``caches_from_jax``) decodes
  on as the reference does; the batcher's slot reset restores every
  recurrent leaf (``m = -1e30``, ``n = 1e-6``), so a reused slot decodes
  the tokens a fresh batcher does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelConfig as JaxConfig
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import spectral as jax_spectral
from repro.models import xlstm as jax_xlstm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import mamba, spectral, xlstm
from repro_torch.models.common import init_params, tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         _reset_slot)
import torch_fft
from torch_archs import fan_in_init
from torch_dist import run_world

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernels.py::_tol, f32
BASE = dict(family="x", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=97, param_dtype="float32",
            compute_dtype="float32", ssm_state=8)
# mixer -> (reference module, port module, specs, block)
BLOCKS = {"mamba": (jax_mamba, mamba, "mamba_specs", "mamba_block"),
          "mlstm": (jax_xlstm, xlstm, "mlstm_specs", "mlstm_block"),
          "slstm": (jax_xlstm, xlstm, "slstm_specs", "slstm_block"),
          "spectral": (jax_spectral, spectral, "spectral_specs",
                       "spectral_block")}


def _configs(**kw):
    return (JaxConfig(name="r", **{**BASE, **kw}),
            ModelConfig(name="r", **{**BASE, **kw}))


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


# mixer, S, config changes: both conv branches of mamba, both mLSTM forms
CASES = [("mamba", 3, {}), ("mamba", 16, {}), ("mlstm", 16, {}),
         ("mlstm", 16, {"xlstm_chunk": 8}), ("slstm", 16, {}),
         ("spectral", 16, {})]


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("mixer,S,kw", CASES,
                         ids=[f"{m}-S{s}{'-chunk' if k else ''}"
                              for m, s, k in CASES])
def test_block_matches_reference(mixer, S, kw, carried):
    jmod, mod, specs, block = BLOCKS[mixer]
    jcfg, cfg = _configs(**kw)
    jp = getattr(jmod, specs)(jcfg)
    jparams = jax_init_params(jp, KEY, jnp.float32)
    if mixer == "spectral":      # B and dt_log count: draw them away from 0
        rng = np.random.default_rng(5)
        jparams = dict(jparams, dt_log=jnp.asarray(
            rng.standard_normal(jparams["dt_log"].shape), jnp.float32))
    params = _to_torch(jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(1).standard_normal((2, 8 + S, 32)) \
        .astype(np.float32)
    jstate = state = None
    if carried:                  # the reference's state after 8 tokens
        _, jstate = getattr(jmod, block)(jparams, jnp.asarray(x[:, :8]),
                                         jcfg)
        state = _to_torch(jax.tree.map(np.asarray, jstate))
    want, want_state = getattr(jmod, block)(jparams, jnp.asarray(x[:, 8:]),
                                            jcfg, state=jstate)
    got, got_state = getattr(mod, block)(params, torch.from_numpy(x[:, 8:]),
                                         cfg, state=state)
    _close(got, want, "y")
    assert set(got_state) == set(want_state)
    for k, v in got_state.items():
        assert str(v.dtype) == f"torch.{np.asarray(want_state[k]).dtype}"
        _close(v, want_state[k], k)


def test_spectral_conv_equals_recurrence():
    # the FFT convolution and the step recurrence are one linear system
    _, cfg = _configs()
    params = init_params(spectral.spectral_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    y_conv, s_conv = spectral.spectral_block(params, x, cfg)
    zero = {"ssm": torch.zeros_like(s_conv["ssm"])}
    y_rec, s_rec = spectral.spectral_block(params, x, cfg, state=zero)
    torch.testing.assert_close(y_conv, y_rec, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_conv["ssm"], s_rec["ssm"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("n", [1, 4])
def test_distributed_conv_matches_local_conv(n, tmp_path):
    # the sequence-sharded convolution on a one-axis torus of n ranks: the
    # ranks' rows in torus-rank order are the one-process convolution
    rows = run_world(torch_fft.conv_world, n, tmp_path)
    assert all(r.shape[1] == 0 for r in rows[max(1, n // 2):])
    x, k = torch_fft.conv_inputs(*torch_fft.CONV[n])
    want = spectral.fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(np.concatenate(rows, axis=1), want.numpy(),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# recurrent_step_remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixer,kw", [("mamba", {}), ("mlstm", {}),
                                      ("mlstm", {"xlstm_chunk": 8}),
                                      ("slstm", {})],
                         ids=["mamba", "mlstm", "mlstm-chunk", "slstm"])
def test_step_remat_gives_the_unrematted_gradients(mixer, kw):
    _, mod, specs, block = BLOCKS[mixer]
    _, cfg = _configs(**kw)
    # 80 steps: two chunks of the per-step scans, ten of the chunkwise
    x = torch.randn(2, 80, 32, generator=torch.Generator().manual_seed(1))
    grads = []
    for remat in (False, True):
        params = init_params(getattr(mod, specs)(cfg),
                             torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
        xg = x.clone().requires_grad_(True)
        c = cfg.replace(recurrent_step_remat=remat)
        y, state = getattr(mod, block)(params, xg, c)
        loss = y.square().sum() + sum(v.float().square().sum()
                                      for v in state.values()
                                      if v.abs().max() < 1e29)
        grads.append(torch.autograd.grad(loss, leaves + [xg]))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

def _model_cfg(**kw):
    return ModelConfig(name="m", **{**BASE, **kw})


@pytest.mark.parametrize("kw", [
    {"n_experts": 4, "capacity_factor": 8.0, "moe_every": 2,
     "block_pattern": ("mamba", "attn")},
    {"d_ff": 0, "block_pattern": ("mlstm", "slstm")},
    {"d_ff": 0, "block_pattern": ("mlstm", "slstm"), "xlstm_chunk": 5},
    {"block_pattern": ("mamba", "attn"), "spectral_long_conv": True},
], ids=["hybrid", "xlstm", "xlstm-chunk", "spectral"])
def test_forward_equals_decode(kw):
    cfg = _model_cfg(**kw)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 10
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full, _ = model.forward(params, toks)
    caches = model.init_caches(B, 16, "cpu")
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(params, toks[:, t:t + 1], caches)
        outs.append(lg)
    torch.testing.assert_close(full, torch.cat(outs, 1), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_scan_equals_incremental(mixer):
    _, mod, specs, block = BLOCKS[mixer]
    _, cfg = _configs()
    params = init_params(getattr(mod, specs)(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(1))
    full, _ = getattr(mod, block)(params, x, cfg)
    state, outs = None, []
    for t in range(12):
        yt, state = getattr(mod, block)(params, x[:, t:t + 1], cfg,
                                        state=state)
        outs.append(yt)
    torch.testing.assert_close(full, torch.cat(outs, 1), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("B,S,L", [(2, 32, 8), (1, 64, 16), (2, 48, 12)])
def test_chunked_mlstm_equals_per_step(B, S, L):
    _, cfg = _configs(d_ff=0, block_pattern=("mlstm",))
    params = init_params(xlstm.mlstm_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    x = torch.randn(B, S, 32, generator=torch.Generator().manual_seed(1))
    y0, s0 = xlstm.mlstm_block(params, x, cfg)
    y1, s1 = xlstm.mlstm_block(params, x, cfg.replace(xlstm_chunk=L))
    torch.testing.assert_close(y0, y1, rtol=3e-4, atol=3e-4)
    for k in ("C", "n", "m"):
        torch.testing.assert_close(s0[k], s1[k], rtol=3e-4, atol=3e-4)
    # from a carried state
    y0, _ = xlstm.mlstm_block(params, x[:, L:], cfg, state=s0)
    y1, _ = xlstm.mlstm_block(params, x[:, L:],
                              cfg.replace(xlstm_chunk=L), state=s0)
    torch.testing.assert_close(y0, y1, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm", "spectral"])
def test_state_sizes_constant_in_seq(mixer):
    _, mod, specs, block = BLOCKS[mixer]
    _, cfg = _configs(xlstm_chunk=8)
    params = init_params(getattr(mod, specs)(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    shapes = [{k: v.shape for k, v in getattr(mod, block)(
        params, torch.zeros(2, S, 32), cfg)[1].items()} for S in (4, 64)]
    assert shapes[0] == shapes[1]


# ---------------------------------------------------------------------------
# decode state carried across; the batcher's slot reset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_carried_reference_state_decodes_on(arch):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, True)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = fan_in_init(jax.tree.map(np.asarray, jmodel.init(KEY)),
                          cfg.d_model)
    params = params_from_jax(jparams, cfg, "cpu")
    jp = jax.tree.map(jnp.asarray, jparams)
    step = jax.jit(jmodel.decode_step)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (8, 2, 1))
    jcaches = jmodel.init_caches(2, 8)
    for t in range(4):
        _, jcaches = step(jp, jnp.asarray(toks[t], jnp.int32), jcaches)
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, "cpu")
    for t in range(4, 8):
        want, jcaches = step(jp, jnp.asarray(toks[t], jnp.int32), jcaches)
        got, caches = model.decode_step(params, torch.from_numpy(toks[t]),
                                        caches)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="decode state"):
        caches_from_jax({"states": {}, "pos": np.zeros(2, np.int32)}, cfg,
                        "cpu")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_reused_slot_decodes_as_a_fresh_batcher(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompts, max_new = [[1, 2, 3], [7, 8, 9, 10], [4, 5]], [5, 2, 4]

    def run(ids):
        b = ContinuousBatcher(model, params, max_batch=2, max_seq=16,
                              device="cpu")
        for i in ids:
            b.submit(Request(i, prompts[i], max_new[i]))
        return b, b.run()
    # request 1 finishes first; request 2 takes its slot
    batcher, done = run([0, 1, 2])
    for i in range(3):
        assert done[i] == run([i])[1][i], i
    fresh = model.init_caches(2, 16, "cpu")
    batcher.caches["states"] = tree_map(lambda t: t.clone().fill_(7.0),
                                        batcher.caches["states"])
    batcher.caches["pos"].fill_(5)
    _reset_slot(batcher.caches, fresh, 1)
    for (path, got), (_, want) in zip(tree_leaves(batcher.caches["states"]),
                                      tree_leaves(fresh["states"])):
        assert torch.equal(got[:, 1], want[:, 1]), path
        assert (got[:, 0] == 7.0).all(), path
    assert batcher.caches["pos"].tolist() == [5, 0]
