"""Shared set-up of the archs' parity tests (``test_torch_archs.py``,
``test_torch_archs_train.py``): the cases, each case's reference and
port parameters on the same weights, and the stub frontend's inputs.

The recurrent archs (jamba-v0.1-52b, xlstm-1.3b) run on the reference's
init rescaled to fan-in (:func:`fan_in_init`).  Their SMOKE configs are
one superblock deep, so the reference's init (std 1 / sqrt(leading dim),
the layer count 1 for a stacked leaf) draws every weight at std 1, and
there the reference is too ill-conditioned for a 1e-4 comparison to
mean anything: flipping the last bit of each of its own f32 parameters
moves its forward logits by more than 1e-4 of the largest, and at the
fan-in init by less (``test_torch_archs.py::
test_recurrent_cases_need_the_fan_in_init``).
"""

import functools
import math

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax

RECURRENT_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
ARCHS = ("deepseek-7b", "internlm2-20b", "qwen2.5-3b", "h2o-danube-1.8b",
         "grok-1-314b", "internvl2-2b", *RECURRENT_ARCHS)
# case -> (arch, changes to its SMOKE config)
CASES = {**{a: (a, {}) for a in ARCHS},
         "internlm2-20b-g6": ("internlm2-20b",
                              dict(d_model=192, n_heads=12, n_kv_heads=2)),
         "h2o-danube-1.8b-dh80": ("h2o-danube-1.8b",
                                  dict(d_model=160, n_heads=2,
                                       n_kv_heads=1)),
         # chunks of 8 divide the tests' S = 16: the chunkwise mLSTM
         "xlstm-1.3b-chunk8": ("xlstm-1.3b", dict(xlstm_chunk=8))}

# the projections whose fan-in is their second-to-last dim
_PROJECTIONS = ("w1", "w2", "w3", "in_proj", "x_proj", "dt_proj", "out_proj",
                "conv_w", "up", "down", "wif", "w_gates", "r_gates", "up1",
                "up2")


def fan_in_init(tree, d_model: int):
    """The reference tree (numpy leaves) with every matmul weight rescaled
    from the reference's std 1 / sqrt(leading dim) to 1 / sqrt(its
    contraction size), and the tied embedding to 1 / sqrt(d_model)."""
    def walk(t):
        out = {}
        for k, v in t.items():
            a = v if isinstance(v, dict) else np.asarray(v)
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "embed":
                out[k] = (a / math.sqrt(d_model)).astype(a.dtype)
            elif k in ("wq", "wk", "wv", "router", "wo") + _PROJECTIONS:
                fan = a.shape[1] if k in ("wq", "wk", "wv", "router") \
                    else math.prod(a.shape[1:-1]) if k == "wo" \
                    else a.shape[-2]
                out[k] = (a * math.sqrt(a.shape[0] / fan)).astype(a.dtype)
            else:
                out[k] = a
        return out
    return walk(tree)


def with_random_biases(tree, seed: int):
    """The reference tree with every attention bias leaf (``bq``, ``bk``,
    ``bv``; zero at the reference's init) drawn from numpy."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(np.shape(v)).astype(np.float32)
                 if k in ("bq", "bk", "bv") else np.asarray(v))
                for k, v in t.items()}
    return walk(tree)


def frontend_embeds(cfg, batch: int, seed: int = 8):
    """Stub frontend embeddings (batch, n_frontend_tokens, d_model) from
    numpy for a config with a frontend (internvl2-2b's patches), else
    None."""
    if cfg.frontend is None:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def configs(case: str, impl: str):
    """(reference config, port config) of ``case``."""
    arch, changes = CASES[case]
    return (jax_get_config(arch, smoke=True).replace(attention_impl=impl,
                                                     **changes),
            get_config(arch, smoke=True).replace(**changes))


@functools.cache
def case_setup(case: str, impl: str = "pallas_interpret"):
    """(reference config, its numpy params, port config, port params)."""
    jcfg, cfg = configs(case, impl)
    jparams = with_random_biases(jax.tree.map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))), 7)
    if CASES[case][0] in RECURRENT_ARCHS:
        jparams = fan_in_init(jparams, cfg.d_model)
    return jcfg, jparams, cfg, params_from_jax(jparams, cfg, "cpu")
