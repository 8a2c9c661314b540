"""Shared set-up of the attention-only archs' parity tests
(``test_torch_archs.py``, ``test_torch_archs_train.py``): the cases, and
each case's reference and port parameters on the same weights."""

import functools

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax

ARCHS = ("deepseek-7b", "internlm2-20b", "qwen2.5-3b", "h2o-danube-1.8b",
         "grok-1-314b")
# case -> (arch, changes to its SMOKE config)
CASES = {**{a: (a, {}) for a in ARCHS},
         "internlm2-20b-g6": ("internlm2-20b",
                              dict(d_model=192, n_heads=12, n_kv_heads=2)),
         "h2o-danube-1.8b-dh80": ("h2o-danube-1.8b",
                                  dict(d_model=160, n_heads=2,
                                       n_kv_heads=1))}


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
    return jcfg, jparams, cfg, params_from_jax(jparams, cfg, "cpu")
