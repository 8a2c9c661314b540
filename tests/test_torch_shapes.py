"""The shape cells of the port (``repro_torch.configs.shapes``) against
the reference's (``repro.configs.shapes``): for every arch x shape x
``reduced``, ``applicable`` gives the same verdict and reason, and
``input_specs`` the same keys, shapes and dtypes, the port's as tensors
on the ``meta`` device where the reference gives ``ShapeDtypeStruct``;
a decode cell's ints are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro_torch.configs import (ARCH_NAMES, SHAPES, applicable, get_config,
                                 input_specs)

_DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32}


def test_cells_match_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, cell in SHAPES.items():
        ref = JAX_SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    runs = [(a, s) for a in ARCH_NAMES for s in SHAPES
            if applicable(get_config(a), SHAPES[s])[0]]
    assert len(ARCH_NAMES) * len(SHAPES) == 40 and len(runs) == 33
    assert {a for a, s in runs if s == "long_500k"} == {
        "jamba-v0.1-52b", "xlstm-1.3b", "h2o-danube-1.8b"}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_applicable_and_input_specs_match_reference(arch, shape, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert applicable(cfg, SHAPES[shape]) == \
        jax_applicable(jcfg, JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape], reduced=reduced)
    want = jax_input_specs(jcfg, JAX_SHAPES[shape], reduced=reduced)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            assert g == w and type(g) is int, key
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "meta", key
        assert tuple(g.shape) == tuple(w.shape), key
        assert np.dtype(_DTYPES[g.dtype]) == np.dtype(w.dtype), key
