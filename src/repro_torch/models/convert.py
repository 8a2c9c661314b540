"""Carry a parameter tree of the JAX reference into the port.

``params_from_jax`` takes the reference's parameter tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``
on the caller's side; this module imports no jax) and returns the port's
tree of tensors.  The two packages share names and layouts leaf for leaf,
so the conversion is a checked copy: every leaf's shape and dtype must
match the port's spec, and a missing or extra leaf raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import is_spec, tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import build_model

_NP_DTYPES = {"float32": torch.float32, "float16": torch.float16,
              "bfloat16": torch.bfloat16}


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device):
    """The reference's parameter tree (numpy leaves) -> the port's."""
    specs = build_model(cfg).specs()
    want = dict(tree_leaves(specs))
    got = dict(tree_leaves(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    for path, spec in want.items():
        a = got[path]
        dtype = spec.dtype or cfg.pdtype
        have = _NP_DTYPES.get(np.asarray(a).dtype.name)
        if tuple(np.shape(a)) != tuple(spec.shape) or have != dtype:
            raise ValueError(
                f"{path}: got {np.shape(a)} {np.asarray(a).dtype}, want "
                f"{tuple(spec.shape)} {dtype}")

    return tree_map(lambda path: _to_tensor(np.asarray(got[path]), device),
                    _paths(specs))


def _paths(specs, prefix: str = ""):
    """The spec tree with each leaf replaced by its path."""
    if is_spec(specs):
        return prefix
    return {k: _paths(v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in specs.items()}
