"""Carry a parameter tree, or an AdamW state, of the JAX reference into
the port.

``params_from_jax`` takes the reference's parameter tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``
on the caller's side; this module imports no jax) and returns the port's
tree of tensors.  The two packages share names and layouts leaf for leaf,
so the conversion is a checked copy: every leaf's shape and dtype must
match the port's spec, and a missing or extra leaf raises.
``opt_state_from_jax`` does the same for the reference's AdamW state
``{"mu", "nu", "step"}``: moments shaped like the parameters, in the
moment dtype, and the int32 step; ``caches_from_jax`` for a decode-state
tree (``Model.init_caches``'s: KV caches, recurrent states, positions).

Given a ``DeviceMesh``, both take the reference's *global* tree and
return this rank's shard (``common.param_shardings``): the experts'
slice of the EP group, the ``model`` slices, and the FSDP block of the
``d_model`` dim (``pod * |data| + data``, the reference's ``P(("pod",
"data"))`` order); the norms and the router whole.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import (ParamSpec, is_spec,
                                       param_shardings, tree_leaves, tree_map)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import build_model

_NP_DTYPES = {"float32": torch.float32, "float16": torch.float16,
              "bfloat16": torch.bfloat16, "int32": torch.int32}


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _checked(tree, specs, dtype_of, what: str, device):
    """Copy ``tree``'s numpy leaves to tensors after checking that its
    paths are ``specs``' and each leaf has the spec's shape and the dtype
    ``dtype_of(spec)``."""
    want = dict(tree_leaves(specs))
    got = dict(tree_leaves(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what} trees differ: missing {missing}, "
                         f"extra {extra}")
    for path, spec in want.items():
        a = got[path]
        dtype = dtype_of(spec)
        have = _NP_DTYPES.get(np.asarray(a).dtype.name)
        if tuple(np.shape(a)) != tuple(spec.shape) or have != dtype:
            raise ValueError(
                f"{what} {path}: got {np.shape(a)} {np.asarray(a).dtype}, "
                f"want {tuple(spec.shape)} {dtype}")
    return tree_map(lambda path: _to_tensor(np.asarray(got[path]), device),
                    _paths(specs))


def _shard(tree, specs, mesh, rules):
    if mesh is None:
        return tree
    return param_shardings(specs, mesh, rules).shard_tree(tree)


def _specs(cfg: ModelConfig, mesh):
    model = build_model(cfg)
    model.check_mesh(mesh)
    return model.specs()


def params_from_jax(tree, cfg: ModelConfig, device, mesh=None, rules=None):
    """The reference's parameter tree (numpy leaves) -> the port's (this
    rank's shard of it on a mesh)."""
    specs = _specs(cfg, mesh)
    return _shard(_checked(tree, specs,
                           lambda spec: spec.dtype or cfg.pdtype,
                           "parameter", device), specs, mesh, rules)


def opt_state_from_jax(state, params_cfg: ModelConfig, device, mesh=None,
                       rules=None):
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves)
    -> the port's: the f32 moments checked leaf for leaf against the
    parameter specs of ``params_cfg`` (this rank's shard on a mesh), the
    step a 0-d int32 tensor."""
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"AdamW state has keys {sorted(state)}, want "
                         f"['mu', 'nu', 'step']")
    specs = _specs(params_cfg, mesh)
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: got {step.shape} {step.dtype}, want () "
                         f"int32")
    return {name: _shard(_checked(state[name], specs,
                                  lambda spec: torch.float32, name, device),
                         specs, mesh, rules) for name in ("mu", "nu")} | {
        "step": torch.tensor(int(step), dtype=torch.int32, device=device)}


def caches_from_jax(caches, cfg: ModelConfig, device):
    """The reference's decode-state tree (``init_caches`` / ``decode_step``
    output, numpy leaves) -> the port's, each leaf checked against the
    shape and dtype of the port's ``init_caches`` for the same batch and
    cache length (no mesh): per-position states (``Model``) or the
    encoder-decoder's stacked ``k`` / ``v`` / ``slot_pos``."""
    B = np.shape(caches["pos"])[0]
    slots = [np.shape(a)[-2] for path, a in tree_leaves(caches["states"])
             if path.rsplit("/", 1)[-1] == "k"]
    model = build_model(cfg)
    like = model.init_caches(B, max(slots, default=1), "meta")
    specs = tree_map(lambda t: ParamSpec(tuple(t.shape), (), dtype=t.dtype),
                     like)
    return _checked(caches, specs, lambda spec: spec.dtype,
                    "decode state", device)


def _paths(specs, prefix: str = ""):
    """The spec tree with each leaf replaced by its path."""
    if is_spec(specs):
        return prefix
    return {k: _paths(v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in specs.items()}
