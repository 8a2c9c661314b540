"""Weights from the seed, made on the device in the type they are served
in: the program's parameter tree and, leaf by leaf and layer by layer,
the same bits again for the reference.

Every leaf (and every layer of a stacked leaf) has a generator of its
own, seeded from the run's seed and the leaf's path, so the reference
can draw one layer's weights without drawing the rest.  The scales are
fan-in (``1 / sqrt(fan_in)`` of the product's true input width; the
embedding, which the head shares, ``1 / sqrt(d_model)``, so logits start
near unit scale); norm gains are ones.  The tree is the layout of the
port's attention + MoE decoder (``Model.specs()``: superblocks stacked
on a leading dim), written out here so that the reference needs nothing
of the program.
"""

from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run (any whole ``seed``)."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def layer_leaves(model: dict) -> dict:
    """``{path: (shape, std or None for ones, dtype)}`` of one layer of
    the attention + MoE superblock (position 0)."""
    D, Hq, Hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or D // Hq
    E, F = model["n_experts"], model["d_ff"]
    pdt = DTYPES[model.get("param_dtype", "bfloat16")]
    return {
        "norm1/g": ((D,), None, pdt),
        "mixer/wq": ((D, Hq, hd), D ** -0.5, pdt),
        "mixer/wk": ((D, Hkv, hd), D ** -0.5, pdt),
        "mixer/wv": ((D, Hkv, hd), D ** -0.5, pdt),
        "mixer/wo": ((Hq, hd, D), (Hq * hd) ** -0.5, pdt),
        "norm2/g": ((D,), None, pdt),
        "ffn/router": ((D, E), D ** -0.5, torch.float32),
        "ffn/w1": ((E, D, F), D ** -0.5, pdt),
        "ffn/w3": ((E, D, F), D ** -0.5, pdt),
        "ffn/w2": ((E, F, D), F ** -0.5, pdt),
    }


def top_leaves(model: dict) -> dict:
    D, V = model["d_model"], model["vocab"]
    pdt = DTYPES[model.get("param_dtype", "bfloat16")]
    return {"embed": ((V, D), D ** -0.5, pdt),
            "final_norm/g": ((D,), None, pdt)}


def _fill(t: torch.Tensor, std, seed: int, *parts) -> torch.Tensor:
    if std is None:
        return t.fill_(1.0)
    return t.normal_(0.0, std, generator=generator(t.device, seed, *parts))


def top_weights(model: dict, seed: int, device) -> dict:
    """``{path: tensor}`` of the leaves outside the layers."""
    return {path: _fill(torch.empty(shape, dtype=dt, device=device), std,
                        seed, path)
            for path, (shape, std, dt) in top_leaves(model).items()}


def layer_weights(model: dict, seed: int, layer: int, device) -> dict:
    """``{path: tensor}`` of layer ``layer`` (served types)."""
    return {path: _fill(torch.empty(shape, dtype=dt, device=device), std,
                        seed, path, layer)
            for path, (shape, std, dt) in layer_leaves(model).items()}


def leaf(model: dict, seed: int, path: str, device) -> torch.Tensor:
    """One leaf of the program's tree (``blocks/pos0/...`` stacked over
    the layers), drawn as :func:`program_params` draws it."""
    if path.startswith("blocks/pos0/"):
        sub = path[len("blocks/pos0/"):]
        shape, std, dt = layer_leaves(model)[sub]
        L = model["n_layers"]
        t = torch.empty((L,) + shape, dtype=dt, device=device)
        for i in range(L):
            _fill(t[i], std, seed, sub, i)
        return t
    shape, std, dt = top_leaves(model)[path]
    return _fill(torch.empty(shape, dtype=dt, device=device), std, seed, path)


def leaf_paths(model: dict) -> list[str]:
    return [*top_leaves(model)] + [f"blocks/pos0/{p}"
                                   for p in layer_leaves(model)]


def nest(flat: dict) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def program_params(model: dict, seed: int, device) -> dict:
    """The program's nested parameter tree, every leaf drawn on
    ``device``."""
    return nest({p: leaf(model, seed, p, device) for p in leaf_paths(model)})
