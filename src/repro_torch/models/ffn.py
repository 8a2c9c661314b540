"""Dense FFN blocks, SwiGLU / GELU-MLP (port of ``repro.models.ffn``).

On a mesh whose ``model`` dim splits the hidden dim (the ``mlp`` rule),
``w1`` / ``w3`` / ``b1`` are column-parallel and ``w2`` row-parallel
(Megatron): the input goes through ``tp_copy``, the ``w2`` product's
partial sums through ``tp_reduce`` (in f32), and ``b2`` is added once,
after it.
"""

from __future__ import annotations

from repro_torch.models.common import ParamSpec, gelu, silu
from repro_torch.models.remat import dot
from repro_torch.parallel.sharding import split_group, tp_copy, tp_reduce
from .config import ModelConfig


def ffn_specs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w1": ParamSpec((D, F), ("embed_fsdp", "mlp")),
            "w3": ParamSpec((D, F), ("embed_fsdp", "mlp")),
            "w2": ParamSpec((F, D), ("mlp", "embed_fsdp")),
        }
    return {
        "w1": ParamSpec((D, F), ("embed_fsdp", "mlp")),
        "b1": ParamSpec((F,), ("mlp",), init="zeros"),
        "w2": ParamSpec((F, D), ("mlp", "embed_fsdp")),
        "b2": ParamSpec((D,), (None,), init="zeros"),
    }


def ffn_block(p, x, cfg: ModelConfig, mesh=None, rules=None):
    """x: (B, S, D) -> (B, S, D); on a mesh that splits the hidden dim,
    over this rank's slice of it, summed over ``model``."""
    cd = cfg.cdtype
    group = split_group(ffn_specs(cfg)["w1"], mesh, rules)
    x = tp_copy(x.to(cd), group)
    if cfg.act == "swiglu":
        h = silu(dot(x, p["w1"].to(cd))) * dot(x, p["w3"].to(cd))
        return row_parallel(h, p["w2"], cd, group)
    h = gelu(dot(x, p["w1"].to(cd)) + p["b1"].to(cd))
    return row_parallel(h, p["w2"], cd, group) + p["b2"].to(cd)


def row_parallel(h, w2, cd, group):
    """``h @ w2`` in ``cd``; under tensor parallelism (``group``: the
    ``model`` group ``w2``'s rows are split over) the partial sums stay
    f32 until they are summed over ``model`` (one rounding, as on one
    device)."""
    if group is None:
        return dot(h, w2.to(cd))
    return tp_reduce(dot(h.float(), w2.to(cd).float()), group).to(cd)
