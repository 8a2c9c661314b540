"""Dense FFN blocks, SwiGLU / GELU-MLP (port of ``repro.models.ffn``)."""

from __future__ import annotations

from repro_torch.models.common import ParamSpec, gelu, silu
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


def ffn_block(p, x, cfg: ModelConfig):
    cd = cfg.cdtype
    x = x.to(cd)
    if cfg.act == "swiglu":
        h = silu(x @ p["w1"].to(cd)) * (x @ p["w3"].to(cd))
        return h @ p["w2"].to(cd)
    h = gelu(x @ p["w1"].to(cd) + p["b1"].to(cd))
    return h @ p["w2"].to(cd) + p["b2"].to(cd)
