"""Model construction and the serving step functions (port of
``repro.models.model_api``: ``build_model``, ``make_serve_step``,
``make_prefill_fn``; training waits for its slice)."""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model


def build_model(cfg: ModelConfig) -> Model:
    """The decoder-only Model (enc-dec archs are not ported yet)."""
    return Model(cfg)


def make_serve_step(model):
    """One greedy decode step: (params, caches, tokens_t) ->
    (next_tokens, logits, caches)."""
    @torch.no_grad()
    def serve_step(params, caches, tokens_t):
        logits, caches = model.decode_step(params, tokens_t, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, logits, caches

    return serve_step


def make_prefill_fn(model):
    """Full-sequence prefill returning last-position logits (B, V) f32."""
    @torch.no_grad()
    def prefill(params, tokens):
        logits, _ = model.forward(params, tokens)
        return logits[:, -1]

    return prefill
