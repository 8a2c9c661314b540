"""Model construction and the step functions (port of
``repro.models.model_api``: ``build_model``, ``make_loss_fn``,
``make_train_step``, ``make_serve_step``, ``make_prefill_fn``)."""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_with_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model


def build_model(cfg: ModelConfig) -> Model:
    """The decoder-only Model (enc-dec archs are not ported yet)."""
    return Model(cfg)


def make_loss_fn(model):
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def make_train_step(model, optimizer, grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a dict tree of leaves with ``requires_grad``; gradients
    come from ``torch.autograd.grad``, so no ``.grad`` is kept on them, and
    a leaf the loss does not reach raises rather than training on zeros.
    ``grad_accum > 1`` splits the batch into that many microbatches along
    dim 0 and averages their f32 gradients and metrics before one
    optimizer update, as the reference's ``lax.scan`` does.  The optimizer
    updates ``params`` and ``opt_state`` in place and returns them;
    ``metrics`` adds ``grad_norm`` (the pre-clip global norm)."""
    loss_fn = make_loss_fn(model)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        tensors = [t for _, t in leaves]
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, tensors)
        grads = {path: g for (path, _), g in zip(leaves, grads)}
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            grads, metrics = grads_of(params, batch)
        else:
            mbs = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                *v.shape[1:]) for k, v in batch.items()}
            grads, metrics = {}, {}
            for i in range(grad_accum):
                g, m = grads_of(params, {k: v[i] for k, v in mbs.items()})
                for path, gi in g.items():
                    grads[path] = gi.float() + grads.get(path, 0.0)
                for k, v in m.items():
                    metrics[k] = v.float() + metrics.get(k, 0.0)
                del g
            grads = {path: g / grad_accum for path, g in grads.items()}
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        params, opt_state, gnorm = optimizer.update(
            params, tree_with_leaves(params, grads), opt_state)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


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

