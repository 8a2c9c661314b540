"""Model construction and the step functions (port of
``repro.models.model_api``: ``build_model``, ``make_loss_fn``,
``make_train_step``, ``make_serve_step``, ``make_prefill_fn``).

Each step function takes the reference's ``mesh=None, rules=None``.  On a
``DeviceMesh`` every rank calls it collectively with its row block of
the batch and its parameter shard (``common.param_shardings``): the
experts split over the EP group, heads, the FFN's hidden dim, the
recurrent mixers' channels and the vocab over ``model``, the
``d_model`` dim of the embedding, attention, the dense FFN and the
mixers' projections over the FSDP axes (``pod`` / ``data`` by default,
``model`` under ``embed_fsdp=("model",)``; the model gathers them
before use), the norms and the router whole.  The "batch" rule may
leave EP or FSDP axes out: the ranks that differ only there hold the
same rows (:func:`reduce_grads` counts them).
``make_train_step`` then reduces the gradients with
:func:`reduce_grads` so that every rank steps with its shard of the
one-device gradient of the global batch; ``make_prefill_fn`` and
``make_serve_step`` return full-vocab logits.  ``build_model`` gives the
encoder-decoder archs (``encoder_layers`` > 0: whisper-tiny) an
``EncDecModel``, which splits over a mesh as ``Model`` does (its
``frontend_embeds`` and, in ``make_serve_step``, its ``memory`` are the
rank's rows).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import (param_shardings, tree_leaves,
                                       tree_with_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import batch_group


def build_model(cfg: ModelConfig) -> Model | EncDecModel:
    """The ``EncDecModel`` (whisper) where ``cfg`` has encoder layers,
    else the decoder-only ``Model``."""
    if cfg.encoder_layers > 0:
        return EncDecModel(cfg)
    return Model(cfg)


def make_loss_fn(model, mesh=None, rules=None):
    def loss_fn(params, batch):
        return model.loss(params, batch, mesh=mesh, rules=rules)
    return loss_fn


def reduce_grads(grads, sharding, group):
    """This rank's gradients of its own loss (``Model.loss`` on a mesh) ->
    its shard of the one-device gradient of the global batch, in f32 and
    cast back (collective over the mesh).  ``sharding`` is the
    parameters' ``ExpertSharding`` (``common.param_shardings``) and
    ``group`` the batch group (``parallel.sharding.batch_group``), both
    as ``make_train_step`` holds them; with ``sharding=None`` (no mesh)
    the gradients are returned as they are.

    Each rank's loss is its share of the global mean times the ``n``
    ranks of the batch group (``Model.loss``).  Every leaf's gradient is
    summed over the data-parallel axes (``pod``, ``data``): an expert
    leaf's by the dispatch's backward over the EP group (with replicas,
    ``n_experts`` < G, the copies of an expert are summed first:
    ``ExpertSharding.sum_replicas``), an FSDP leaf's by
    ``parallel.sharding.fsdp_gather``'s reduce-scatter over its kept
    axes and then over the ones they leave out, any other leaf's by an
    all-reduce (``ExpertSharding.sum_dp``).  A ``partial`` leaf (a kv
    projection whose heads the ``model`` ranks share out) is first
    summed over ``model`` (``ExpertSharding.sum_partial``).  The sum is
    then divided by ``n`` times the copies it holds of each row block
    (``ExpertSharding.repeats``): ranks that differ only on axes outside
    the batch rule hold the same rows, so where such an axis is in the
    group (``pod`` under ``batch=("data",)``; ``model`` for an FSDP leaf
    over ``model`` that every ``model`` rank uses whole) each block's
    contribution came once from each of them.  A leaf split over
    ``model`` is this rank's slice (the tensor-parallel Functions
    brought the full cotangent to it); an FSDP leaf over ``model`` whose
    heads or columns the ``model`` ranks share out was summed over parts
    and is not divided for ``model``.  Every rank of a leaf's group ends
    with the same bits.
    """
    if sharding is None:
        return grads
    n = 1 if group is None else group.size
    out = {}
    for path, g in tree_leaves(grads):
        g32 = sharding.sum_partial(path, g.float())
        g32 = sharding.sum_dp(path, sharding.sum_replicas(path, g32))
        out[path] = (g32 / (n * sharding.repeats(path))).to(g.dtype)
    return tree_with_leaves(grads, out)


def _mean_metrics(metrics: dict, group) -> dict:
    """The metrics averaged over the batch group ``group`` (what the
    global batch gives), in one all-reduce."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked, group=group.pg)
    return dict(zip(keys, (stacked / group.size).unbind(0)))


def make_train_step(model, optimizer, mesh=None, rules=None,
                    grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a dict tree of leaves with ``requires_grad``; gradients
    come from ``torch.autograd.grad``, so no ``.grad`` is kept on them, and
    a leaf the loss does not reach raises rather than training on zeros.
    ``grad_accum > 1`` splits the batch into that many microbatches along
    dim 0 and averages their f32 gradients and metrics before one
    optimizer update, as the reference's ``lax.scan`` does.  The optimizer
    updates ``params`` and ``opt_state`` in place and returns them;
    ``metrics`` adds ``grad_norm`` (the pre-clip global norm).

    On a mesh the gradients go through :func:`reduce_grads` after
    ``torch.autograd.grad`` has returned (no collective runs from a hook
    inside it), the metrics are averaged over the batch group, and the
    norm is the global tree's (``optim.global_norm`` with the
    parameters' sharding): every rank logs and clips as one device
    would."""
    loss_fn = make_loss_fn(model, mesh, rules)
    sharding = group = None
    if mesh is not None:
        model.check_mesh(mesh)
        sharding = param_shardings(model.specs(), mesh, rules)
        group = batch_group(mesh, rules)

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
        grads = tree_with_leaves(params, grads)
        if mesh is not None:
            grads = reduce_grads(grads, sharding, group)
            metrics = _mean_metrics(metrics, group)
        params, opt_state, gnorm = optimizer.update(params, grads, opt_state,
                                                    sharding=sharding)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def make_serve_step(model, mesh=None, rules=None):
    """One greedy decode step: (params, caches, tokens_t[, memory]) ->
    (next_tokens, logits, caches); ``memory`` is the encoder-decoder's
    (``EncDecModel.encode``)."""
    @torch.no_grad()
    def serve_step(params, caches, tokens_t, memory=None):
        if memory is not None:
            logits, caches = model.decode_step(params, tokens_t, caches,
                                               memory, mesh=mesh,
                                               rules=rules)
        else:
            logits, caches = model.decode_step(params, tokens_t, caches,
                                               mesh=mesh, rules=rules)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, logits, caches

    return serve_step


def make_prefill_fn(model, mesh=None, rules=None):
    """Full-sequence prefill returning last-position logits (B, V) f32
    (gathered over ``model`` on a mesh that splits the vocab); a frontend
    or encoder-decoder model takes its ``frontend_embeds``."""
    @torch.no_grad()
    def prefill(params, tokens, frontend_embeds=None):
        if frontend_embeds is not None:
            logits, _ = model.forward(params, tokens, mesh=mesh,
                                      rules=rules,
                                      frontend_embeds=frontend_embeds)
        else:
            logits, _ = model.forward(params, tokens, mesh=mesh,
                                      rules=rules)
        last = logits[:, -1].contiguous()
        if mesh is None:
            return last
        return model.full_logits(last, mesh=mesh, rules=rules)

    return prefill
