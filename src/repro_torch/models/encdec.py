"""Encoder-decoder model, the whisper-tiny backbone (port of
``repro.models.encdec``).

Encoder: bidirectional transformer over precomputed frame embeddings (the
conv frontend is a stub: ``configs.shapes.input_specs`` gives (B,
n_frames, D) features), each through ``frontend_proj``.  Decoder: causal
self-attention, cross-attention on the encoder's memory, GELU FFN;
LayerNorm throughout, sinusoidal positions (no RoPE), f32 logits against
the tied embedding.  Where the reference scans over the stacked layers,
the port loops in Python; under ``cfg.remat`` and autograd each layer
runs inside ``models.remat.checkpointed`` with ``cfg.remat_policy``, as
the reference checkpoints each scanned layer.

All attention goes through ``kernels.ops.attention`` (the flash kernel on
a card): the encoder's non-causal self-attention, the decoder's causal
one, and the cross-attention with Sq != Skv; in ``decode_step`` the
self-attention is the KV-cache decode (plain torch, written in place)
and the cross-attention is recomputed from ``memory`` every tick, as in
the reference.

On a ``DeviceMesh`` (what the reference's GSPMD makes of its rules) every
rank calls each method collectively with its row block of the batch
(the frames, the tokens, and in ``decode_step`` the memory) and its
parameter shard (``common.param_shardings``), as ``models.transformer
.Model`` does, with which it shares the FSDP layout, the vocab-parallel
embedding and head and the loss's mean (``transformer.ModelBase``):

* tensor parallelism over ``model``: the encoder's, the decoder's and the
  cross-attention's heads (``attention.head_layout``'s cases), the GELU
  FFN's hidden dim, and the tied embedding's vocab where the resolver
  splits it (whisper-tiny's 51865 stays whole);
* FSDP over the ``embed_fsdp`` axes: ``frontend_proj`` and the embedding
  gathered once per ``encode`` / ``forward`` / ``decode_step``, each
  layer's leaves inside its remat (``ExpertSharding.gather_params`` with
  the ``encoder`` / ``decoder`` prefix);
* Ulysses (``cfg.use_ulysses``): the encoder's frames and the decoder's
  tokens split over ``model`` in each self- and cross-attention, the
  attention leaves whole over ``model``; the memory is whole on every
  rank.  ``check_mesh`` refuses query heads or frames that ``model``
  does not divide, ``forward`` decoder tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.cache import mesh_shape
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models.common import (ParamSpec, init_params, layer_norm,
                                       resolve_device, sinusoidal_positions,
                                       stack_specs, tree_map)
from repro_torch.models.transformer import ModelBase, _layer
from repro_torch.parallel.ulysses import check_lengths
from .config import ModelConfig


def _ln_specs(cfg):
    return {"g": ParamSpec((cfg.d_model,), (None,), init="ones"),
            "b": ParamSpec((cfg.d_model,), (None,), init="zeros")}


def _enc_layer_specs(cfg):
    return {"ln1": _ln_specs(cfg), "attn": attn.attn_specs(cfg),
            "ln2": _ln_specs(cfg), "ffn": ffn_mod.ffn_specs(cfg)}


def _dec_layer_specs(cfg):
    return {"ln1": _ln_specs(cfg), "self_attn": attn.attn_specs(cfg),
            "ln_x": _ln_specs(cfg), "cross_attn": attn.attn_specs(cfg),
            "ln2": _ln_specs(cfg), "ffn": ffn_mod.ffn_specs(cfg)}


def _ln(p, x):
    return layer_norm(x, p["g"], p["b"])


def _enc_layer(lp, x, cfg, mesh, rules, fsdp):
    if fsdp is not None:
        lp = fsdp.gather_params(lp, "encoder", drop=1)
    x = x + attn.attention_block(lp["attn"], _ln(lp["ln1"], x), cfg,
                                 causal=False, mesh=mesh,
                                 rules=rules).to(x.dtype)
    return x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x), cfg, mesh,
                                 rules).to(x.dtype)


def _dec_layer(lp, x, memory, cfg, mesh, rules, fsdp):
    if fsdp is not None:
        lp = fsdp.gather_params(lp, "decoder", drop=1)
    x = x + attn.attention_block(lp["self_attn"], _ln(lp["ln1"], x), cfg,
                                 causal=True, mesh=mesh,
                                 rules=rules).to(x.dtype)
    x = x + attn.cross_attention_block(lp["cross_attn"], _ln(lp["ln_x"], x),
                                       memory, cfg, mesh,
                                       rules).to(x.dtype)
    return x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x), cfg, mesh,
                                 rules).to(x.dtype)


@dataclass
class EncDecModel(ModelBase):
    cfg: ModelConfig
    # the parameters' layout per (mesh, rules) where FSDP splits a leaf
    _fsdp_layouts: dict = field(default_factory=dict, init=False,
                                repr=False, compare=False)

    def check_mesh(self, mesh) -> None:
        """Refuse a mesh (a ``DeviceMesh`` or ``{dim: size}``) on which
        Ulysses over ``model`` cannot share out the query heads or the
        frames (``ValueError`` naming both numbers); every split of the
        encoder-decoder is ported."""
        if mesh is None:
            return
        shape = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
        check_lengths(self.cfg, shape,
                      {"the frame count": self.cfg.n_frontend_tokens})

    def specs(self):
        cfg = self.cfg
        return {
            "embed": ParamSpec((cfg.vocab, cfg.d_model),
                               ("vocab", "embed_fsdp"), init="embed",
                               scale=1.0),
            "frontend_proj": ParamSpec((cfg.d_model, cfg.d_model),
                                       ("embed_fsdp", None)),
            "encoder": stack_specs(_enc_layer_specs(cfg),
                                   cfg.encoder_layers, None),
            "enc_norm": _ln_specs(cfg),
            "decoder": stack_specs(_dec_layer_specs(cfg), cfg.n_layers,
                                   None),
            "final_norm": _ln_specs(cfg),
        }

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from ``generator`` (on ``device``)."""
        return init_params(self.specs(), generator, resolve_device(device),
                           self.cfg.pdtype)

    def _layers(self, fn, stacked, n: int, x, *extra, mesh=None,
                rules=None, fsdp=None):
        """``fn(layer i's params, x, *extra, cfg, mesh, rules, fsdp)`` over
        the n stacked layers (their FSDP leaves gathered inside ``fn``),
        each checkpointed under ``cfg.remat`` and autograd."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(n):
            lp = _layer(stacked, i)
            if remat:
                x = remat_mod.checkpointed(fn, lp, x, *extra, cfg, mesh,
                                           rules, fsdp,
                                           policy=cfg.remat_policy)
            else:
                x = fn(lp, x, *extra, cfg, mesh, rules, fsdp)
        return x

    def _positions(self, S: int, device):
        return sinusoidal_positions(S, self.cfg.d_model, device) \
            .to(self.cfg.cdtype)

    # ---- encoder ----
    def encode(self, params, frontend_embeds, *, mesh=None, rules=None):
        """frontend_embeds: (B, n_frames, D) -> memory (B, n_frames, D) in
        the compute dtype (on a mesh, this rank's rows of both)."""
        fsdp = self._checked(mesh, rules, frontend_embeds.shape[1])
        return self._encode(self._whole(params, fsdp, ["frontend_proj"]),
                            frontend_embeds, mesh, rules, fsdp)

    def _checked(self, mesh, rules, frames: int, tokens: int | None = None):
        """The FSDP layout on ``mesh`` after the Ulysses checks of these
        frames and decoder tokens (raised before anything runs)."""
        if mesh is not None:
            lengths = {"the frame count": frames}
            if tokens is not None:
                lengths["the decoder tokens S"] = tokens
            check_lengths(self.cfg, mesh_shape(mesh), lengths)
        return self.fsdp_layout(mesh, rules)

    def _encode(self, params, frontend_embeds, mesh, rules, fsdp):
        """:meth:`encode` with ``frontend_proj`` already whole."""
        cfg, cd = self.cfg, self.cfg.cdtype
        x = frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)
        x = x + self._positions(x.shape[1], x.device)
        x = self._layers(_enc_layer, params["encoder"], cfg.encoder_layers,
                         x, mesh=mesh, rules=rules, fsdp=fsdp)
        return _ln(params["enc_norm"], x)

    def _head(self, params, x, mesh, rules):
        return self.logits(params, _ln(params["final_norm"], x), mesh=mesh,
                           rules=rules)

    # ---- decoder (full sequence: train / scoring) ----
    def forward(self, params, tokens, *, frontend_embeds, mesh=None,
                rules=None):
        """tokens (B, S), frontend_embeds (B, n_frames, D) -> (logits (B,
        S, V) f32, aux 0); on a mesh that splits the vocab, this rank's
        (B, S, V / |model|) columns."""
        fsdp = self._checked(mesh, rules, frontend_embeds.shape[1],
                             tokens.shape[1])
        params = self._whole(params, fsdp, ["embed", "frontend_proj"])
        memory = self._encode(params, frontend_embeds, mesh, rules, fsdp)
        x = self.embed(params, tokens, mesh=mesh, rules=rules)
        x = x + self._positions(x.shape[1], x.device)
        x = self._layers(_dec_layer, params["decoder"], self.cfg.n_layers,
                         x, memory, mesh=mesh, rules=rules, fsdp=fsdp)
        return self._head(params, x, mesh, rules), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, *, mesh=None, rules=None):
        """The mean cross-entropy over every position (no mask, as the
        reference); metrics ``ce_loss`` / ``aux_loss`` / ``total_loss``.
        On a mesh each rank's loss is its row block's share of the global
        mean times the batch group's size, as ``Model.loss``'s."""
        logits, aux = self.forward(
            params, batch["tokens"],
            frontend_embeds=batch["frontend_embeds"], mesh=mesh, rules=rules)
        loss = self._mean_ce(logits, batch["labels"], mesh=mesh, rules=rules)
        return loss, {"ce_loss": loss, "aux_loss": aux, "total_loss": loss}

    # ---- decode: the self-attention's KV cache + the encoder memory ----
    def init_caches(self, batch: int, max_seq: int, device="cuda", *,
                    mesh=None, rules=None):
        """``{"states": {"k", "v", "slot_pos"}`` stacked (n_layers, B, ...),
        ``"pos"}``; every layer its own storage (``decode_step`` writes
        the caches in place).  On a mesh the kv heads this rank's
        self-attention uses (``attention.head_layout``: every kv head
        under Ulysses, whose decode runs whole attention)."""
        self.check_mesh(mesh)
        cfg = self.cfg
        device = resolve_device(device)
        n_kv = attn.head_layout(cfg, mesh, rules).n_kv
        one = attn.init_cache(attn.CacheSpec(batch, n_kv, max_seq, cfg.hd,
                                             cfg.cdtype), device)
        states = tree_map(
            lambda a: a[None].repeat((cfg.n_layers,) + (1,) * a.dim()), one)
        return {"states": states,
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def decode_step(self, params, tokens_t, caches, memory, *, mesh=None,
                    rules=None):
        """tokens_t (B, 1), memory (B, n_frames, D) from :meth:`encode`
        (on a mesh, this rank's rows of both) -> (logits (B, 1, V) f32,
        full-vocab on a mesh too, caches); the KV caches are updated in
        place, ``pos`` is a new tensor."""
        cfg = self.cfg
        fsdp = self.fsdp_layout(mesh, rules)
        params = self._whole(params, fsdp, ["embed"])
        x = self.embed(params, tokens_t, mesh=mesh, rules=rules)
        pos = caches["pos"]
        table = sinusoidal_positions(caches["states"]["k"].shape[3],
                                     cfg.d_model, x.device)
        row = torch.clamp(pos.long(), max=table.shape[0] - 1)
        x = x + table[row][:, None].to(cfg.cdtype)
        for i in range(cfg.n_layers):
            lp = _layer(params["decoder"], i)
            if fsdp is not None:
                lp = fsdp.gather_params(lp, "decoder", drop=1)
            st = _layer(caches["states"], i)
            y, _ = attn.decode_attention(lp["self_attn"], _ln(lp["ln1"], x),
                                         st, pos, cfg, mesh, rules)
            x = x + y.to(x.dtype)
            x = x + attn.cross_attention_block(
                lp["cross_attn"], _ln(lp["ln_x"], x), memory, cfg, mesh,
                rules, decode=True).to(x.dtype)
            x = x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x), cfg,
                                      mesh, rules).to(x.dtype)
        logits = self._head(params, x, mesh, rules)
        return self.full_logits(logits, mesh=mesh, rules=rules), {
            "states": caches["states"], "pos": pos + 1}
