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
the reference.  The encoder-decoder runs without a mesh only
(:meth:`EncDecModel.check_mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models.common import (ParamSpec, init_params, layer_norm,
                                       resolve_device, sinusoidal_positions,
                                       softmax_cross_entropy, stack_specs,
                                       tree_map)
from repro_torch.models.transformer import _layer
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


def _enc_layer(lp, x, cfg):
    x = x + attn.attention_block(lp["attn"], _ln(lp["ln1"], x), cfg,
                                 causal=False).to(x.dtype)
    return x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x),
                                 cfg).to(x.dtype)


def _dec_layer(lp, x, memory, cfg):
    x = x + attn.attention_block(lp["self_attn"], _ln(lp["ln1"], x), cfg,
                                 causal=True).to(x.dtype)
    x = x + attn.cross_attention_block(lp["cross_attn"], _ln(lp["ln_x"], x),
                                       memory, cfg).to(x.dtype)
    return x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x),
                                 cfg).to(x.dtype)


@dataclass
class EncDecModel:
    cfg: ModelConfig

    def check_mesh(self, mesh) -> None:
        """Refuse a mesh: the encoder-decoder's split (FSDP of
        ``frontend_proj``, tensor or sequence parallelism of its layers)
        is not ported yet."""
        if mesh is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the encoder-decoder runs without a mesh "
                f"only; its split over a mesh is ROADMAP.md queue 1, 'the "
                f"frontend and encoder-decoder archs on a mesh'")

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

    def _layers(self, fn, stacked, n: int, x, *extra):
        """``fn(layer i's params, x, *extra, cfg)`` over the n stacked
        layers, each checkpointed under ``cfg.remat`` and autograd."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(n):
            lp = _layer(stacked, i)
            if remat:
                x = remat_mod.checkpointed(fn, lp, x, *extra, cfg,
                                           policy=cfg.remat_policy)
            else:
                x = fn(lp, x, *extra, cfg)
        return x

    def _positions(self, S: int, device):
        return sinusoidal_positions(S, self.cfg.d_model, device) \
            .to(self.cfg.cdtype)

    # ---- encoder ----
    def encode(self, params, frontend_embeds, *, mesh=None, rules=None):
        """frontend_embeds: (B, n_frames, D) -> memory (B, n_frames, D) in
        the compute dtype."""
        self.check_mesh(mesh)
        cfg, cd = self.cfg, self.cfg.cdtype
        x = frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)
        x = x + self._positions(x.shape[1], x.device)
        x = self._layers(_enc_layer, params["encoder"], cfg.encoder_layers,
                         x)
        return _ln(params["enc_norm"], x)

    def _logits(self, params, x):
        cd = self.cfg.cdtype
        x = _ln(params["final_norm"], x)
        return torch.einsum("bsd,vd->bsv", x.to(cd).float(),
                            params["embed"].to(cd).float())

    # ---- decoder (full sequence: train / scoring) ----
    def forward(self, params, tokens, *, frontend_embeds, mesh=None,
                rules=None):
        """tokens (B, S), frontend_embeds (B, n_frames, D) -> (logits (B,
        S, V) f32, aux 0)."""
        memory = self.encode(params, frontend_embeds, mesh=mesh, rules=rules)
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(cfg.cdtype)
        x = x + self._positions(x.shape[1], x.device)
        x = self._layers(_dec_layer, params["decoder"], cfg.n_layers, x,
                         memory)
        return self._logits(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, *, mesh=None, rules=None):
        """The mean cross-entropy over every position (no mask, as the
        reference); metrics ``ce_loss`` / ``aux_loss`` / ``total_loss``."""
        logits, aux = self.forward(
            params, batch["tokens"],
            frontend_embeds=batch["frontend_embeds"], mesh=mesh, rules=rules)
        loss = torch.mean(softmax_cross_entropy(logits, batch["labels"],
                                                self.cfg.z_loss))
        return loss, {"ce_loss": loss, "aux_loss": aux, "total_loss": loss}

    # ---- decode: the self-attention's KV cache + the encoder memory ----
    def init_caches(self, batch: int, max_seq: int, device="cuda", *,
                    mesh=None, rules=None):
        """``{"states": {"k", "v", "slot_pos"}`` stacked (n_layers, B, ...),
        ``"pos"}``; every layer its own storage (``decode_step`` writes
        the caches in place)."""
        self.check_mesh(mesh)
        cfg = self.cfg
        device = resolve_device(device)
        one = attn.init_cache(attn.CacheSpec(batch, cfg.n_kv_heads, max_seq,
                                             cfg.hd, cfg.cdtype), device)
        states = tree_map(
            lambda a: a[None].repeat((cfg.n_layers,) + (1,) * a.dim()), one)
        return {"states": states,
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def decode_step(self, params, tokens_t, caches, memory, *, mesh=None,
                    rules=None):
        """tokens_t (B, 1), memory (B, n_frames, D) from :meth:`encode` ->
        (logits (B, 1, V) f32, caches); the KV caches are updated in
        place, ``pos`` is a new tensor."""
        self.check_mesh(mesh)
        cfg = self.cfg
        x = params["embed"][tokens_t.long()].to(cfg.cdtype)
        pos = caches["pos"]
        table = sinusoidal_positions(caches["states"]["k"].shape[3],
                                     cfg.d_model, x.device)
        row = torch.clamp(pos.long(), max=table.shape[0] - 1)
        x = x + table[row][:, None].to(cfg.cdtype)
        for i in range(cfg.n_layers):
            lp = _layer(params["decoder"], i)
            st = _layer(caches["states"], i)
            y, _ = attn.decode_attention(lp["self_attn"],
                                         _ln(lp["ln1"], x), st, pos, cfg)
            x = x + y.to(x.dtype)
            x = x + attn.cross_attention_block(
                lp["cross_attn"], _ln(lp["ln_x"], x), memory,
                cfg).to(x.dtype)
            x = x + ffn_mod.ffn_block(lp["ffn"], _ln(lp["ln2"], x),
                                      cfg).to(x.dtype)
        return self._logits(params, x), {"states": caches["states"],
                                         "pos": pos + 1}
