"""Transformer stack and the Model API (port of
``repro.models.transformer``).

Parameters of the repeating (mixer, ffn) superblock are stacked
``(n_superblocks, ...)`` as in the reference; where the reference scans
over them, the port loops in Python.  The mixers are attention, mamba,
mLSTM, sLSTM and the spectral long convolution (``models.mamba``,
``models.xlstm``, ``models.spectral``).  A model with a stub frontend
(``cfg.frontend``: internvl2-2b's ViT) takes precomputed
``frontend_embeds`` (B, n_frontend_tokens, D) in ``forward`` / ``loss``,
projects them through ``frontend_proj`` and puts them before the token
embeddings; the encoder-decoder is ``models.encdec``.

Modes:
  * ``forward``     — full-sequence (train / prefill), returns f32 logits.
    Under autograd with ``cfg.remat`` each superblock runs inside
    ``torch.utils.checkpoint`` (non-reentrant), so backward recomputes its
    forward instead of keeping its activations, under ``cfg.remat_policy``
    (``models.remat``): ``nothing`` keeps nothing (kernels and the MoE's
    exchanges run again), ``dots`` keeps the products without batch dims
    (projections, router, dense FFN), ``collectives`` the MoE's exchange
    results (``moe_recv``, ``moe_back``), so its recompute exchanges
    nothing.
  * ``loss``        — masked mean cross-entropy plus the router aux loss.
  * ``decode_step`` — one token per batch slot with per-layer KV caches
    and recurrent states, which it updates in place.

Each takes ``mesh=None, rules=None`` as the reference does and hands them
to the attention, recurrent, FFN and MoE layers.  On a ``DeviceMesh``
every rank calls them collectively with its row block of the batch and
its parameter shard (``models.common.param_shardings``); the ranks issue
the same collectives in the same order, the remat recompute's included.
The recurrent mixers split their channels or heads over ``model`` as
their modules say (their decode states too: ``init_caches``), with or
without ``use_ulysses``: the residual stream is whole between blocks,
each Ulysses attention cuts its own rows and gathers them back
(``attention._ulysses_block``), so a mixer beside it runs its tensor
parallel split unchanged.  A frontend's patch embeddings are split
by batch as the tokens are, ``frontend_proj`` is an FSDP leaf gathered
with the embedding, and under Ulysses the whole F + S sequence is split
over ``model`` (``forward`` refuses an F + S that ``model`` does not
divide, naming both).  :class:`ModelBase` holds what this stack shares
with the encoder-decoder (``models.encdec``): the FSDP layout, the
embedding, the head and the loss's mean.

Tensor parallelism over ``model`` (where the ``vocab`` rule splits the
vocab, :func:`vocab_layout`): the embedding is vocab-parallel (each rank
looks up the tokens of its rows, zeros elsewhere, summed over ``model``
by ``tp_reduce``); ``forward`` returns this rank's ``(B, S, V/|model|)``
f32 slice of the logits (the head's input through ``tp_copy``); the
loss is ``common.vocab_parallel_cross_entropy``; ``decode_step`` and
``prefill`` return full-vocab logits, gathered over ``model``.  The
``model`` ranks of a row block hold the same rows and compute the same
loss, so the loss's denominator is the batch group's alone.

FSDP (where an FSDP rule splits a leaf's ``d_model`` dim over the axes
it keeps, ``pod`` / ``data`` or ``model``: ``ExpertSharding.fsdp_axes``,
each leaf over its own): each rank holds its shard and
gathers the leaf whole right before use (``parallel.sharding
.fsdp_gather``, through ``TorusComm.all_gather``; the backward
reduce-scatters the gradient).  A superblock's leaves are gathered at
the top of :func:`_apply_superblock`, inside what ``checkpoint`` wraps,
so the remat recompute gathers them again and the forward keeps no
gathered copy; the tied embedding (and ``frontend_proj``) is gathered
once per ``forward`` / ``decode_step`` and that copy serves both the
lookup and the head, so one reduce-scatter carries both uses'
gradients.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import spectral as spectral_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (ParamSpec, init_params, layer_norm,
                                       param_shardings, resolve_device,
                                       rms_norm,
                                       softmax_cross_entropy, stack_specs,
                                       tree_map,
                                       vocab_parallel_cross_entropy)
from repro_torch.core.cache import mesh_shape
from repro_torch.parallel.sharding import (batch_group, model_dim, tp_copy,
                                           tp_gather, tp_group, tp_rank,
                                           tp_reduce)
from repro_torch.parallel.ulysses import check_lengths
from .config import ModelConfig

# the recurrent mixers' blocks: (p, x, cfg, state, mesh, rules) -> (y,
# new_state)
RECURRENT = {"mamba": mamba_mod.mamba_block, "mlstm": xlstm_mod.mlstm_block,
             "slstm": xlstm_mod.slstm_block,
             "spectral": spectral_mod.spectral_block}
PORTED_MIXERS = ("attn", *RECURRENT)


def _norm_specs(cfg):
    if cfg.norm == "layernorm":
        return {"g": ParamSpec((cfg.d_model,), (None,), init="ones"),
                "b": ParamSpec((cfg.d_model,), (None,), init="zeros")}
    return {"g": ParamSpec((cfg.d_model,), (None,), init="ones")}


def _apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["g"], p["b"])
    return rms_norm(x, p["g"])


def _mixer_specs(cfg, kind):
    return {"attn": attn.attn_specs, "mamba": mamba_mod.mamba_specs,
            "mlstm": xlstm_mod.mlstm_specs,
            "slstm": xlstm_mod.slstm_specs,
            "spectral": spectral_mod.spectral_specs}[kind](cfg)


def _ffn_specs(cfg, kind):
    if kind == "dense":
        return ffn_mod.ffn_specs(cfg)
    if kind == "moe":
        return moe_mod.moe_specs(cfg)
    return {}


def position_specs(cfg, mixer, ffn):
    out = {"norm1": _norm_specs(cfg), "mixer": _mixer_specs(cfg, mixer)}
    if ffn != "none":
        out["norm2"] = _norm_specs(cfg)
        out["ffn"] = _ffn_specs(cfg, ffn)
    return out


def superblock_specs(cfg: ModelConfig):
    return {f"pos{i}": position_specs(cfg, mixer, ffn)
            for i, (mixer, ffn) in enumerate(cfg.superblock)}


# ---------------------------------------------------------------------------
# Decode state (the reference's ``_position_state``)
# ---------------------------------------------------------------------------

# the group a recurrent mixer's channels (mamba, spectral) or heads (mLSTM)
# are split over; the sLSTM's cell runs whole
_MIXER_GROUP = {"mamba": mamba_mod.mixer_group,
                "spectral": spectral_mod.mixer_group,
                "mlstm": xlstm_mod.mlstm_group}


def _mixer_split(cfg: ModelConfig, mixer, mesh=None, rules=None) -> int:
    """Over how many ``model`` ranks a recurrent mixer splits its
    channels or heads (1: it runs whole)."""
    group = _MIXER_GROUP[mixer](cfg, mesh, rules) \
        if mixer in _MIXER_GROUP else None
    return 1 if group is None else group.size


def _position_state(cfg: ModelConfig, mixer, batch, max_seq, device,
                    n_kv: int, split: int = 1):
    """One position's decode state: the attention's KV cache (``n_kv``
    heads; sliding-window attention needs only ``window`` slots, a ring
    buffer), or the recurrent mixer's state at its start values (its
    channels or heads over ``split`` ranks: this rank's part)."""
    if mixer == "attn":
        slots = min(max_seq, cfg.window) if cfg.window else max_seq
        return attn.init_cache(attn.CacheSpec(batch, n_kv, slots, cfg.hd,
                                              cfg.cdtype), device)
    D = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    if mixer == "mamba":
        Ein = cfg.ssm_expand * D // split
        return {"ssm": torch.zeros((batch, Ein, cfg.ssm_state), **f32),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1, Ein),
                                    dtype=cfg.cdtype, device=device)}
    if mixer == "spectral":
        Ein = cfg.ssm_expand * D // split
        return {"ssm": torch.zeros((batch, Ein, cfg.ssm_state), **f32)}
    if mixer == "mlstm":
        hd = 2 * D // cfg.n_heads
        H = cfg.n_heads // split
        return {"C": torch.zeros((batch, H, hd, hd), **f32),
                "n": torch.zeros((batch, H, hd), **f32),
                "m": torch.full((batch, H), -1e30, **f32)}
    if mixer == "slstm":
        return {"c": torch.zeros((batch, D), **f32),
                "n": torch.full((batch, D), 1e-6, **f32),
                "m": torch.full((batch, D), -1e30, **f32),
                "h": torch.zeros((batch, D), **f32)}
    raise ValueError(mixer)


def _position_state_logical(cfg: ModelConfig, mixer):
    """Logical axes mirroring :func:`_position_state`'s leaves (the
    reference's, name for name)."""
    if mixer == "attn":
        kv = ("batch", "kv_heads", "seq_sp", None)
        return {"k": kv, "v": kv, "slot_pos": ("batch", "seq_sp")}
    if mixer == "mamba":
        return {"ssm": ("batch", "mlp", None),
                "conv": ("batch", None, "mlp")}
    if mixer == "spectral":
        return {"ssm": ("batch", "mlp", None)}
    if mixer == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None), "m": ("batch", "heads")}
    if mixer == "slstm":
        v = ("batch", None)
        return {"c": v, "n": v, "m": v, "h": v}
    raise ValueError(mixer)


def cache_logical_axes(cfg: ModelConfig):
    """Logical axes tree matching ``Model.init_caches`` (layer states get
    a leading stacked superblock dim); the KV-row codec of disaggregated
    serving reads it (``runtime.serving.KVRowCodec``)."""
    per_sb = {f"pos{i}": _position_state_logical(cfg, mixer)
              for i, (mixer, _) in enumerate(cfg.superblock)}
    states = tree_map(lambda ax: (None,) + tuple(ax), per_sb,
                      is_leaf=lambda x: isinstance(x, tuple))
    return {"states": states, "pos": ("batch",)}


# ---------------------------------------------------------------------------
# Superblock application
# ---------------------------------------------------------------------------

def _apply_position(pp, x, cfg, mixer, ffn, positions, state=None,
                    decode=False, mesh=None, rules=None):
    """One (mixer, ffn) position.  Returns (x, aux); in decode the
    position's state is updated in place."""
    h = _apply_norm(pp["norm1"], x, cfg)
    if mixer == "attn":
        if decode:
            y, _ = attn.decode_attention(pp["mixer"], h, state, positions,
                                         cfg, mesh, rules)
        else:
            y = attn.attention_block(pp["mixer"], h, cfg, causal=True,
                                     positions=positions, mesh=mesh,
                                     rules=rules)
    else:
        # forward throws the final state away, as the reference does
        y, new_state = RECURRENT[mixer](pp["mixer"], h, cfg,
                                        state=state if decode else None,
                                        mesh=mesh, rules=rules)
        if decode:
            for key, value in new_state.items():
                state[key].copy_(value)
    x = x + y.to(x.dtype)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = _apply_norm(pp["norm2"], x, cfg)
        if ffn == "moe":
            y, aux = moe_mod.moe_block(pp["ffn"], h, cfg, mesh=mesh,
                                       rules=rules)
        else:
            y = ffn_mod.ffn_block(pp["ffn"], h, cfg, mesh, rules)
        x = x + y.to(x.dtype)
    return x, aux


def _apply_superblock(params_sb, x, cfg, positions, mesh=None, rules=None,
                      fsdp=None):
    """One superblock of positions over the full sequence: (x, aux).
    ``fsdp``: the parameters' layout, whose FSDP leaves are gathered
    here first (None: ``params_sb`` is whole)."""
    if fsdp is not None:
        params_sb = fsdp.gather_params(params_sb, "blocks", drop=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, ffn) in enumerate(cfg.superblock):
        x, a = _apply_position(params_sb[f"pos{j}"], x, cfg, mixer, ffn,
                               positions, mesh=mesh, rules=rules)
        aux = aux + a
    return x, aux


def _remat(cfg: ModelConfig) -> bool:
    """Whether this forward checkpoints each superblock: only under
    autograd."""
    return cfg.remat and torch.is_grad_enabled()


def vocab_layout(cfg: ModelConfig, mesh=None, rules=None):
    """``(group, lo, V_loc)``: the ``model`` group the embedding and the
    head are split over and this rank's vocab rows ``lo .. lo + V_loc -
    1``, or None where the ``vocab`` rule does not split them."""
    if model_dim((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"), mesh,
                 rules) is None:
        return None
    group = tp_group(mesh)
    n = cfg.vocab // group.size
    return group, tp_rank(group) * n, n


def _layer(tree, i: int):
    """Superblock i's slice of a stacked tree (views, so in-place cache
    writes land in the stacked tensors)."""
    return tree_map(lambda a: a[i], tree)


class ModelBase:
    """What the decoder-only stack and the encoder-decoder share, on one
    device and on a mesh: the FSDP layout and its gathers of the
    top-level leaves, the vocab-parallel embedding and head, the
    full-vocab gather, and the loss's mean over the global batch.  A
    subclass is a dataclass with ``cfg``, ``_fsdp_layouts``,
    ``check_mesh`` and ``specs``."""

    # ---- FSDP ----
    def fsdp_layout(self, mesh=None, rules=None):
        """The parameters' ``ExpertSharding`` on ``mesh`` where an FSDP
        rule splits a leaf, else None (built once per mesh and rules)."""
        if mesh is None:
            return None
        self.check_mesh(mesh)
        key = (mesh, rules)
        if key not in self._fsdp_layouts:
            sh = param_shardings(self.specs(), mesh, rules)
            self._fsdp_layouts[key] = sh if sh.fsdp_axes else None
        return self._fsdp_layouts[key]

    @staticmethod
    def _whole(params, fsdp, keys):
        """``params`` with the top-level leaves ``keys`` gathered whole
        over FSDP (the embedding, ``frontend_proj``, an untied head); the
        stacked layers stay shards."""
        if fsdp is None:
            return params
        return dict(params, **fsdp.gather_params({k: params[k]
                                                  for k in keys}))

    # ---- embedding / head ----
    def embed(self, params, tokens, *, mesh=None, rules=None):
        vl = vocab_layout(self.cfg, mesh, rules)
        if vl is None:
            return params["embed"][tokens.long()].to(self.cfg.cdtype)
        group, lo, n = vl
        local = tokens.long() - lo
        inside = (local >= 0) & (local < n)
        rows = params["embed"][local.clamp(0, n - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return tp_reduce(rows, group).to(self.cfg.cdtype)

    def logits(self, params, x, *, mesh=None, rules=None):
        """f32 logits: compute-dtype inputs, f32 sums; where the vocab is
        split over ``model``, this rank's columns (:func:`vocab_layout`)."""
        w = params.get("lm_head", params["embed"])
        cd = self.cfg.cdtype
        vl = vocab_layout(self.cfg, mesh, rules)
        x = tp_copy(x.to(cd).float(), None if vl is None else vl[0])
        return torch.einsum("bsd,vd->bsv", x, w.to(cd).float())

    def full_logits(self, logits, *, mesh=None, rules=None):
        """Every rank's vocab columns of ``logits`` gathered over
        ``model`` (no autograd); ``logits`` as they are where the vocab
        is whole."""
        vl = vocab_layout(self.cfg, mesh, rules)
        return logits if vl is None else tp_gather(logits, vl[0], -1)

    # ---- loss ----
    def _mean_ce(self, logits, labels, mask=None, *, mesh=None, rules=None):
        """The cross-entropy (with ``cfg.z_loss``; vocab-parallel where the
        vocab is split) averaged over the positions ``mask`` keeps (all
        where it is None).  On a mesh the denominator is the global count
        over the batch group, times ``1 / n`` for its ``n`` ranks: each
        rank's loss is its share of the global mean times ``n``."""
        cfg = self.cfg
        vl = vocab_layout(cfg, mesh, rules)
        if vl is None:
            ce = softmax_cross_entropy(logits, labels, cfg.z_loss)
        else:
            ce = vocab_parallel_cross_entropy(logits, labels, cfg.z_loss,
                                              vl[0], vl[1])
        mask = torch.ones_like(ce) if mask is None else mask.float()
        count = torch.sum(mask)
        group = None if mesh is None else batch_group(mesh, rules)
        if group is not None:
            count = count.detach().clone()
            dist.all_reduce(count, group=group.pg)
            count = torch.clamp(count, min=1.0) / group.size
        else:
            count = torch.clamp(count, min=1.0)
        return torch.sum(ce * mask) / count


@dataclass
class Model(ModelBase):
    cfg: ModelConfig
    # the parameters' layout per (mesh, rules) where FSDP splits a leaf
    _fsdp_layouts: dict = field(default_factory=dict, init=False,
                                repr=False, compare=False)

    def __post_init__(self):
        cfg = self.cfg
        missing = {m for m, _ in cfg.superblock} - set(PORTED_MIXERS)
        if missing or cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name}: Model is the decoder-only stack (mixers "
                f"{PORTED_MIXERS}; got {sorted(missing)}, encoder_layers="
                f"{cfg.encoder_layers}); build_model gives the "
                f"encoder-decoder its EncDecModel")

    def check_mesh(self, mesh) -> None:
        """Refuse a mesh (a ``DeviceMesh`` or ``{dim: size}``) where the
        mLSTM's leaves split over ``model`` and its heads do not, or where
        Ulysses over ``model`` cannot share out the query heads."""
        if mesh is None:
            return
        shape = mesh if isinstance(mesh, dict) else mesh_shape(mesh)
        check_lengths(self.cfg, shape)
        if any(m == "mlstm" for m, _ in self.cfg.superblock):
            xlstm_mod.check_mlstm_heads(self.cfg, shape)

    # ---- parameter specs ----
    def specs(self):
        cfg = self.cfg
        out = {
            "embed": ParamSpec((cfg.vocab, cfg.d_model),
                               ("vocab", "embed_fsdp"), init="embed",
                               scale=1.0),
            "blocks": stack_specs(superblock_specs(cfg), cfg.n_superblocks,
                                  None),
            "final_norm": _norm_specs(cfg),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = ParamSpec((cfg.vocab, cfg.d_model),
                                       ("vocab", "embed_fsdp"))
        if cfg.frontend is not None:
            out["frontend_proj"] = ParamSpec(
                (cfg.d_model, cfg.d_model), ("embed_fsdp", None))
        return out

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from ``generator`` (on ``device``)."""
        return init_params(self.specs(), generator, resolve_device(device),
                           self.cfg.pdtype)

    # ---- full-sequence forward (train / prefill) ----
    def forward(self, params, tokens, *, mesh=None, rules=None,
                frontend_embeds=None):
        """tokens: (B, S) -> (logits (B, S, V) f32, aux loss); on a mesh
        that splits the vocab, this rank's (B, S, V / |model|) columns.
        ``frontend_embeds`` (B, F, D), projected through
        ``frontend_proj``, go before the tokens (positions count over the
        whole F + S sequence); the logits are the tokens' alone."""
        cfg = self.cfg
        if mesh is not None:
            S = tokens.shape[1]
            F = 0 if frontend_embeds is None else frontend_embeds.shape[1]
            what = f"F + S = {F} + {S}" if F else "the sequence S"
            check_lengths(cfg, mesh_shape(mesh), {what: F + S})
        fsdp = self.fsdp_layout(mesh, rules)
        skip = ("blocks",) if frontend_embeds is not None \
            else ("blocks", "frontend_proj")
        params = self._whole(params, fsdp, [k for k in params
                                            if k not in skip])
        x = self.embed(params, tokens, mesh=mesh, rules=rules)
        if frontend_embeds is not None:
            cd = cfg.cdtype
            fe = frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)
            x = torch.cat([fe, x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = _remat(cfg)
        for i in range(cfg.n_superblocks):
            params_sb = _layer(params["blocks"], i)
            if remat:
                x, a = remat_mod.checkpointed(
                    _apply_superblock, params_sb, x, cfg, positions, mesh,
                    rules, fsdp, policy=cfg.remat_policy)
            else:
                x, a = _apply_superblock(params_sb, x, cfg, positions, mesh,
                                         rules, fsdp)
            aux = aux + a
        x = _apply_norm(params["final_norm"], x, cfg)
        if frontend_embeds is not None:
            x = x[:, frontend_embeds.shape[1]:]
        return self.logits(params, x, mesh=mesh, rules=rules), aux

    # ---- loss ----
    def loss(self, params, batch, *, mesh=None, rules=None):
        """Masked mean cross-entropy (with ``cfg.z_loss``) plus
        ``router_aux_weight`` times the MoE aux loss; batch: ``tokens``,
        ``labels`` (B, S), an optional ``mask`` and, for a frontend,
        ``frontend_embeds``.  Returns (total,
        metrics ``ce_loss`` / ``aux_loss`` / ``total_loss``).

        On a mesh ``batch`` is this rank's row block and the mean's
        denominator is the global mask count over the batch group, times
        ``1 / n`` for its ``n`` ranks: each rank's loss is its share of
        the global mean times ``n``, so the mean over the ranks of their
        losses (and metrics) is the one-device loss of the global batch,
        for any split of the mask.  The ``model`` ranks of a row block
        compute the same loss (a vocab-parallel cross-entropy where the
        vocab is split)."""
        cfg = self.cfg
        logits, aux = self.forward(
            params, batch["tokens"], mesh=mesh, rules=rules,
            frontend_embeds=batch.get("frontend_embeds"))
        loss = self._mean_ce(logits, batch["labels"], batch.get("mask"),
                             mesh=mesh, rules=rules)
        total = loss + cfg.router_aux_weight * aux   # aux == 0 if no MoE
        return total, {"ce_loss": loss, "aux_loss": aux,
                       "total_loss": total}

    # ---- decode ----
    def init_caches(self, batch: int, max_seq: int, device="cuda", *,
                    mesh=None, rules=None):
        """Stacked (n_superblocks, ...) decode states (KV caches, recurrent
        states) plus per-slot positions; on a mesh the kv heads this
        rank's attention uses (``attention.head_layout``) and this rank's
        part of each recurrent state (:func:`_mixer_split`: the ``mlp``
        channels of mamba's and spectral's, the heads of the mLSTM's, as
        :func:`_position_state_logical` names them; the sLSTM's whole)."""
        cfg = self.cfg
        self.check_mesh(mesh)
        device = resolve_device(device)
        n_kv = attn.head_layout(cfg, mesh, rules).n_kv
        n = cfg.n_superblocks
        states = {}
        for i, (mixer, _) in enumerate(cfg.superblock):
            one = _position_state(cfg, mixer, batch, max_seq, device, n_kv,
                                  _mixer_split(cfg, mixer, mesh, rules))
            states[f"pos{i}"] = tree_map(
                lambda a: a[None].repeat((n,) + (1,) * a.dim()), one)
        return {"states": states,
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}

    def prefill(self, params, tokens, caches, *, mesh=None, rules=None,
                frontend_embeds=None):
        """Sequential prefill through ``decode_step`` (correct though not
        the fast path; full-sequence prefill uses ``forward``).  It
        ignores ``frontend_embeds``, as the reference's does."""
        logits = None
        for t in range(tokens.shape[1]):
            logits, caches = self.decode_step(params, tokens[:, t:t + 1],
                                              caches, mesh=mesh, rules=rules)
        return logits, caches

    def decode_step(self, params, tokens_t, caches, *, mesh=None,
                    rules=None):
        """tokens_t: (B, 1).  Returns (logits (B, 1, V) f32, full-vocab on
        a mesh too, caches); the KV caches and recurrent states are
        updated in place, ``pos`` is a new tensor."""
        cfg = self.cfg
        fsdp = self.fsdp_layout(mesh, rules)
        params = self._whole(params, fsdp, [k for k in params
                                            if k not in ("blocks",
                                                         "frontend_proj")])
        x = self.embed(params, tokens_t, mesh=mesh, rules=rules)
        pos = caches["pos"]
        for i in range(cfg.n_superblocks):
            params_sb = _layer(params["blocks"], i)
            if fsdp is not None:
                params_sb = fsdp.gather_params(params_sb, "blocks", drop=1)
            states_sb = _layer(caches["states"], i)
            for j, (mixer, ffn) in enumerate(cfg.superblock):
                x, _ = _apply_position(params_sb[f"pos{j}"], x, cfg, mixer,
                                       ffn, pos, state=states_sb[f"pos{j}"],
                                       decode=True, mesh=mesh, rules=rules)
        x = _apply_norm(params["final_norm"], x, cfg)
        logits = self.logits(params, x, mesh=mesh, rules=rules)
        return self.full_logits(logits, mesh=mesh, rules=rules), {
            "states": caches["states"], "pos": pos + 1}
