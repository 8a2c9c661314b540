"""Mixture-of-Experts, capacity path (port of ``repro.models.moe``).

The layouts are the reference's: tokens are scattered into
``(G, E_loc, C, D)`` dispatch blocks, the expert FFN is three grouped
matmuls (``kernels.ops.expert_matmul``, the Hopper kernel on a card), and
the combine gathers back with the gates.

With ``mesh=None`` the expert group is this one device (G = 1).  With a
``DeviceMesh`` the experts are spread over the expert-parallel group
``ep_axes(mesh)`` (``("data", "pod")``, fastest digit first), as in the
reference: each rank holds the ``E_loc`` experts of its virtual rank
(``expert_shard``) and its own shard of the batch, and the dispatch
blocks travel through one ``A2APlan`` per direction — the paper's
factorized all-to-all, pack and unpack kernels included.  Tensor
parallelism over ``model`` and dropless (``capacity_factor=None``)
dispatch are not ported yet (ROADMAP).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.cache import mesh_shape
from repro_torch.core.comm import torus_comm
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, gelu, silu
from repro_torch.parallel.sharding import ShardingRules, ep_axes
from .config import ModelConfig


def moe_specs(cfg: ModelConfig) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((D, E), (None, None), dtype=torch.float32),
        "w1": ParamSpec((E, D, F_), ("expert", "embed_fsdp", "mlp")),
        "w3": ParamSpec((E, D, F_), ("expert", "embed_fsdp", "mlp")),
        "w2": ParamSpec((E, F_, D), ("expert", "mlp", "embed_fsdp")),
    }


def _group_geometry(cfg: ModelConfig, mesh):
    """(axes, G, E_loc, R): EP axes, group size, experts/rank, replicas."""
    if mesh is None:
        return (), 1, cfg.n_experts, 1
    axes = ep_axes(mesh)
    shape = mesh_shape(mesh)
    G = math.prod(shape[a] for a in axes)
    E = cfg.n_experts
    if E >= G:
        if E % G:
            raise ValueError(f"n_experts={E} not divisible by EP group {G}")
        return axes, G, E // G, 1
    if G % E:
        raise ValueError(f"EP group {G} not divisible by n_experts={E}")
    return axes, G, 1, G // E


def moe_ep_comm(cfg: ModelConfig, mesh, axes):
    """The cached Cartesian communicator of the EP group (``core.comm``),
    fetched from the comm registry on every later layer and step."""
    if not axes or mesh is None:
        return None
    return torus_comm(mesh, axes, variant=cfg.a2a_variant)


def moe_a2a_plan(cfg: ModelConfig, mesh, axes, E_loc: int, C: int):
    """The one A2APlan shared by dispatch and combine, resolved once per
    (mesh ranks, EP axes, block shape, dtype, config knobs) and fetched
    from the plan registry afterwards.  ``cfg.a2a_backend`` parameterizes
    plan construction here and nowhere else."""
    comm = moe_ep_comm(cfg, mesh, axes)
    if comm is None:
        return None
    return comm.all_to_all(
        block_shape=(E_loc, C, cfg.d_model), dtype=cfg.cdtype,
        backend=cfg.a2a_backend, n_chunks=cfg.a2a_chunks,
        max_chunks=cfg.a2a_chunks or 4)


def expert_shard(p: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's MoE parameters under ``mesh``: the router, and the
    ``(E_loc, ...)`` slice of the virtual-expert weights its EP rank owns
    (a replica's single expert when ``n_experts`` < G)."""
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    comm = moe_ep_comm(cfg, mesh, axes)
    v = 0 if comm is None else comm.rank
    E = cfg.n_experts
    lo = v * E_loc if E >= G else v % E
    return {**p, **{k: p[k][lo:lo + E_loc] for k in ("w1", "w3", "w2")}}


def _virtual_weights(w, G: int):
    """(E, ...) -> (G, E_loc, ...) virtual-expert view (reshape or tile)."""
    E = w.shape[0]
    if E >= G:
        return w.reshape(G, E // G, *w.shape[1:])
    R = G // E
    return w.repeat((R,) + (1,) * (w.dim() - 1)).reshape(G, 1, *w.shape[1:])


def _capacity(cfg: ModelConfig, n_tokens: int, n_slots: int) -> int:
    # One expert gets at most n_tokens rows from a device (a token's top_k
    # experts are distinct), so the 8-aligned capacity is clamped there.
    hard = max(1, n_tokens)
    if cfg.capacity_factor is None:
        return hard
    c = math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens / n_slots)
    return min(max(8, -(-c // 8) * 8), hard)


def _moe_inner(x, router_w, w1, w3, w2, *, cfg: ModelConfig, G, E_loc, R,
               C, plan=None, reduce_group=None):
    """x: (B, S, D) this rank's tokens; w*: virtual-expert weights
    (., E_loc, ...) whose first slice is this rank's experts; ``plan`` the
    resolved A2APlan (None when there is no EP group); ``reduce_group``
    the communicator the aux-loss statistics are averaged over.
    Returns (y (B, S, D), aux loss)."""
    B, S, D = x.shape
    N = B * S
    E = cfg.n_experts
    cd = cfg.cdtype
    dev = x.device
    xt = x.reshape(N, D)
    w1, w3, w2 = w1[0], w3[0], w2[0]

    # ---- routing (f32) ----
    logits = xt.float() @ router_w.float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # ---- per-expert positions (order: token-major, k-minor) ----
    flat_e = expert_idx.reshape(-1)                              # (N*k,)
    onehot = F.one_hot(flat_e, E)
    pos_e = torch.cumsum(onehot, dim=0) - 1                      # inclusive-1
    pos_e = pos_e.gather(1, flat_e[:, None])[:, 0]

    if E >= G:   # experts partitioned over ranks
        v_idx = flat_e // E_loc
        sub_idx = flat_e % E_loc
        slot_pos = pos_e
    else:        # experts replicated R times: round-robin across replicas
        spread = pos_e % R
        v_idx = flat_e + E * spread
        sub_idx = torch.zeros_like(flat_e)
        slot_pos = pos_e // R
    keep = slot_pos < C
    # row of (v, sub, slot) in the flat (G*E_loc*C, D) blocks; a dropped
    # assignment goes to the extra row G*E_loc*C past their end
    n_rows = G * E_loc * C
    row = torch.where(keep, (v_idx * E_loc + sub_idx) * C + slot_pos,
                      torch.full_like(slot_pos, n_rows))

    # ---- dispatch scatter into (G, E_loc, C, D); a dropped row lands in
    # the extra row, which is cut off (the reference's mode="drop"), and
    # the blocks stay one contiguous buffer ----
    tok_idx = torch.arange(N, device=dev).repeat_interleave(cfg.top_k)
    disp = torch.zeros((n_rows + 1, D), dtype=cd, device=dev)
    disp[row] = xt[tok_idx].to(cd)

    # ---- the paper's collective, through its resolved A2APlan, on the
    # flat (G, E_loc*C*D) buffer: block v goes to EP rank v ----
    def a2a(blocks, reverse=False):
        if plan is None:
            return blocks
        flat = blocks.reshape(G, -1)
        out = plan.reverse(flat) if reverse else plan.forward(flat)
        return out.reshape(blocks.shape)

    recv = a2a(disp[:n_rows].view(G, E_loc, C, D))

    # ---- expert FFN: three grouped matmuls ----
    xe = recv.permute(1, 0, 2, 3).reshape(E_loc, G * C, D).contiguous()
    if cfg.act == "swiglu":
        h = silu(kops.expert_matmul(xe, w1.to(cd))) \
            * kops.expert_matmul(xe, w3.to(cd))
    else:
        h = gelu(kops.expert_matmul(xe, w1.to(cd)))
    ye = kops.expert_matmul(h, w2.to(cd))
    back = a2a(ye.reshape(E_loc, G, C, D).permute(1, 0, 2, 3), reverse=True)

    # ---- combine: dropped assignments read a zero pad row ----
    backp = torch.cat([back.reshape(n_rows, D),
                       torch.zeros((1, D), dtype=cd, device=dev)])
    yk = backp[row].reshape(N, cfg.top_k, D)
    gates = (gate_vals * keep.reshape(N, cfg.top_k)).float()
    y = torch.einsum("nkd,nk->nd", yk.float(), gates)

    # ---- load-balance aux loss (GShard): E * sum_e f_e * P_e ----
    f_e = onehot.float().mean(0)
    p_e = probs.mean(0)
    if reduce_group is not None:        # the reference's pmean
        stats = torch.stack([f_e, p_e])
        dist.all_reduce(stats, group=reduce_group.pg)
        f_e, p_e = stats / reduce_group.size
    aux = E * torch.sum(f_e * p_e)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block(p, x, cfg: ModelConfig, mesh=None,
              rules: ShardingRules | None = None):
    """x: (B, S, D) -> (y, aux_loss).

    With a ``DeviceMesh``, every rank of it calls this collectively with
    its own shard of the batch (split over the mesh dims of the "batch"
    rule) and its own expert slice (``expert_shard(p, cfg, mesh)``).
    """
    if cfg.dropless:
        raise NotImplementedError(
            "dropless MoE (capacity_factor=None) comes with the ragged "
            "all-to-all of ROADMAP.md's queue 1 item 7")
    axes, G, E_loc, R = _group_geometry(cfg, mesh)
    B, S, _ = x.shape
    C = _capacity(cfg, B * S, max(cfg.n_experts, G))
    if mesh is None:
        return _moe_inner(x, p["router"], _virtual_weights(p["w1"], G),
                          _virtual_weights(p["w3"], G),
                          _virtual_weights(p["w2"], G), cfg=cfg, G=G,
                          E_loc=E_loc, R=R, C=C)
    shape = mesh_shape(mesh)
    if shape.get("model", 1) > 1:
        raise NotImplementedError(
            "tensor parallelism over the 'model' mesh dim (the expert "
            "FFN's psum) is not ported yet (ROADMAP.md); use a mesh "
            "without it")
    if p["w1"].shape[0] != E_loc:
        raise ValueError(
            f"under a mesh moe_block takes this rank's {E_loc} experts "
            f"(expert_shard), got w1 of shape {tuple(p['w1'].shape)}")
    rules = rules or ShardingRules()
    batch_axes = tuple(a for a in rules.lookup("batch") if a in shape)
    reduce_group = torus_comm(mesh, batch_axes[::-1]).fact.group \
        if batch_axes else None
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    return _moe_inner(x, p["router"], p["w1"][None], p["w3"][None],
                      p["w2"][None], cfg=cfg, G=G, E_loc=E_loc, R=R, C=C,
                      plan=plan, reduce_group=reduce_group)
