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
factorized all-to-all, pack and unpack kernels included.  A plan that
resolved to the overlap engine (``backend="overlap"``, what phi3.5-moe's
``"tuned"`` picks on its EP torus) pipelines dispatch, expert FFN and
combine per capacity chunk instead.

``capacity_factor=None`` is **dropless** dispatch: the capacity is the
worst case (every routed token fits), and with a mesh the collective is
the ragged or the sparse Alltoallv (``moe_dropless_a2a_plan``, chosen by
the router's expected density), its bucket the per-rank window.

Training on a mesh: every collective of the layer is differentiable.
The dispatch and combine are the plans' autograd Functions (an
all-to-all's backward is the plan's other direction on the cotangent;
the overlap engine's backward is the same pipeline), and the aux loss's
average over the batch axes is ``all_reduce_sum``, whose backward sums
the cotangents of every rank's copy.  So each rank's gradient of its
own loss reaches its experts summed over the ranks whose tokens they
served; ``model_api.reduce_grads`` scales it to the global batch and,
with replicas (``n_experts`` < G), sums the copies of an expert, the
pullback of the reference's ``jnp.tile``.

Tensor parallelism: on a mesh whose ``model`` dim splits the experts'
hidden dim F (the ``mlp`` rule), each rank holds its F slice of its
experts' ``w1`` / ``w3`` / ``w2``, and the expert FFN's partial output is
summed over ``model`` before the reverse exchange (the reference's
``psum``, here ``parallel.sharding.tp_reduce``); its input goes through
``tp_copy``, whose backward sums the input's gradient.  Both sit inside
the expert FFN, so the overlap engine's per-chunk recompute and the
dropless path differentiate them.  Every ``model`` rank of one ``(pod,
data)`` coordinate holds the same tokens and routes them alike (the
router's input is the same bits on each), and exchanges over the EP
group of its own ``model`` column.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.autotune import db_fingerprint, lookup_ragged_measured
from repro_torch.core.comm import torus_comm
from repro_torch.core.plan import itemsize
from repro_torch.core.profile_inspect import EXPERT_SPAN
from repro_torch.core.ragged import next_pow2
from repro_torch.core.tuning import choose_ragged_algorithm, default_links
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (ParamSpec, gelu, param_shardings,
                                       silu)
from repro_torch.models.remat import dot, saved
from repro_torch.parallel.sharding import (ShardingRules, all_reduce_sum,
                                           batch_group, ep_geometry,
                                           model_dim, tp_copy, tp_group,
                                           tp_reduce)
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
    return ep_geometry(cfg.n_experts, mesh)


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
    plan construction here and nowhere else; with ``"autotune"`` the
    dispatch / combine collective replays the winner recorded in the
    tuning DB for exactly this (ranks, EP axes, block, dtype) key, and
    falls back to the cost model on a miss — an explicit
    ``core.autotune.autotune(...)`` run warms the DB."""
    comm = moe_ep_comm(cfg, mesh, axes)
    if comm is None:
        return None
    return comm.all_to_all(
        block_shape=(E_loc, C, cfg.d_model), dtype=cfg.cdtype,
        backend=cfg.a2a_backend, n_chunks=cfg.a2a_chunks,
        max_chunks=cfg.a2a_chunks or 4)


def moe_ragged_a2a_plan(cfg: ModelConfig, mesh, axes, E_loc: int, C: int,
                        n_loc: int):
    """The RaggedA2APlan of dropless dispatch and combine.  One ragged row
    is one token embedding; each destination rank's bucket window holds
    its ``(E_loc, C)`` expert-strided slots, so ``max_count`` is the
    window ``E_loc * C`` while the expected payload per rank is ``top_k *
    n_loc / p`` rows (their ratio is the plan's occupancy estimate).
    ``cfg.a2a_backend`` resolves the padded data plan as it resolves the
    capacity path's plan."""
    comm = moe_ep_comm(cfg, mesh, axes)
    if comm is None:
        return None
    window = E_loc * C
    avg = min(float(window), max(1.0, cfg.top_k * n_loc / comm.p))
    return comm.ragged_all_to_all(
        row_shape=(cfg.d_model,), dtype=cfg.cdtype,
        max_count=window, avg_count=avg, backend=cfg.a2a_backend,
        n_chunks=cfg.a2a_chunks, max_chunks=cfg.a2a_chunks or 4)


def moe_dropless_a2a_plan(cfg: ModelConfig, mesh, axes, E_loc: int, C: int,
                          n_loc: int):
    """Dropless plan chooser: ragged (dense-bucketed) or sparse
    (neighborhood) Alltoallv, by the router's expected density.  The
    non-zero fraction of the ``p x p`` count matrix follows the Poisson
    occupancy of ``top_k * n_loc / p`` tokens per (source, destination)
    pair, ``rho = 1 - exp(-top_k * n_loc / p)``;
    ``tuning.choose_ragged_algorithm`` prices both and the sparse plan is
    used only where it wins.  With ``cfg.a2a_backend == "autotune"`` the
    measured ragged-vs-sparse winner that ``core.autotune
    .autotune_ragged`` recorded for exactly this (ranks, EP axes, row,
    dtype, window, density decade) key is replayed instead; a miss falls
    back to the model.  Both plans' ``forward`` / ``reverse`` take and
    return the same, so :func:`_moe_inner` runs either."""
    comm = moe_ep_comm(cfg, mesh, axes)
    if comm is None:
        return None
    window = E_loc * C
    lam = cfg.top_k * n_loc / comm.p
    density = min(1.0, max(1e-6, 1.0 - math.exp(-lam)))
    backend = None
    if cfg.a2a_backend == "autotune":
        rec = lookup_ragged_measured(
            None if comm.mesh is None else db_fingerprint(comm.mesh),
            comm.dims, comm.axis_names, (cfg.d_model,), cfg.cdtype, window,
            cfg.a2a_variant, density)
        if rec is not None:
            backend = rec["winner"]["backend"]
    if backend is None:
        backend = choose_ragged_algorithm(
            comm.dims, default_links(comm.axis_names),
            cfg.d_model * itemsize(cfg.cdtype), next_pow2(window),
            max_chunks=cfg.a2a_chunks or 4, density=density).kind
    if backend == "sparse":
        avg = min(float(window), max(1.0, lam))
        return comm.sparse_all_to_all(
            row_shape=(cfg.d_model,), dtype=cfg.cdtype, max_count=window,
            avg_count=avg, density=density)
    return moe_ragged_a2a_plan(cfg, mesh, axes, E_loc, C, n_loc)


def expert_shard(p: dict, cfg: ModelConfig, mesh, rules=None) -> dict:
    """This rank's MoE parameters under ``mesh``: the router, and the
    ``(E_loc, ...)`` slice of the virtual-expert weights its EP rank owns
    (a replica's single expert when ``n_experts`` < G), cut to its slice
    of F where ``model`` splits it (:func:`moe_tp_group`)."""
    return param_shardings(moe_specs(cfg), mesh, rules).shard_tree(p)


def moe_tp_group(cfg: ModelConfig, mesh, rules=None):
    """The ``model`` group the expert FFN's partial output is summed over,
    or None where the ``mlp`` rule does not split F on ``mesh``.  The
    expert leaves' FSDP rule is read as None, as the reference's
    ``moe_block`` re-constrains them to ``("expert_virtual", None, None,
    "mlp")`` whatever that rule says."""
    spec = moe_specs(cfg)["w1"]
    if model_dim(spec.shape, ("expert", None, "mlp"), mesh, rules) is None:
        return None
    return tp_group(mesh)


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
               C, plan=None, ragged_plan=None, reduce_group=None, tp=None):
    """x: (B, S, D) this rank's tokens; w*: virtual-expert weights
    (., E_loc, ...) whose first slice is this rank's experts (their F
    slice under ``tp``); ``plan`` the resolved A2APlan (None when there
    is no EP group); ``ragged_plan`` the RaggedA2APlan or SparseA2APlan
    dropless dispatch runs through instead; ``reduce_group`` the
    communicator the aux-loss statistics are averaged over; ``tp`` the
    ``model`` group the expert FFN's output is summed over.  Returns (y
    (B, S, D), aux loss)."""
    B, S, D = x.shape
    N = B * S
    E = cfg.n_experts
    cd = cfg.cdtype
    dev = x.device
    xt = x.reshape(N, D)
    w1, w3, w2 = w1[0], w3[0], w2[0]

    # ---- routing (f32) ----
    logits = dot(xt.float(), router_w.float())                   # (N, E)
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
    disp = disp[:n_rows].view(G, E_loc, C, D)

    # ---- expert FFN: three grouped matmuls on any capacity slice
    # (G, E_loc, Cc, D) — tokens are independent rows, so this is also
    # the overlap engine's per-chunk compute stage ----
    def expert_ffn(recv, _chunk=0):
        # a profiler span, the compute mark of core.profile_inspect
        with torch.profiler.record_function(EXPERT_SPAN):
            Cc = recv.shape[2]
            xe = tp_copy(recv.permute(1, 0, 2, 3).reshape(E_loc, G * Cc, D)
                         .contiguous(), tp)
            if cfg.act == "swiglu":
                h = silu(kops.expert_matmul(xe, w1.to(cd))) \
                    * kops.expert_matmul(xe, w3.to(cd))
            else:
                h = gelu(kops.expert_matmul(xe, w1.to(cd)))
            ye = tp_reduce(kops.expert_matmul(h, w2.to(cd)), tp)
            return ye.reshape(E_loc, G, Cc, D).permute(1, 0, 2, 3)

    # ---- the paper's collective, through its resolved A2APlan, on the
    # flat (G, E_loc*C*D) buffer: block v goes to EP rank v ----
    def a2a(blocks, reverse=False):
        if plan is None:
            return blocks
        flat = blocks.reshape(G, -1)
        out = plan.reverse(flat) if reverse else plan.forward(flat)
        return out.reshape(blocks.shape)

    if ragged_plan is not None:
        # Dropless: the Alltoallv moves each destination rank's (E_loc, C)
        # window as one bucket of token rows; the router's per-rank send
        # counts drive the counts phase, and the combine reuses the
        # dispatch's recv counts.  Combine reads slot validity from this
        # rank's own routing, so no output depends on recv_counts; eager
        # torch still runs both counts exchanges (XLA drops them).
        window = E_loc * C
        counts = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(
            0, v_idx, keep.to(torch.int32))
        recv_rows, recv_counts = saved("moe_recv", lambda: (
            ragged_plan.forward(disp.reshape(G, window, D), counts)))
        recv = recv_rows[:, :window].reshape(G, E_loc, C, D)
        ye = expert_ffn(recv).reshape(G, window, D)
        back_rows, _ = saved("moe_back", lambda: ragged_plan.reverse(
            ye, recv_counts))
        back = back_rows[:, :window].reshape(G, E_loc, C, D)
    elif plan is not None and plan.backend == "overlap":
        # dispatch rounds / expert FFN / combine rounds pipelined per
        # capacity chunk: chunk c+1's exchanges run behind chunk c's FFN.
        # The Function keeps each chunk as it arrives (the reference's
        # per-chunk "moe_recv"); kept under "moe_back", the recompute
        # skips the whole pipeline, whose backward recomputes the FFN
        back = saved("moe_back", lambda: plan.overlap(
            disp, compute_fn=expert_ffn, reverse=True, chunk_axis=2,
            params=(w1, w3, w2)))
    else:
        recv = saved("moe_recv", lambda: a2a(disp))
        ye = expert_ffn(recv)
        back = saved("moe_back", lambda: a2a(ye, reverse=True))

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
        stats = all_reduce_sum(torch.stack([f_e, p_e]), reduce_group)
        f_e, p_e = stats / reduce_group.size
    aux = E * torch.sum(f_e * p_e)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block(p, x, cfg: ModelConfig, mesh=None,
              rules: ShardingRules | None = None):
    """x: (B, S, D) -> (y, aux_loss).

    With a ``DeviceMesh``, every rank of it calls this collectively with
    its own shard of the batch (split over the mesh dims of the "batch"
    rule; the ``model`` ranks of one row block hold the same rows) and
    its own expert slice (``expert_shard(p, cfg, mesh)``).
    """
    axes, G, E_loc, R = _group_geometry(cfg, mesh)
    B, S, _ = x.shape
    C = _capacity(cfg, B * S, max(cfg.n_experts, G))
    if mesh is None:
        return _moe_inner(x, p["router"], _virtual_weights(p["w1"], G),
                          _virtual_weights(p["w3"], G),
                          _virtual_weights(p["w2"], G), cfg=cfg, G=G,
                          E_loc=E_loc, R=R, C=C)
    tp = moe_tp_group(cfg, mesh, rules)
    F_loc = cfg.d_ff // (1 if tp is None else tp.size)
    if tuple(p["w1"].shape) != (E_loc, cfg.d_model, F_loc):
        raise ValueError(
            f"under a mesh moe_block takes this rank's {E_loc} experts and "
            f"its {F_loc} of F (expert_shard), got w1 of shape "
            f"{tuple(p['w1'].shape)}")
    reduce_group = batch_group(mesh, rules)
    # dropless replaces the capacity path's dense plan with the ragged or
    # sparse Alltoallv plan
    if cfg.dropless:
        plan, ragged = None, moe_dropless_a2a_plan(cfg, mesh, axes, E_loc,
                                                   C, B * S)
    else:
        plan, ragged = moe_a2a_plan(cfg, mesh, axes, E_loc, C), None
    return _moe_inner(x, p["router"], p["w1"][None], p["w3"][None],
                      p["w2"][None], cfg=cfg, G=G, E_loc=E_loc, R=R, C=C,
                      plan=plan, ragged_plan=ragged,
                      reduce_group=reduce_group, tp=tp)
