"""The attention + MoE decoder in plain float32 PyTorch, as the port's
configuration states it: RMSNorm (eps 1e-6) before attention and before
the MoE; grouped-query causal attention with interleaved-pair RoPE; the
MoE's router in f32, softmax, top-k gates renormalised, each expert
taking at most ``C = min(max(8, 8-aligned ceil(capacity_factor * k * N /
E)), N)`` of the ``N * k`` assignments in token-major order (the rest
dropped), SwiGLU experts; the GShard aux loss ``E * sum_e f_e P_e``; a
final RMSNorm and the head tied to the embedding.

``precision="fp8"`` is the control: every product's two operands are
rounded to float8 e4m3 (one scale per tensor, its largest magnitude to
448) before an f32 product.

float32 products run with TF32 off (:func:`strict_f32`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..weights import layer_weights, top_weights

FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32, not TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, back in
    f32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a, b, precision: str = "f32"):
    if precision == "fp8":
        return to_fp8(a) @ to_fp8(b)
    return a @ b


def rms_norm(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * g


def rope(x, theta: float, offset: int = 0):
    """x: (B, H, S, Dh) at positions ``offset .. offset + S - 1``; rotates
    ``(x[2i], x[2i+1])``."""
    S, Dh = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, Dh, 2, device=x.device,
                                          dtype=torch.float64) / Dh))
    ang = torch.arange(offset, offset + S, device=x.device,
                       dtype=torch.float64)[:, None] * freqs
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def attention(x, w, m: dict, precision="f32", kv=None):
    """Causal GQA self-attention of x (B, S, D), one kv head's group of
    query heads at a time (its scores are the largest temporary);
    ``kv`` (a dict) gets the keys and values after RoPE."""
    B, S, D = x.shape
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    Dh = m.get("head_dim") or D // Hq
    g = Hq // Hkv
    theta = m.get("rope_theta", 10000.0)
    q = mm(x, w["mixer/wq"].reshape(D, Hq * Dh), precision)
    k = mm(x, w["mixer/wk"].reshape(D, Hkv * Dh), precision)
    v = mm(x, w["mixer/wv"].reshape(D, Hkv * Dh), precision)
    q = rope(q.reshape(B, S, Hq, Dh).transpose(1, 2), theta)
    k = rope(k.reshape(B, S, Hkv, Dh).transpose(1, 2), theta)
    v = v.reshape(B, S, Hkv, Dh).transpose(1, 2)
    if kv is not None:
        kv["k"], kv["v"] = k, v
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for h in range(Hkv):
        qh = q[:, h * g:(h + 1) * g]                         # (B, g, S, Dh)
        s = mm(qh, k[:, h:h + 1].transpose(-1, -2), precision) \
            / math.sqrt(Dh)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        outs.append(mm(p, v[:, h:h + 1], precision))
    o = torch.cat(outs, 1).transpose(1, 2).reshape(B, S, Hq * Dh)
    return mm(o, w["mixer/wo"].reshape(Hq * Dh, D), precision)


def capacity(m: dict, n_tokens: int) -> int:
    c = math.ceil(m["capacity_factor"] * m["top_k"] * n_tokens
                  / m["n_experts"])
    return min(max(8, -(-c // 8) * 8), max(1, n_tokens))


def route(xt, router, m: dict, precision="f32"):
    """(probs, gates (N, k) with dropped assignments zeroed, experts
    (N, k), keep (N, k)) of the f32 router over tokens ``xt`` (N, D)."""
    N = xt.shape[0]
    E, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(mm(xt, router, precision), -1)
    gv, ei = torch.topk(probs, k, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    flat = ei.reshape(-1)
    onehot = F.one_hot(flat, E)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    keep = (pos < capacity(m, N)).reshape(N, k)
    return probs, gv * keep, ei, keep


def expert(h, w, e: int, precision="f32"):
    """Expert ``e``'s SwiGLU of h (n, D)."""
    return mm(F.silu(mm(h, w["ffn/w1"][e], precision))
              * mm(h, w["ffn/w3"][e], precision), w["ffn/w2"][e], precision)


def moe(x, w, m: dict, precision="f32", margins=None, routed=None):
    """(y (B, S, D), aux) of the capacity-limited SwiGLU experts;
    ``margins`` (a list) gets the last token's gap between its k-th and
    (k+1)-th router probabilities (how near its expert choice is to a
    tie); ``routed`` (a dict) gets each expert's assignments from every
    token but the last (``before``) and the capacity (``C``)."""
    B, S, D = x.shape
    E, k = m["n_experts"], m["top_k"]
    xt = x.reshape(-1, D)
    N = xt.shape[0]
    probs, gates, ei, keep = route(xt, w["ffn/router"], m, precision)
    if margins is not None:
        top = torch.topk(probs[-1], min(k + 1, E)).values
        margins.append(float(top[k - 1] - top[-1]))
    if routed is not None:
        routed["before"] = F.one_hot(ei[:-1].reshape(-1), E).sum(0)
        routed["C"] = capacity(m, N)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero((ei == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = y.index_add(0, tok, expert(xt[tok], w, e, precision)
                        * gates[tok, slot][:, None])
    f_e = F.one_hot(ei.reshape(-1), E).float().mean(0)
    aux = E * torch.sum(f_e * probs.mean(0))
    return y.reshape(B, S, D), aux


def layer(x, w, m: dict, precision="f32", margins=None, state=None):
    """One decoder layer; ``state`` (a dict) gets what
    :func:`last_token_layer` needs: the keys, values and earlier
    assignments."""
    x = x + attention(rms_norm(x, w["norm1/g"]), w, m, precision, state)
    y, aux = moe(rms_norm(x, w["norm2/g"]), w, m, precision, margins, state)
    return x + y, aux


def last_token_layer(xb, w, m: dict, state: dict, precision="f32",
                     near_tie: float = 0.0) -> list:
    """The layer at a prompt's last position alone, from its own residual
    ``xb`` (1, D): attention over the earlier positions' keys and values
    (``state``, from :func:`layer` over the prompt) and its own, then its
    top-k experts, each kept only where the earlier tokens left it room.
    Returns the output (1, D) and, where the k-th and (k+1)-th router
    probabilities lie within ``near_tie``, the output with the (k+1)-th
    expert in the k-th's place: ``[(out, margin)]``, the margin 0 for
    the first."""
    D = xb.shape[-1]
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    Dh = m.get("head_dim") or D // Hq
    E, k = m["n_experts"], m["top_k"]
    theta = m.get("rope_theta", 10000.0)
    S = state["k"].shape[2]
    h = rms_norm(xb, w["norm1/g"])
    q = rope(mm(h, w["mixer/wq"].reshape(D, Hq * Dh), precision)
             .reshape(1, Hq, 1, Dh), theta, S - 1)
    kb = rope(mm(h, w["mixer/wk"].reshape(D, Hkv * Dh), precision)
              .reshape(1, Hkv, 1, Dh), theta, S - 1)
    vb = mm(h, w["mixer/wv"].reshape(D, Hkv * Dh), precision) \
        .reshape(1, Hkv, 1, Dh)
    K = torch.cat([state["k"][:, :, :-1], kb], 2) \
        .repeat_interleave(Hq // Hkv, 1)
    V = torch.cat([state["v"][:, :, :-1], vb], 2) \
        .repeat_interleave(Hq // Hkv, 1)
    p = torch.softmax(mm(q, K.transpose(-1, -2), precision)
                      / math.sqrt(Dh), -1)
    o = mm(p, V, precision).reshape(1, Hq * Dh)
    x1 = xb + mm(o, w["mixer/wo"].reshape(Hq * Dh, D), precision)
    h2 = rms_norm(x1, w["norm2/g"])
    probs = torch.softmax(mm(h2, w["ffn/router"], precision), -1)[0]
    top = torch.topk(probs, min(k + 1, E))
    choices = [(top.indices[:k], 0.0)]
    if E > k:
        margin = float(top.values[k - 1] - top.values[k])
        if margin < near_tie:
            choices.append((torch.cat([top.indices[:k - 1],
                                       top.indices[k:k + 1]]), margin))
    outs = []
    for ei, margin in choices:
        gv = probs[ei] / probs[ei].sum()
        y = torch.zeros_like(x1)
        for j, e in enumerate(ei.tolist()):
            if int(state["before"][e]) < state["C"]:
                y = y + gv[j] * expert(h2, w, e, precision)
        outs.append((x1 + y, margin))
    return outs


def f32_layer(model: dict, seed: int, i: int, device) -> dict:
    return {p: t.float() for p, t in
            layer_weights(model, seed, i, device).items()}


# ---------------------------------------------------------------------------
# prefill: last-position logits, layer by layer
# ---------------------------------------------------------------------------

MAX_BRANCHES = 16


@torch.no_grad()
def prefill_last_logits(model: dict, seed: int, prompts, device,
                        precision="f32", margins=None,
                        near_tie: float = 0.0) -> list[list]:
    """The last position's logits (V,) f32 of each prompt (1, S): every
    layer's weights drawn from the seed in turn and run over every
    prompt, so only one layer is held in f32 at a time.

    For each prompt a list of ``(logits, margin)``: first the prompt's
    own, then, where its last token's expert choice lay within
    ``near_tie`` of a tie in some layer, the logits with that choice
    taken the other way (a choice that rounding may tip; ``margin`` is
    the largest such gap on the way, at most ``MAX_BRANCHES`` a prompt).
    ``margins`` (a list) gets, for each prompt, the smallest router
    margin of its last token over the layers."""
    with strict_f32():
        top = {p: t.float() for p, t in
               top_weights(model, seed, device).items()}
        xs = [top["embed"][t.long()] for t in prompts]
        per = [[] for _ in prompts]
        alts = [[] for _ in prompts]          # (last residual, margin)
        for i in range(model["n_layers"]):
            w = f32_layer(model, seed, i, device)
            for j, x in enumerate(xs):
                st = {} if near_tie > 0 else None
                xs[j] = layer(x, w, model, precision, per[j], st)[0]
                if st is None:
                    continue
                grown = []
                for b, (xb, seen) in enumerate([(x[:, -1], 0.0)] + alts[j]):
                    outs = last_token_layer(xb, w, model, st, precision,
                                            near_tie)
                    grown += [(o, max(seen, mg))
                              for o, mg in (outs[1:] if b == 0 else outs)]
                alts[j] = grown[:MAX_BRANCHES - 1]
            del w
        if margins is not None:
            margins += [min(v) for v in per]

        def head(h):
            return mm(rms_norm(h, top["final_norm/g"]), top["embed"].t(),
                      precision)[0]
        return [[(head(x[:, -1]), 0.0)] + [(head(a), mg) for a, mg in alt]
                for x, alt in zip(xs, alts)]


@torch.no_grad()
def control_gaps(model: dict, seed: int, prompts, device) -> list[float]:
    """The control of a served model, read at every position: for each
    prompt the widest gap by which the reference's logit of the token
    that the float8 control puts first lies below the reference's best,
    in units of the reference logits' standard deviation there."""
    with strict_f32():
        top = {p: t.float() for p, t in
               top_weights(model, seed, device).items()}
        xs = [top["embed"][t.long()] for t in prompts]
        cs = [x.clone() for x in xs]
        for i in range(model["n_layers"]):
            w = f32_layer(model, seed, i, device)
            xs = [layer(x, w, model)[0] for x in xs]
            cs = [layer(c, w, model, "fp8")[0] for c in cs]
            del w
        out = []
        for x, c in zip(xs, cs):
            worst = 0.0
            for j in range(0, x.shape[1], 1024):
                r = mm(rms_norm(x[0, j:j + 1024], top["final_norm/g"]),
                       top["embed"].t())
                q = mm(rms_norm(c[0, j:j + 1024], top["final_norm/g"]),
                       top["embed"].t(), "fp8")
                pick = r.gather(1, q.argmax(1, keepdim=True))[:, 0]
                gap = (r.amax(1) - pick) / r.std(1)
                worst = max(worst, float(gap.max()))
            out.append(worst)
        return out
