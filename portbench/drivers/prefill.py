"""Prefill: the port's ``make_prefill_fn`` (full-sequence forward,
last-position logits), one request a call, closed-loop, back to back.

Prompt lengths come in blocks that all hold the same lengths
(``traffic.block_lengths``), each block in an order drawn from the seed,
and the window serves whole blocks (a block started before ``seconds``
have passed is finished), so every seed does the same work.  Every
distinct length is prefilled once during set-up, longest first.  A
request is timed from the call to its logits being on the host.  Once the window has closed the program is
freed and a sample of the finished requests drawn from the seed, the
longest finished one among them, is run through the reference; each
sampled request's logits are held against the reference's (its own, or
those with a near-tie expert choice of the last token taken the other
way, ``limits/<cell>.json``'s ``near_tie``).
"""

from __future__ import annotations

import time

import torch

from .. import work
from ..probes import RouterProbe
from ..reference.model import prefill_last_logits
from ..runtime import (free_memory, judge, model_config, p95, sync,
                       synchronizer)
from ..trace import capture
from ..traffic import block_lengths, prompt, prompt_lengths
from ..weights import flatten, generator, program_params


def build(model: dict, seed: int, device):
    from repro_torch.models import build_model, make_prefill_fn
    net = build_model(model_config(model))
    specs = {p: tuple(s.shape) for p, s in flatten(net.specs()).items()}
    params = program_params(model, seed, device)
    have = {p: tuple(t.shape) for p, t in flatten(params).items()}
    if have != specs:
        raise ValueError(f"the benchmark's parameter layout {have} is not "
                         f"the program's {specs}")
    return make_prefill_fn(net), params


def sample(finished: list, n: int, seed: int) -> list:
    """Indices into ``finished`` ((index, length) pairs): the longest, and
    ``n - 1`` others drawn from the seed."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: finished[i][1])
    rest = [i for i in range(len(finished)) if i != longest]
    perm = torch.randperm(len(rest), generator=generator("cpu", seed,
                                                         "sample"))
    return [longest] + [rest[i] for i in perm[:n - 1].tolist()]


def readings(prog: list, ref: list) -> dict:
    """Over the sampled requests, against the nearest of each request's
    reference candidates (its own logits, or those with a near-tie expert
    choice of the last token taken the other way): the median relative
    error of the last-position logits, ``max |prog - ref| / max |ref|``
    (``logit_err_median``), and the widest gap by which the reference's
    logit of the token the program puts first lies below the reference's
    best, in units of the reference logits' standard deviation
    (``token_gap``).  ``ref`` holds each request's ``[(logits, margin),
    ...]``."""
    errs, main, gaps, branch = [], [], [], []
    for p, cands in zip(prog, ref):
        p = p.to(cands[0][0].device).float()
        e = [float((p - r).abs().max() / r.abs().max()) for r, _ in cands]
        best = min(range(len(e)), key=e.__getitem__)
        errs.append(e[best])
        main.append(e[0])
        gaps.append(min(float((r.max() - r[p.argmax()]) / r.std())
                        for r, _ in cands))
        branch.append([len(cands), cands[best][1]])
    return {"logit_err_median": sorted(errs)[len(errs) // 2],
            "token_gap": max(gaps), "_errs": errs, "_errs_own": main,
            "_gaps": gaps, "_branches": branch}


def run(cell, seed: int, seconds: float, trace: bool, *, start: float,
        device="cuda") -> dict:
    device = torch.device(device)
    model, mix = cell.config["model"], cell.traffic
    V = model["vocab"]
    prefill, params = build(model, seed, device)
    lengths = prompt_lengths(mix, seed, mix["pool_blocks"])
    for L in sorted(set(block_lengths(mix["lengths"])), reverse=True):
        prefill(params, prompt(mix, V, seed, -1, L, device)).cpu()
    pool = [prompt(mix, V, seed, j, L, device)
            for j, L in enumerate(lengths)]
    sync(device)
    setup_s = time.perf_counter() - start

    finished, outs, lat = [], [], []
    block = mix["lengths"]["block"]

    def serve(blocks=None, until=None):
        """Whole blocks of requests, ``blocks`` of them or as many as start
        before ``until`` seconds have passed."""
        t0, j = time.perf_counter(), 0
        while (j < blocks * block) if blocks is not None else \
                (j % block or time.perf_counter() - t0 < until):
            i = j % len(pool)
            t = time.perf_counter()
            out = prefill(params, pool[i]).cpu()
            lat.append(time.perf_counter() - t)
            outs.append(out[0])
            finished.append((i, lengths[i]))
            j += 1
        return j

    out = {"setup_s": setup_s, "e2e": {}, "work": {}}
    if trace:
        probe = RouterProbe(model)
        with probe:
            done, tr = capture(lambda: serve(blocks=mix["trace_blocks"]),
                               synchronizer(device))
        out["trace"], out["window_s"] = tr, tr.window_s
        out["work"] = prefill_work(model, [L for _, L in finished], probe)
    else:
        t0 = time.perf_counter()
        done = serve(until=seconds)
        window = time.perf_counter() - t0
        out["window_s"] = window
        out["e2e"] = {
            "prefill_tokens_per_s": sum(L for _, L in finished) / window,
            "prefill_ms_p95": 1e3 * p95(lat), "setup_s": setup_s}
        out["requests"] = done
    failed = sum(not bool(torch.isfinite(o).all()) for o in outs)
    out.update(attempted=done, failed=failed)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del params, prefill, pool, serve
    free_memory(device)

    picked = sample(finished, mix["check_requests"], seed)
    prompts = [prompt(mix, V, seed, finished[k][0], finished[k][1], device)
               for k in picked]
    margins = []
    ref = prefill_last_logits(model, seed, prompts, device, margins=margins,
                              near_tie=cell.limits.get("near_tie", 0.0))
    out["readings"] = readings([outs[k] for k in picked], ref)
    out["readings"]["_router_margins"] = margins
    out["_check"] = {"prompts": prompts, "ref": ref}
    out["readings"]["_sampled_tokens"] = sum(finished[k][1] for k in picked)
    out["correct"], out["checks"] = judge(out["readings"], cell.limits)
    out["correct"] = out["correct"] and failed == 0
    return out


def prefill_work(model: dict, lengths: list, probe) -> dict:
    """Work of the traced requests: the grouped matmuls' least time and
    the model FLOPs (the head at the one position returned)."""
    D, F, E = model["d_model"], model["d_ff"], model["n_experts"]
    gmm = sum(work.gmm_bound_s(k, D, F, E) for _, k in probe.calls)
    flops = sum(work.forward_flops(model, 1, L, 0, 1) for L in lengths) \
        + 2.0 * probe.kept * 3 * D * F
    return {"gmm_bound_s": gmm, "model_flops": flops,
            "requests": len(lengths), "kept_rows": probe.kept}
