"""The MoE's dispatch / combine exchange across the cards: the plan the
port's MoE layer builds (``models.moe.moe_a2a_plan`` over the EP axes of
a Cartesian mesh), driven on one process per card.

Every rank holds a send buffer ``(G, E_loc * C * D)`` (block ``i`` for
EP rank ``i``) drawn from the seed and its rank, and alternates the
plan's ``forward`` (dispatch) and ``reverse`` (combine), each call's
input the previous call's output.  The ranks agree every
``check_pairs`` pairs whether the window's seconds have passed, so each
runs the same collectives.  After the window the last ``forward``
output must equal the all-to-all's definition (block ``i`` = rank
``i``'s buffer's block for this rank) and the last ``reverse`` output
the rank's own buffer, bit for bit: any call that lost or moved a byte
shows in them.

Rank 0 runs in the calling process; the others are spawned, and all
meet over a TCP store on ``127.0.0.1``.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from ..probes import ReorderProbe
from ..reference.model import capacity
from ..runtime import forbidden_modules, model_config, sync, synchronizer
from ..trace import capture
from ..traffic import a2a_block

TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def geometry(cell) -> tuple:
    """(G, E_loc, C, D): the EP group, experts a rank, capacity, width."""
    m, mix = cell.config["model"], cell.traffic
    G = math.prod(mix["mesh"]["dims"])
    return G, m["n_experts"] // G, capacity(m, mix["tokens_per_rank"]), \
        m["d_model"]


def definition(shape, seed: int, me: int, G: int, device) -> torch.Tensor:
    """What the all-to-all gives rank ``me``: block ``i`` of rank ``i``'s
    buffer for ``me``."""
    return torch.stack([a2a_block(shape, seed, i, device)[me]
                        for i in range(G)])


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ."""
    return int(torch.ne(a.contiguous().view(torch.int16),
                        b.contiguous().view(torch.int16)).sum())


def build_plan(cell, device_type: str):
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import moe_a2a_plan
    mix = cell.traffic
    cfg = model_config(cell.config["model"])
    G, E_loc, C, _ = geometry(cell)
    mesh = cart_create(G, tuple(mix["mesh"]["dims"]),
                       tuple(mix["mesh"]["names"]), device_type=device_type)
    return moe_a2a_plan(cfg, mesh, tuple(mix["ep_axes"]), E_loc, C)


def pin_cores(rank: int, world: int) -> None:
    """Keep this process on its own ``1 / world`` of the host's cores."""
    cores = sorted(os.sched_getaffinity(0))
    n = len(cores) // world
    if n:
        os.sched_setaffinity(0, cores[rank * n:(rank + 1) * n])


def rank_body(rank: int, world: int, port: int, backend: str, cell,
              seed: int, seconds: float, trace: bool, start_wall: float):
    """One rank's whole run; returns its result dict (every rank).  On
    the cards every rank holds its own card and its own share of the
    host's cores."""
    device = torch.device("cuda", rank) if backend == "nccl" \
        else torch.device("cpu")
    if device.type == "cuda":
        pin_cores(rank, world)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        return _rank(rank, world, device, cell, seed, seconds, trace,
                     start_wall)
    finally:
        dist.destroy_process_group()


def _rank(rank, world, device, cell, seed, seconds, trace, start_wall):
    mix = cell.traffic
    G, E_loc, C, D = geometry(cell)
    plan = build_plan(cell, device.type)
    shape = (G, E_loc * C * D)
    x0 = a2a_block(shape, seed, rank, device)
    state = {"x": x0, "y": None}

    def pairs(n: int) -> None:
        x = state["x"]
        for _ in range(n):
            y = plan.forward(x)
            x = plan.reverse(y)
        state["x"], state["y"] = x, y

    pairs(mix["warm_pairs"])
    sync(device)
    setup_s = time.time() - start_wall

    def window(seconds: float) -> int:
        """Pairs until ``seconds`` have passed on the slowest rank, the
        ranks agreeing every ``check_pairs`` pairs."""
        done, t0 = 0, time.perf_counter()
        while True:
            pairs(mix["check_pairs"])
            done += mix["check_pairs"]
            late = torch.tensor([time.perf_counter() - t0 >= seconds],
                                dtype=torch.int32, device=device)
            dist.all_reduce(late, op=dist.ReduceOp.MAX)
            if int(late):
                return done

    out = {"rank": rank, "setup_s": setup_s,
           "block_bytes": x0.numel() * x0.element_size(),
           "plan": plan.describe()}
    dist.barrier()
    if trace:
        probe = ReorderProbe()
        with probe:
            _, tr = capture(lambda: pairs(mix["trace_pairs"]),
                            synchronizer(device), tag=str(rank))
        out.update(trace=tr, reorder_bytes=probe.bytes,
                   reorder_launches=probe.launches,
                   plan_host_s=host_calls(plan, state, mix["host_pairs"],
                                          device),
                   calls=2 * mix["trace_pairs"], window_s=tr.window_s)
    else:
        t0 = time.perf_counter()
        n_pairs = window(seconds)
        sync(device)
        out.update(window_s=time.perf_counter() - t0, calls=2 * n_pairs)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    x, y = state["x"], state["y"]
    del state, plan
    out["reverse_mismatches"] = mismatches(x, x0)
    del x, x0
    out["forward_mismatches"] = mismatches(
        y, definition(shape, seed, rank, G, device))
    out["forbidden"] = forbidden_modules()
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(out, gathered, dst=0)
    return gathered


def host_calls(plan, state: dict, n: int, device) -> list[float]:
    """Host seconds of each of ``n`` dispatch + combine pairs' calls, each
    started on an idle card and timed from the call to its return (the
    plan's own work on the host: layout, the reorder launches, the
    collectives' posting), with no span or synchronisation inside."""
    x, y, took = state["x"], state["y"], []
    for _ in range(n):
        for fwd in (True, False):
            sync(device)
            t = time.perf_counter()
            if fwd:
                y = plan.forward(x)
            else:
                x = plan.reverse(y)
            took.append(time.perf_counter() - t)
    sync(device)
    state["x"], state["y"] = x, y
    return took


def _child(rank, world, port, backend, cell, seed, seconds, trace,
           start_wall):
    rank_body(rank, world, port, backend, cell, seed, seconds, trace,
              start_wall)


def topology() -> str:
    """What ``nvidia-smi`` says of the links between the cards: the
    topology matrix, else the NVLink status."""
    said = []
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "-s"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            said.append(f"{' '.join(cmd)}: {e}")
            continue
        said.append(f"{' '.join(cmd)} (rc {out.returncode}):\n"
                    f"{out.stdout.strip() or out.stderr.strip()}")
        if out.returncode == 0 and out.stdout.strip():
            break
    return "\n".join(said)


def run(cell, seed: int, seconds: float, trace: bool, *, start: float,
        device="cuda") -> dict:
    import multiprocessing as mp
    world = cell.chips
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        print(f"[a2a] link topology:\n{topology()}", file=sys.stderr)
    start_wall = time.time() - (time.perf_counter() - start)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, backend, cell, seed, seconds,
                               trace, start_wall))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        ranks = rank_body(0, world, port, backend, cell, seed, seconds,
                          trace, start_wall)
    finally:
        for p in procs:
            p.join(TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad_exit = [p.exitcode for p in procs if p.exitcode != 0]
    if bad_exit:
        raise RuntimeError(f"a rank exited with {bad_exit}")
    return summarize(cell, ranks, trace)


def summarize(cell, ranks: list, trace: bool) -> dict:
    """The cell's result from every rank's: the slowest rank's rate."""
    mism = {"forward_mismatches": sum(r["forward_mismatches"] for r in ranks),
            "reverse_mismatches": sum(r["reverse_mismatches"] for r in ranks)}
    from ..runtime import judge
    correct, checks = judge(mism, cell.limits)
    calls = ranks[0]["calls"]
    out = {"setup_s": max(r["setup_s"] for r in ranks),
           "attempted": calls, "failed": 0, "readings": mism,
           "correct": correct, "checks": checks,
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
           "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
           "plan": ranks[0]["plan"], "e2e": {}, "work": {}}
    if trace:
        out["trace"] = [r["trace"] for r in ranks]
        out["window_s"] = sum(r["window_s"] for r in ranks) / len(ranks)
        host = [s for r in ranks for s in r["plan_host_s"]]
        out["work"] = {"reorder_bytes": sum(r["reorder_bytes"] for r in ranks),
                       "reorder_launches": sum(r["reorder_launches"]
                                               for r in ranks),
                       "plan_host_us": [1e6 * s for s in host],
                       "calls": calls}
    else:
        slowest = max(r["window_s"] for r in ranks)
        out["window_s"] = slowest
        out["e2e"] = {"a2a_GBps": ranks[0]["block_bytes"] * calls
                      / slowest / 1e9,
                      "setup_s": out["setup_s"]}
    return out
