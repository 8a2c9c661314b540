"""Small cells for the CPU tests: each real cell's files with the model
cut to a toy width and the traffic to a toy size (the limits stay the
cell's own)."""

from __future__ import annotations

import dataclasses

from portbench import manifest

SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
             n_experts=4)
TRAFFIC = {
    "grok1-prefill": dict(lengths=dict(dist="lognormal", median=16,
                                       sigma=1.0, min=8, max=64, block=8),
                          pool_blocks=2, check_requests=4),
    "phi35moe-ep-a2a": dict(tokens_per_rank=64, warm_pairs=1,
                            check_pairs=2, trace_pairs=2, host_pairs=2),
}
SEED = 2 ** 31 + 11


def small_cell(name: str) -> manifest.Cell:
    c = manifest.cell(name)
    model = dict(c.config["model"], **SMALL)
    return dataclasses.replace(c, config=dict(c.config, model=model),
                               traffic=dict(c.traffic, **TRAFFIC[name]))


def _world_rank(rank, world, port, cell, seed, no_exchange, queue,
                trace=False):
    import time

    import torch

    from portbench.drivers import a2a
    torch.set_num_threads(1)
    if no_exchange:
        from repro_torch.core.plan import A2APlan
        A2APlan.forward = A2APlan.reverse = lambda self, x: x.clone()
    ranks = a2a.rank_body(rank, world, port, "gloo", cell, seed, 0.1, trace,
                          time.time())
    if rank == 0:
        queue.put(ranks)


def gloo_world(cell, seed: int, no_exchange: bool = False,
               trace: bool = False) -> list:
    """The a2a cell's ranks on the CPU, every rank a fresh spawned process
    (the port caches its meshes per process); rank 0's gathered results.
    ``no_exchange`` breaks the timed path: the plan's calls return their
    input (the exchange between cards left out); ``trace`` runs the
    traced window instead of the timed one."""
    import multiprocessing as mp

    from portbench.drivers import a2a
    world = cell.chips
    port = a2a.free_port()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_world_rank, args=(r, world, port, cell,
                                                   seed, no_exchange, queue,
                                                   trace))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ranks = queue.get(timeout=120)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    return ranks
