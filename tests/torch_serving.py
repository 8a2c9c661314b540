"""Helper of ``tests/test_torch_serving_disagg.py``: the tiny f32 model's
configuration, the request scripts, and the gloo world's worker.  It
imports no jax (every spawned rank imports this module).

Each case serves one request script through a
:class:`~repro_torch.runtime.serving.DisaggregatedServer` on a
mesh-backed comm, every rank calling the same ticks; a case with a
``rebuild`` entry rebuilds the server over the given global ranks after
that many ticks.  A rank left out of a rebuild waits at the world's
closing barrier.
"""

from __future__ import annotations

import numpy as np
import torch

# the tiny f32 model of tests/test_serving.py
BASE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64, param_dtype="float32",
            compute_dtype="float32", remat=False)
MAX_SEQ = 48

# request scripts: (prompts, max_new) of tests/test_serving.py
SCRIPTS = {
    "five": ([[1, 2, 3], [10, 11], [5, 6, 7, 8], [20], [30, 31, 32]],
             [4, 6, 3, 5, 4]),
    "six": ([[1, 2, 3], [10, 11], [5, 6, 7, 8], [20], [30, 31, 32],
             [40, 41]], [4, 6, 3, 5, 4, 5]),
}


def requests(module, script: str, tenants: bool = True) -> list:
    """The script's requests as ``module.Request`` objects (the port's or
    the reference's), in two tenants when ``tenants``."""
    prompts, max_news = SCRIPTS[script]
    return [module.Request(i, list(p), m,
                           **({"tenant": f"t{i % 2}"} if tenants else {}))
            for i, (p, m) in enumerate(zip(prompts, max_news))]


def _serve(rank: int, n: int, case: dict, params_np) -> dict:
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime import serving

    cfg = ModelConfig(**BASE, window=case.get("window"))
    model = build_model(cfg)
    params = params_from_jax(params_np, cfg, "cpu")
    mesh = cart_create(n, case["dims"], case["names"], device_type="cpu")
    comm = torus_comm(mesh, case["names"])
    srv = serving.DisaggregatedServer(
        model, params, comm, max_seq=MAX_SEQ,
        decode_batch=case["decode_batch"], n_prefill=case["n_prefill"],
        backend=case["backend"], device="cpu")
    for req in requests(serving, case["script"]):
        srv.submit(req)
    requeued = None
    if "rebuild" in case:
        tick, surviving, n_prefill = case["rebuild"]
        for _ in range(tick):
            srv.tick()
        requeued = srv.rebuild(surviving, n_prefill=n_prefill)
    srv.run()
    topo = srv.topology
    return {"done": dict(srv.done), "ticks": srv.ticks,
            "migrations": topo.migrations,
            "migrated_rows": topo.migrated_rows,
            "n_prefill": topo.n_prefill, "n_decode": topo.n_decode,
            "inner_kind": topo.plan.inner_kind,
            "kind": topo.plan.describe()["kind"],
            "lost": srv.lost, "requeued": requeued}


def world_cases(rank: int, n: int, cases: dict, params_np) -> dict:
    """Serve every case in order on this rank; ``params_np`` maps a
    window to the reference's parameter tree (numpy leaves)."""
    import torch.distributed as dist
    torch.manual_seed(0)
    out = {name: _serve(rank, n, case, params_np[case.get("window")])
           for name, case in cases.items()}
    dist.barrier()
    return out


def as_numpy(tree):
    """A parameter tree with numpy leaves (picklable for the ranks)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
