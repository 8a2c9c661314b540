"""Helper: run a function on every rank of an N-rank gloo world.

``run_world(fn, n, tmp_path, *args)`` spawns ``n`` processes (the spawn
start method, one CPU thread each), initialises a gloo process group in
each from a ``FileStore`` under ``tmp_path`` — no TCP port, so pytest-xdist
workers never clash — calls ``fn(rank, n, *args)`` and returns the ranks'
results in rank order.  ``fn`` must be a module-level function of an
importable module, and its result picklable.

Every world has a deadline of its own (``timeout``, 120 s by default):
when it passes, the children are killed and the call fails, so a hung
collective never runs the test session into its time limit.  A rank that
raises fails the call with its traceback.
"""

from __future__ import annotations

import datetime
import pickle
import time
import traceback
from pathlib import Path

import torch
import torch.multiprocessing as mp


def _child(rank, n, store_path, out_dir, timeout, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
        result = ("ok", fn(rank, n, *args))
        dist.destroy_process_group()
    except BaseException:                    # reported to the parent
        result = ("error", traceback.format_exc())
    tmp = out.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(result))
    tmp.replace(out)                         # the parent never reads half


def _read(root: Path, rank: int):
    path = root / f"rank{rank}.pkl"
    return pickle.loads(path.read_bytes()) if path.exists() else None


def run_world(fn, n: int, tmp_path, *args, timeout: float = 120.0):
    """``[fn(0, n, *args), ..., fn(n-1, n, *args)]``, each run on its own
    rank of an ``n``-rank gloo world."""
    root = Path(tmp_path) / f"world{n}-{time.monotonic_ns()}"
    root.mkdir(parents=True)
    ctx = mp.start_processes(
        _child, args=(n, str(root / "store"), str(root), timeout, fn, args),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    done = False
    try:
        while not done and time.monotonic() < deadline:
            done = ctx.join(timeout=0.5)
            # a failed rank leaves the others waiting in a collective
            if any(r is not None and r[0] != "ok"
                   for r in (_read(root, k) for k in range(n))):
                break
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    results = [_read(root, rank) for rank in range(n)]
    for rank, res in enumerate(results):
        if res is not None and res[0] != "ok":
            raise AssertionError(f"rank {rank} of {n} failed:\n{res[1]}")
    if not done or any(res is None for res in results):
        raise TimeoutError(f"{n}-rank world did not finish in "
                           f"{timeout:.0f} s")
    return [res[1] for res in results]
