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
raises fails the call with its traceback; a rank that dies without one (a
signal, a crash in teardown) fails it with every rank's exit code or
signal and whether the rank wrote its result.

``fsdp_layout`` reports, inside a rank, how it holds the FSDP leaves of a
parameter tree, for the mesh training tests to hold against the global
tree.
"""

from __future__ import annotations

import datetime
import pickle
import signal
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


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
    done, died = False, None
    try:
        while not done and time.monotonic() < deadline:
            try:
                done = ctx.join(timeout=0.5)
            except ProcessException as e:    # a rank exited non-zero
                died = e
                break
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
    if died is not None:
        ranks = "; ".join(
            f"rank {k}: {_exit(proc.exitcode)}, "
            f"{'result written' if results[k] else 'no result'}"
            for k, proc in enumerate(ctx.processes))
        raise AssertionError(f"{n}-rank world: {died} ({ranks})")
    if not done or any(res is None for res in results):
        raise TimeoutError(f"{n}-rank world did not finish in "
                           f"{timeout:.0f} s")
    return [res[1] for res in results]


def _exit(code) -> str:
    if code is not None and code < 0:
        try:
            return f"signal {signal.Signals(-code).name}"
        except ValueError:
            return f"signal {-code}"
    return f"exit code {code}"


def _block(a, dim, i, n):
    """Block ``i`` of ``n`` along ``dim`` of the array ``a``."""
    k = a.shape[dim] // n
    return np.take(a, range(i * k, (i + 1) * k), axis=dim)


def fsdp_layout(mesh, sh, params, opt_state, global_params):
    """This rank's FSDP split: the leaves and dims, the axes kept, the
    expert leaves, and for each FSDP leaf whether it is block ``pod *
    |data| + data`` (row-major over the kept axes) of the global leaf
    (of this rank's ``model`` slice where ``model`` splits it too: of
    each column group of a paired leaf, side by side), with
    AdamW moments of its shape.  ``sh`` is the parameters'
    ``ExpertSharding`` and ``global_params`` the global tree (numpy)."""
    from repro_torch.core.cache import mesh_shape
    from repro_torch.models.common import tree_leaves
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    f, size = 0, 1
    for a in sh.fsdp_kept:
        f, size = f * shape[a] + coord[a], size * shape[a]
    glob = dict(tree_leaves(global_params))
    mu = dict(tree_leaves(opt_state["mu"]))
    blocks = {}
    for p, t in tree_leaves(params):
        if p not in sh.fsdp_axes:
            continue
        want = np.asarray(glob[p])
        if p in sh.model_axes:      # each column group's block, side by side
            dim = sh.model_axes[p]
            want = np.concatenate(
                [_block(g, dim, coord["model"], shape["model"]) for g in
                 np.split(want, sh.model_groups.get(p, 1), axis=dim)],
                axis=dim)
        want = _block(want, sh.fsdp_axes[p], f, size)
        blocks[p] = (np.array_equal(t.detach().numpy(), want)
                     and tuple(mu[p].shape) == tuple(t.shape))
    return {"axes": dict(sh.fsdp_axes), "kept": sh.fsdp_kept,
            "blocks": blocks, "experts": sorted(sh.axes)}
