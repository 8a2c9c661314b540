"""Checkpoint store of the port (port of ``repro.checkpoint.store``): a
JSON manifest and one raw file per leaf, stdlib and numpy only.

The reference's guarantees, kept:

* **Atomicity** — a save writes ``step_XXXXXXXX.tmp``, fsyncs the manifest
  (which holds each leaf's sha256) and only then renames the directory, so
  a crashed save is never taken for a checkpoint.
* **Integrity** — restore checks every leaf's sha256, shape and the
  presence of every leaf; restoring the latest checkpoint skips one that
  fails (with a warning) and falls back to the next newest.
* **Async saves** — :meth:`CheckpointManager.save_async` snapshots every
  leaf to host memory first, then a background thread writes it while
  training goes on; ``wait()`` joins before the next save or exit.
* **Retention** — the newest ``keep`` checkpoints are kept.
* **Global arrays on a mesh** — given the state's ``ExpertSharding``
  (``parallel.sharding``), a save gathers every split leaf (experts over
  the EP group, heads / hidden dim / vocab over ``model``, the FSDP
  shards of ``d_model`` over ``pod`` / ``data``, or two of these) to
  the rank at mesh coordinate 0, which writes the global tree: slice by
  slice into its host memory (``ExpertSharding.gather_tree_to_writer``,
  a collective: every rank, in the main thread, in path order, before
  any writer thread starts), so no rank holds a global split leaf on its
  device and the others keep nothing; a restore reads the global leaves
  and keeps this rank's slices.  So a checkpoint restores with or
  without a mesh, onto any EP group, ``model`` dim and FSDP split the
  leaves divide (the reference's resharding on restore).  ``wait()``
  ends in a check every rank makes together, so no rank reads a
  directory the writer has not finished.
* **Restore onto another layout** — ``restore`` takes the layout to
  restore onto beside the one the target tree is held in (the elastic
  trainer's survivor mesh after a device loss, ``CheckpointManager
  .restore(target, sharding)``): each leaf is checked against the
  target's global shape and sliced for the new layout.  The writer rank
  and the closing check then run on the new layout's group, whose rank
  at mesh coordinate 0 writes.

Leaves are written raw, not compressed: the port needs no package beyond
torch and numpy (the reference uses msgpack and zstandard), bf16 weights
and f32 moments compress poorly, and zlib would take minutes for the
27.3 GB of a 2-layer phi3.5-moe training state.  A leaf is stored as its bytes with its dtype name, so bf16
round-trips bit for bit.  Trees are nested dicts of tensors; a leaf's key
is its ``/``-joined path.  Restore places each leaf on the device of the
matching target leaf.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import telemetry
from repro_torch.models.common import tree_leaves, tree_with_leaves
from repro_torch.parallel.sharding import collective_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(leaf) -> torch.Tensor:
    """A contiguous CPU copy of a tensor leaf (or of a number)."""
    t = torch.as_tensor(leaf)
    return t.detach().to("cpu", copy=True).contiguous()


def _bytes(t: torch.Tensor) -> memoryview:
    """The raw bytes of a contiguous CPU tensor (no copy)."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def save_checkpoint(directory, step: int, tree, extra: dict | None = None,
                    keep: int = 3, sharding=None) -> Path:
    """Synchronous atomic save of a tree of tensors; returns its path.
    With ``sharding`` (collective) the global tree is written by the
    writer rank alone, and every rank returns once it is durable."""
    with telemetry.get_tracer().span("checkpoint.save", cat="checkpoint",
                                     step=int(step)) as sp:
        if sharding is not None:
            tree = sharding.gather_tree_to_writer(tree)
        out = Path(directory) / f"step_{step:08d}"
        error = None
        if sharding is None or sharding.writer:
            try:
                out = _save_checkpoint_impl(directory, step, tree, extra,
                                            keep)
            except BaseException as e:          # every rank learns of it
                error = e
        _agree_done(sharding, error)
        sp.set(path=str(out))
        telemetry.metrics().counter("checkpoint.saves").inc()
        return out


def _agree_done(sharding, error) -> None:
    """On a mesh, every rank waits here for the writer and raises if it
    failed; alone, ``error`` is raised."""
    if sharding is not None and sharding.group is not None:
        pg = sharding.group.pg
        flag = torch.tensor([error is not None], dtype=torch.int32,
                            device=collective_device(pg))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=pg)
        if flag.item() and error is None:
            raise IOError("the checkpoint writer rank failed to save")
    if error is not None:
        raise error


def _save_checkpoint_impl(directory, step: int, tree,
                          extra: dict | None = None, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "extra": extra or {}, "codec": "raw",
                "leaves": {}}
    for i, (key, leaf) in enumerate(tree_leaves(tree)):
        t = _host(leaf)
        raw = _bytes(t)
        fname = f"leaf_{i:05d}.bin"
        with open(tmp / fname, "wb") as f:
            f.write(raw)
        manifest["leaves"][key] = {
            "file": fname, "dtype": _dtype_name(t.dtype),
            "shape": list(t.shape),
            "sha256": hashlib.sha256(raw).hexdigest()}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _retain(directory: Path, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(directory / f"step_{s:08d}", ignore_errors=True)


def all_steps(directory) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


_SAME = object()   # the default layout argument: the current one


# Failures that mean "this checkpoint is unusable", as opposed to a caller
# error: unreadable or corrupt files (OSError, including the sha256
# IOError), missing leaves, and undecodable manifests or sizes.
_INTEGRITY_ERRORS = (OSError, KeyError, ValueError)


def restore_checkpoint(directory, step: int | None, target_tree,
                       sharding=None, target_sharding=_SAME):
    """Restore into the structure of ``target_tree`` (tensors; each
    restored leaf goes to its target leaf's device).  Returns ``(tree,
    extra, step)``.  With ``sharding`` each leaf is sliced to this
    rank's shard of that layout.  ``target_sharding`` is the layout
    ``target_tree`` is held in (default ``sharding``): each leaf is
    checked against the global shape it gives.

    With ``step=None`` (the latest), a checkpoint that fails its
    integrity checks is skipped with a warning and the next newest is
    tried; an explicit ``step`` raises on corruption."""
    directory = Path(directory)
    layouts = (sharding,
               sharding if target_sharding is _SAME else target_sharding)
    if step is not None:
        return _restore_step(directory, step, target_tree, *layouts)
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    last_err = None
    for s in reversed(steps):
        try:
            return _restore_step(directory, s, target_tree, *layouts)
        except _INTEGRITY_ERRORS as e:
            last_err = e
            warnings.warn(f"skipping checkpoint step {s}: "
                          f"{type(e).__name__}: {e}; falling back to the "
                          f"next newest", RuntimeWarning, stacklevel=2)
    raise IOError(f"all {len(steps)} retained checkpoints in {directory} "
                  f"are unusable") from last_err


def _restore_step(directory: Path, step: int, target_tree, sharding,
                  target_sharding):
    with telemetry.get_tracer().span("checkpoint.restore", cat="checkpoint",
                                     step=int(step), verify=True):
        out = _restore_step_impl(directory, step, target_tree, sharding,
                                 target_sharding)
        telemetry.metrics().counter("checkpoint.restores").inc()
        return out


def _restore_step_impl(directory: Path, step: int, target_tree, sharding,
                       target_sharding):
    base = directory / f"step_{step:08d}"
    with open(base / "manifest.json") as f:
        manifest = json.load(f)
    out = {}
    for key, ref in tree_leaves(target_tree):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint at step {step} missing leaf {key}")
        dtype = _DTYPES[info["dtype"]]
        t = torch.from_numpy(np.fromfile(base / info["file"], np.uint8))
        if hashlib.sha256(memoryview(t.numpy())).hexdigest() \
                != info["sha256"]:
            raise IOError(f"corrupt leaf {key} in step {step}")
        t = t.view(dtype).reshape(info["shape"])
        ref = torch.as_tensor(ref)
        want = tuple(ref.shape) if target_sharding is None \
            else target_sharding.global_shape(key, ref.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"target {want}")
        if sharding is not None:
            t = sharding.local(key, t)
        out[key] = t.to(ref.device)
    return tree_with_leaves(target_tree, out), manifest["extra"], step


class CheckpointManager:
    """Async checkpointing with retention and a preemption-safe wait.
    With ``sharding`` (the state tree's ``ExpertSharding``) every call is
    collective: every rank of the mesh makes it, in the same order."""

    def __init__(self, directory, keep: int = 3, sharding=None):
        self.directory = Path(directory)
        self.keep = keep
        self.sharding = sharding
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree, extra=None):
        """Snapshot ``tree`` to host memory now, write it in a thread (on
        a mesh: gather to the writer rank's host here, on every rank; the
        writer rank's thread writes)."""
        self.wait()
        if self.sharding is None:
            host_tree = tree_with_leaves(
                tree, {k: _host(v) for k, v in tree_leaves(tree)})
        else:
            host_tree = self.sharding.gather_tree_to_writer(tree)
            if host_tree is None:
                return

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra,
                                self.keep)
            except BaseException as e:    # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree, extra=None):
        self.wait()
        return save_checkpoint(self.directory, step, tree, extra, self.keep,
                               self.sharding)

    def wait(self):
        """Join the pending async save; raise its error, if it failed (on
        a mesh: on every rank, after the writer has finished)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        _agree_done(self.sharding, err)

    def latest(self):
        return latest_step(self.directory)

    def restore(self, target_tree, sharding=_SAME, step=None):
        """Restore the latest checkpoint (or ``step``) into the structure
        of ``target_tree``, which is held in the manager's layout.  With
        ``sharding`` (another layout, e.g. a survivor mesh's) the leaves
        are sliced for it and the manager keeps it: later saves and
        waits run on its group."""
        held = self.sharding
        if sharding is not _SAME:
            self.sharding = sharding
        return restore_checkpoint(self.directory, step, target_tree,
                                  self.sharding, held)
