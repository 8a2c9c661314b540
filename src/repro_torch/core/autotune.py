"""Measured plan selection with a persistent tuning DB (port of
``repro.core.autotune``).

``tuning.choose_algorithm`` picks a plan from the alpha-beta model;
:func:`autotune` picks it from measurements: it times real executions of
the candidate plans for one ``(mesh, axes, block_shape, dtype)`` key and
records the winner in a JSON database keyed by :func:`db_fingerprint`
(the mesh's rank fingerprint and the process-group backend, since a
winner measured over gloo says nothing about NCCL) plus the plan key, so
the search runs once per machine, backend and shape.

Search space (bounded by ``budget_seconds``):

* backend — ``direct`` | ``factorized`` | ``overlap``,
* round order — permutations of the active rounds (every one for d <= 3,
  identity and reversal beyond),
* ``n_chunks`` of the overlap engine — powers of two up to ``max_chunks``
  plus the model's ``choose_chunks``,
* other factorizations of the same ranks
  (``tuning.candidate_factorizations``), timed on auxiliary Cartesian
  meshes and recorded as rows that can never win (``eligible: False``):
  they steer how a mesh is built and never replace the caller's axes.
  Where the tuned axes do not span the mesh, each subgroup of them (the
  other axes pinned) builds its own auxiliary mesh over its members and
  all subgroups time the candidate side by side.

The search is SPMD: every rank of the world runs it, since every plan it
times is a collective.  The ranks agree on everything that decides what
runs next: a candidate's score is the largest of the ranks' medians (a
collective ends with its slowest rank), the budget is read on rank 0's
clock and broadcast, the link fit gives up on the reduced times, and rank
0 alone writes the DB, after which every rank re-resolves.  Per
candidate: ``warmup`` untimed calls, then ``repeats`` timed ones, each
after a barrier and ending in a device synchronise; every call counts in
``autotune_stats()["timing_executions"]``, so a DB hit can be shown to
time nothing.  The tracer is off around the timed calls.

Per-axis links: a two-point alpha-beta fit over each active axis turns
single-axis all-to-all times into per-axis
:class:`~repro_torch.core.tuning.LinkModel` s, recorded with the winner;
a DB-hit plan is priced with them instead of ``tuning.default_links``
(the reference's TPU link constants).

``plan_all_to_all(..., backend="autotune")`` reads the DB: a hit builds
the recorded winner (``tuned_from: "measured"``); a miss falls back to the
cost model (``tuned_from: "model"``) and measures nothing.  Only an
explicit :func:`autotune` call times anything.

DB location: ``$REPRO_TORCH_TUNING_DB``, else
``~/.cache/repro_torch/tuning.json``.  The file format and the keys of
device-agnostic (dims-tuple) plans are the reference's.  A corrupt,
truncated or unreadable file loads as empty with a warning: building a
plan never fails on tuning state.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import telemetry
from .cache import (cart_create, device_fingerprint, get_factorization,
                    mesh_shape)
from .dims import max_dims
from .factorized import _as_tuple
from .plan import dtype_name, itemsize, torch_dtype
from .tuning import LinkModel, candidate_factorizations, choose_chunks

DB_VERSION = 1

# Backends the measured search may record as a winner (and that a DB
# record is allowed to request at plan-build time).
MEASURED_BACKENDS = ("direct", "factorized", "overlap")

# Backends the ragged-family measured search (``autotune_ragged``) may
# record as a winner: the dense-bucketed ragged executor vs the
# sparse-neighborhood one.  Sparse must *win on measured time* to be
# recorded — there is no analytic shortcut into a measured record.
RAGGED_MEASURED_BACKENDS = ("ragged", "sparse")


# ---------------------------------------------------------------------------
# The persistent tuning database
# ---------------------------------------------------------------------------

def default_db_path() -> Path:
    """``$REPRO_TORCH_TUNING_DB`` override, else
    ``~/.cache/repro_torch/tuning.json`` (``$XDG_CACHE_HOME`` honored): a
    file of the port's own, never the reference's."""
    env = os.environ.get("REPRO_TORCH_TUNING_DB")
    if env:
        return Path(env).expanduser()
    cache_home = os.environ.get("XDG_CACHE_HOME")
    base = Path(cache_home).expanduser() if cache_home \
        else Path.home() / ".cache"
    return base / "repro_torch" / "tuning.json"


# Per-DB-path write counters, bumped on every successful write/clear so
# the plan registry (which caches resolved "autotune" plans) can key on
# DB state and re-resolve after a new measurement lands.  Per path, not
# global: writing a scratch DB must not invalidate cached plans resolved
# against the default one.
_GENERATIONS: dict[str, int] = {}


def db_generation(path=None) -> int:
    p = Path(path).expanduser() if path is not None else default_db_path()
    return _GENERATIONS.get(str(p), 0)


def _bump_generation(path: Path) -> None:
    _GENERATIONS[str(path)] = _GENERATIONS.get(str(path), 0) + 1


class TuningDB:
    """Persistent ``key -> measured record`` store (one JSON file).

    Robustness contract: a missing, corrupt, truncated, or unreadable
    file loads as empty with a single warning; a failed write warns and
    leaves the in-memory state usable.  Writes are atomic (temp file +
    ``os.replace``) so a crashed process never truncates the DB.

    Lock contention contract: the advisory flock serializing
    read-merge-writes is acquired with a bounded timeout
    (``lock_timeout`` seconds, exponential backoff between attempts;
    default from ``$REPRO_TORCH_TUNING_LOCK_TIMEOUT`` or 5s).  A wedged
    lock-holder therefore degrades this process to *in-memory tuning* —
    the record lands in a per-handle overlay that ``get``/``load`` still
    see — instead of hanging the trainer on a file lock.
    """

    def __init__(self, path: str | os.PathLike | None = None,
                 lock_timeout: float | None = None):
        self.path = Path(path).expanduser() if path is not None \
            else default_db_path()
        # precomputed string form: the plan registry embeds it in every
        # autotune cache key, on the steady-state fetch path
        self.path_key = str(self.path)
        if lock_timeout is None:
            lock_timeout = float(os.environ.get(
                "REPRO_TORCH_TUNING_LOCK_TIMEOUT", 5.0))
        self.lock_timeout = lock_timeout
        # records that could not be persisted (lock timeout): visible to
        # this handle's reads, overwritten by any later successful put
        self._overlay: dict[str, dict] = {}

    def generation(self) -> int:
        return _GENERATIONS.get(self.path_key, 0)

    def load(self) -> dict:
        """The ``{key: record}`` entry map (empty on any load problem)."""
        try:
            raw = self.path.read_text()
        except FileNotFoundError:
            return self._with_overlay({})
        except (OSError, UnicodeDecodeError) as e:
            # UnicodeDecodeError: corrupted-to-garbage bytes (not UTF-8)
            warnings.warn(f"unreadable tuning DB {self.path}: {e}; "
                          "treating as empty", stacklevel=2)
            return self._with_overlay({})
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict) or \
                    not isinstance(doc.get("entries"), dict):
                raise ValueError("not a tuning-DB document")
        except (ValueError, TypeError) as e:
            warnings.warn(f"corrupt tuning DB {self.path} ({e}); "
                          "treating as empty", stacklevel=2)
            return self._with_overlay({})
        if doc.get("version") != DB_VERSION:
            # A future format: don't guess, don't crash, don't clobber
            # until someone actually stores a new measurement.
            warnings.warn(f"tuning DB {self.path} has version "
                          f"{doc.get('version')!r} != {DB_VERSION}; "
                          "ignoring its entries", stacklevel=2)
            return self._with_overlay({})
        return self._with_overlay(doc["entries"])

    def _with_overlay(self, entries: dict) -> dict:
        """Merge unpersisted (lock-timeout) records over the file state."""
        if self._overlay:
            entries = {**entries, **self._overlay}
        return entries

    def get(self, key: str) -> dict | None:
        return self.load().get(key)

    def put(self, key: str, record: dict) -> bool:
        """Merge one record and persist; True if the write landed.

        The read-merge-write runs under an advisory file lock (POSIX
        ``flock`` on ``<db>.lock``) so two processes autotuning different
        keys against the shared default DB don't drop each other's
        records; where locking is unavailable the atomic replace still
        prevents corruption (last writer wins per whole file).

        If the lock cannot be acquired within ``lock_timeout`` seconds
        (a wedged holder), the record is kept in this handle's in-memory
        overlay — reads still see it, a later successful ``put`` flushes
        it — and False is returned after a warning, never a hang.
        """
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self._locked():
                entries = self.load()   # merges any pending overlay
                entries[key] = record
                doc = {"version": DB_VERSION, "entries": entries}
                tmp = self.path.with_name(self.path.name + ".tmp")
                tmp.write_text(json.dumps(doc, indent=1))
                os.replace(tmp, self.path)
        except TimeoutError as e:
            self._overlay[key] = record
            warnings.warn(
                f"{e}; degrading to in-memory tuning (record kept in this "
                "process, not persisted)", stacklevel=2)
            _bump_generation(self.path)   # readers of this handle see it
            return False
        except OSError as e:
            warnings.warn(f"could not write tuning DB {self.path}: {e}",
                          stacklevel=2)
            return False
        self._overlay.clear()             # flushed with this write
        _bump_generation(self.path)
        return True

    def _locked(self):
        import contextlib
        try:
            import fcntl
        except ImportError:                   # non-POSIX: best effort
            return contextlib.nullcontext()
        timeout = self.lock_timeout

        @contextlib.contextmanager
        def lock():
            lockfile = self.path.with_name(self.path.name + ".lock")
            with open(lockfile, "w") as fh:
                # Non-blocking acquisition with exponential backoff: a
                # wedged holder must surface as a TimeoutError the caller
                # degrades on, never as an indefinite flock wait.
                deadline = time.perf_counter() + max(0.0, timeout)
                delay = 0.005
                while True:
                    try:
                        fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        if time.perf_counter() >= deadline:
                            raise TimeoutError(
                                f"tuning-DB lock {lockfile} not acquired "
                                f"within {timeout}s")
                        time.sleep(delay)
                        delay = min(delay * 2, 0.1)
                try:
                    yield
                finally:
                    fcntl.flock(fh, fcntl.LOCK_UN)
        return lock()

    def clear(self) -> None:
        """Delete the DB file (missing file is fine).  Takes the same
        advisory lock as ``put`` so a concurrent read-merge-write can't
        resurrect the cleared entries."""
        self._overlay.clear()
        try:
            with self._locked():
                self.path.unlink()
        except FileNotFoundError:
            pass
        except TimeoutError as e:
            warnings.warn(f"{e}; cleared in-memory state only",
                          stacklevel=2)
            _bump_generation(self.path)
            return
        except OSError as e:
            warnings.warn(f"could not delete tuning DB {self.path}: {e}",
                          stacklevel=2)
            return
        _bump_generation(self.path)

    def __len__(self) -> int:
        return len(self.load())

    def __repr__(self):
        return f"TuningDB({str(self.path)!r})"


# Default handle, memoized per *resolved* path — the same resolution
# autotune()'s default TuningDB() performs — so the two default-DB code
# paths can never diverge, and env changes (tests monkeypatching
# REPRO_TORCH_TUNING_DB / XDG_CACHE_HOME) take effect immediately.
_DEFAULT_DBS: dict[str, TuningDB] = {}


def get_default_db() -> TuningDB:
    path = str(default_db_path())
    db = _DEFAULT_DBS.get(path)
    if db is None:
        db = _DEFAULT_DBS[path] = TuningDB(path)
    return db


# ---------------------------------------------------------------------------
# Keys, stats, lookup
# ---------------------------------------------------------------------------

_STATS = {"searches": 0, "timing_executions": 0,
          "db_hits": 0, "db_misses": 0}


def autotune_stats() -> dict[str, int]:
    """Counters: measured searches run, timed executions performed, and
    plan-construction DB hits/misses (``backend="autotune"`` lookups)."""
    return dict(_STATS)


# The autotuner slice of the unified telemetry snapshot
# (core.telemetry.metrics_snapshot -> "autotune.*").
telemetry.register_stats_provider("autotune", autotune_stats)


def reset_autotune_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def fingerprint_digest(dev_key) -> str:
    """Short stable digest of a :func:`db_fingerprint` tuple — large
    fingerprints stay out of the JSON keys ("none" for device-agnostic
    dims-tuple plans, which therefore never hit records stored from real
    measurements)."""
    if dev_key is None:
        return "none"
    return hashlib.sha1(repr(dev_key).encode()).hexdigest()[:16]


def plan_db_key(dev_key, dims, axis_names, block_shape, dtype,
                variant: str) -> str:
    """Stable DB key: device-fingerprint digest + the plan identity."""
    fp = fingerprint_digest(dev_key)
    block = "x".join(str(int(s)) for s in block_shape)
    return (f"fp:{fp}|dims:{','.join(str(int(s)) for s in dims)}"
            f"|axes:{','.join(axis_names)}|block:{block}"
            f"|dtype:{dtype_name(dtype)}|variant:{variant}")


def ragged_db_key(dev_key, dims, axis_names, row_shape, dtype,
                  max_count: int, variant: str, density: float) -> str:
    """Stable DB key for the ragged-vs-sparse measured choice.

    Extends :func:`plan_db_key`'s identity with the ragged bucket bound
    and a coarse density bucket (one decade per bucket: 1.0, 0.1, 0.01,
    ...) — the dense<->sparse crossover moves with orders of magnitude
    of occupancy, not percents, and a finer key would fragment the DB.
    """
    fp = fingerprint_digest(dev_key)
    row = "x".join(str(int(s)) for s in row_shape) or "scalar"
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    decade = min(6, max(0, -int(math.floor(math.log10(density)))))
    return (f"ragged|fp:{fp}|dims:{','.join(str(int(s)) for s in dims)}"
            f"|axes:{','.join(axis_names)}|row:{row}"
            f"|dtype:{dtype_name(dtype)}|max:{int(max_count)}"
            f"|variant:{variant}|rho:1e-{decade}")


def _valid_record(rec) -> bool:
    if not isinstance(rec, dict):
        return False
    w = rec.get("winner")
    return (isinstance(w, dict)
            and w.get("backend") in MEASURED_BACKENDS
            and isinstance(w.get("n_chunks", 1), int))


def lookup_measured(dev_key, dims, axis_names, block_shape, dtype,
                    variant: str, db: TuningDB | None = None) -> dict | None:
    """The plan-construction side of the DB: a validated record or None.

    Counts a hit/miss in ``autotune_stats``; malformed records (a
    hand-edited DB, a newer writer) are treated as misses so
    ``plan_all_to_all`` can always fall back to the analytic model.
    """
    db = db if db is not None else get_default_db()
    rec = db.get(plan_db_key(dev_key, dims, axis_names, block_shape,
                             dtype, variant))
    if rec is not None and not _valid_record(rec):
        warnings.warn(f"ignoring malformed tuning record in {db.path}",
                      stacklevel=2)
        rec = None
    if rec is None:
        _STATS["db_misses"] += 1
    else:
        _STATS["db_hits"] += 1
    return rec


def _valid_ragged_record(rec) -> bool:
    if not isinstance(rec, dict):
        return False
    w = rec.get("winner")
    return (isinstance(w, dict)
            and w.get("backend") in RAGGED_MEASURED_BACKENDS)


def lookup_ragged_measured(dev_key, dims, axis_names, row_shape, dtype,
                           max_count: int, variant: str, density: float,
                           db: TuningDB | None = None) -> dict | None:
    """The consumption side of :func:`autotune_ragged`: a validated
    ragged-vs-sparse record or None.  Same hit/miss accounting and
    malformed-record tolerance as :func:`lookup_measured` — a miss means
    the caller falls back to the analytic density-aware policy
    (``tuning.choose_ragged_algorithm``), never a blocking measurement.
    """
    db = db if db is not None else get_default_db()
    rec = db.get(ragged_db_key(dev_key, dims, axis_names, row_shape, dtype,
                               max_count, variant, density))
    if rec is not None and not _valid_ragged_record(rec):
        warnings.warn(f"ignoring malformed ragged tuning record in "
                      f"{db.path}", stacklevel=2)
        rec = None
    if rec is None:
        _STATS["db_misses"] += 1
    else:
        _STATS["db_hits"] += 1
    return rec


def demote_hit_to_miss() -> None:
    """Reclassify the last counted hit as a miss: called by the plan
    layer when a looked-up record proves unusable at build time, so
    ``db_hits`` stays equal to the number of plans actually built from
    measurements (what the dryrun telemetry documents)."""
    _STATS["db_hits"] -= 1
    _STATS["db_misses"] += 1


def migrate_records(db: "TuningDB", old_dev_key, new_dev_key, dims,
                    axis_names) -> int:
    """Re-key measured winners from a dead device set onto its rebuilt
    survivor torus (the ``TorusComm.rebuild`` tuning-migration step).

    Only records whose plan identity is still valid on the new torus
    migrate: every axis the record was measured over must exist in the
    new comm's ``axis_names`` with the *same extent* (the typical case is
    a sub-axes plan — e.g. a single-axis exchange whose dimension length
    survived the re-factorization).  Migrated records keep their measured
    winner and links but gain ``"migrated": True`` — they are a
    warm-start heuristic, since the surviving physical links may differ;
    a later explicit :func:`autotune` overwrites them with fresh
    measurements.  Returns the number of records migrated.
    """
    old_fp, new_fp = fingerprint_digest(old_dev_key), \
        fingerprint_digest(new_dev_key)
    if old_fp == new_fp or old_fp == "none" or new_fp == "none":
        return 0
    new_extent = {a: int(Dk) for a, Dk in zip(axis_names, dims)}
    prefix = f"fp:{old_fp}|"
    migrated = 0
    for key, rec in db.load().items():
        if not key.startswith(prefix) or not _valid_record(rec):
            continue
        rec_axes = rec.get("axis_names") or ()
        rec_dims = rec.get("dims") or ()
        if not rec_axes or len(rec_axes) != len(rec_dims):
            continue
        if any(new_extent.get(a) != int(Dk)
               for a, Dk in zip(rec_axes, rec_dims)):
            continue
        if db.put(f"fp:{new_fp}|" + key[len(prefix):],
                  {**rec, "migrated": True}):
            migrated += 1
    return migrated


def measured_links(record: dict) -> tuple[LinkModel, ...] | None:
    """Per-axis LinkModels recorded by the search, if the fit succeeded."""
    raw = record.get("measured_links")
    if not raw:
        return None
    try:
        return tuple(LinkModel(alpha=float(l["alpha"]),
                               bandwidth=float(l["bandwidth"]))
                     for l in raw)
    except (KeyError, TypeError, ValueError):
        return None



def db_fingerprint(mesh: DeviceMesh) -> tuple:
    """The DB identity of a mesh: its rank fingerprint
    (``core.cache.device_fingerprint``) and the default process group's
    backend name, so a winner measured over gloo never replays over
    NCCL."""
    return (device_fingerprint(mesh), dist.get_backend())


# ---------------------------------------------------------------------------
# Measurement (SPMD: every rank of the world runs it)
# ---------------------------------------------------------------------------

def _sync(out) -> None:
    """Wait for the device work that produced ``out`` (a tensor or a tuple
    whose first entry is one); nothing to wait for on the CPU."""
    t = out[0] if isinstance(out, tuple) else out
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _agree_device() -> torch.device:
    """Where the ranks' small agreement tensors live: the card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _max_over_ranks(seconds: float) -> float:
    t = torch.tensor([seconds], dtype=torch.float64, device=_agree_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _rank0_says(flag: bool) -> bool:
    """Rank 0's ``flag``, broadcast: one decision for every rank."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_agree_device())
    dist.broadcast(t, src=0)
    return bool(t.item())


def _past(deadline: float) -> bool:
    """Whether the budget is spent, on rank 0's clock, for every rank."""
    return _rank0_says(time.perf_counter() > deadline)


def _timed(fn, x, *, warmup: int, repeats: int, **span_attrs) -> float:
    """The largest over the ranks of each rank's median wall seconds of
    ``fn(x)``; every execution (warmup included) is counted in the
    timing_executions stat.

    Each timed call starts after a barrier (a late rank is not charged
    to the candidate) and ends in a device synchronise.  Emits one
    ``autotune.measure`` span per candidate (attrs from ``span_attrs``
    plus the median).  The tracer is off around the executions, so a
    search under tracing times the untraced path and never feeds the
    drift detector it calibrates."""
    tr = telemetry.get_tracer()
    with tr.span("autotune.measure", cat="autotune", warmup=warmup,
                 repeats=repeats, **span_attrs) as sp:
        was_enabled = tr.enabled
        tr.enabled = False
        try:
            for _ in range(max(0, warmup)):
                _sync(fn(x))
                _STATS["timing_executions"] += 1
            ts = []
            for _ in range(max(1, repeats)):
                dist.barrier()
                t0 = time.perf_counter()
                _sync(fn(x))
                ts.append(time.perf_counter() - t0)
                _STATS["timing_executions"] += 1
        finally:
            tr.enabled = was_enabled
        med = _max_over_ranks(statistics.median(ts))
        sp.set(median_us=med * 1e6)
    return med


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _operand(p: int, block_shape, dtype, rank: int, device):
    """Torus rank ``rank``'s ``(p, *block)`` slice of the reference's
    deterministic global ``(p, p, *block)`` operand (``arange % 251``), so
    both packages time the same data."""
    n = p * math.prod(block_shape)
    flat = torch.arange(rank * n, (rank + 1) * n, device=device) % 251
    return flat.reshape((p,) + tuple(block_shape)).to(torch_dtype(dtype))


def _fit_axis_links(mesh, axis_names, dims, dtype, *, warmup, repeats,
                    deadline) -> list[dict] | None:
    """Two-point alpha-beta fit per active axis from measured single-axis
    all-to-alls: t(b) = (D_k - 1) * (alpha_k + b / bw_k) at two payload
    sizes solves for (alpha_k, bw_k).  Returns JSON-ready dicts —
    trivial (size-1) axes, which no prediction ever prices, get a fixed
    placeholder marked ``fit: False`` to keep the list positional with
    the axes — or None when the fit is infeasible (noise-swamped
    timings, budget exhausted).  Both are decided on what every rank
    sees alike: the reduced times and rank 0's clock.
    """
    from .plan import plan_all_to_all

    e_small, e_big = 16, 4096
    isz = itemsize(dtype)
    out = []
    for ax, Dk in zip(axis_names, dims):
        if Dk <= 1:
            out.append({"alpha": 1e-6, "bandwidth": 1e9, "fit": False})
            continue
        if _past(deadline):
            return None
        ts = []
        for nelem in (e_small, e_big):
            plan = plan_all_to_all(mesh, (ax,), (nelem,), dtype,
                                   backend="factorized")
            x = _operand(Dk, (nelem,), dtype, plan.fact.rank, _device(mesh))
            ts.append(_timed(plan.forward, x, warmup=warmup,
                             repeats=repeats))
        b1, b2 = e_small * isz, e_big * isz
        t1, t2 = ts
        if t2 <= t1:          # noise swamped the size difference
            return None
        bw = (Dk - 1) * (b2 - b1) / (t2 - t1)
        alpha = t1 / (Dk - 1) - b1 / bw
        out.append({"alpha": max(alpha, 1e-9),
                    "bandwidth": max(bw, 1e3), "fit": True})
    return out


def _subgroup_ranks(mesh: DeviceMesh, axes) -> list[int]:
    """Global ranks of this rank's communication subgroup: the tuned axes
    swept, every other mesh axis pinned at this rank's index, in
    torus-rank order (the first axis the fastest digit: the order
    ``cart_create`` takes)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    sub = mesh.mesh[tuple(slice(None) if n in axes else c
                          for n, c in zip(names, coord))]
    sel = [n for n in names if n in axes]
    sub = sub.permute([sel.index(a) for a in reversed(axes)])
    return [int(r) for r in sub.flatten().tolist()]


def _round_orders(d_active: int, round_orders):
    if round_orders is not None:
        return [tuple(o) for o in round_orders]
    if d_active <= 1:
        return [tuple(range(d_active))]
    if d_active <= 3:
        import itertools
        return list(itertools.permutations(range(d_active)))
    ident = tuple(range(d_active))
    return [ident, tuple(reversed(ident))]


def _chunk_candidates(dims, links, block_bytes, max_chunks: int):
    cands = {n for n in (2, 4, 8, 16) if n <= max_chunks}
    model_n = choose_chunks(dims, links, block_bytes,
                            max_chunks=max(1, max_chunks))
    if model_n > 1:
        cands.add(model_n)
    return sorted(cands)


def _publish(db: TuningDB, key: str, record: dict) -> None:
    """Rank 0 writes the record (under the DB's lock); the broadcast of
    whether it landed orders every other rank's reads after the write.
    Every other rank then bumps its own per-process generation, so its
    plan registry re-resolves ``backend="autotune"`` instead of serving
    the model-built plan it cached before the search.  A record that did
    not land stays in every rank's in-memory overlay, so the ranks still
    agree."""
    rank = dist.get_rank()
    landed = _rank0_says(db.put(key, record) if rank == 0 else False)
    if not landed:
        db._overlay[key] = record
    if rank != 0 or not landed:
        _bump_generation(db.path)


def autotune(mesh: DeviceMesh, axis_names, block_shape, dtype, **kwargs):
    """Measure candidate configurations, persist the winner, return its plan.

    Collective: every rank of the world calls it with the same arguments
    (the mesh spans the world), and every rank returns the same plan —
    exactly what any later ``plan_all_to_all(mesh, axes, block_shape,
    dtype, backend="autotune")`` builds from the DB (``describe()
    ["tuned_from"] == "measured"``).

    ``budget_seconds`` bounds the whole search: once exceeded, remaining
    candidates are recorded as skipped (never silently dropped) — the
    direct and factorized baselines are always measured.

    The whole sweep runs under one ``autotune.search`` telemetry span
    (child ``autotune.measure`` spans per candidate).
    """
    axes = _as_tuple(axis_names)
    shape = mesh_shape(mesh)
    with telemetry.get_tracer().span(
            "autotune.search", cat="autotune", kind="dense",
            axes=",".join(axes),
            dims="x".join(str(int(shape[a])) for a in axes)):
        return _autotune_impl(mesh, axes, block_shape, dtype, **kwargs)


def _autotune_impl(mesh: DeviceMesh, axis_names, block_shape, dtype, *,
                   variant: str = "natural", max_chunks: int = 8,
                   round_orders=None, include_factorizations: bool = True,
                   warmup: int = 2, repeats: int = 5,
                   budget_seconds: float = 20.0, fit_links: bool = True,
                   db: TuningDB | None = None, verbose: bool = False):
    from .plan import plan_all_to_all
    from .tuning import default_links

    axes = _as_tuple(axis_names)
    shape = mesh_shape(mesh)
    dims = tuple(int(shape[a]) for a in axes)
    p = math.prod(dims)
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"autotune runs on every rank of the world: the "
                         f"mesh has {mesh.mesh.numel()} ranks, the world "
                         f"{dist.get_world_size()}")
    dev_key = db_fingerprint(mesh)
    db = db if db is not None else TuningDB()
    deadline = time.perf_counter() + budget_seconds
    _STATS["searches"] += 1

    block_shape = tuple(int(s) for s in block_shape)
    block_bytes = math.prod(block_shape) * itemsize(dtype)
    device = _device(mesh)
    rank = get_factorization(mesh, axes, variant=variant).rank
    x = _operand(p, block_shape, dtype, rank, device)

    # Alternative factorizations run on auxiliary Cartesian meshes over
    # the ranks of one subgroup.  The reference measures one
    # representative subgroup; here every rank runs the search, so every
    # subgroup builds its own auxiliary mesh over its own members (a
    # mesh over a strict subset of the world is built by its members
    # alone, ``core.cache``) and times the same candidates beside the
    # others, and ``_timed`` keeps the slowest rank's median.
    alt = [tuple(reversed(f)) for f in
           candidate_factorizations(p, max_d=min(4, max_dims(p)))]
    alt = [f for f in alt if f != dims and len(f) > 1] \
        if include_factorizations and p > 1 else []
    group_ranks = _subgroup_ranks(mesh, axes)

    links_fitted = None
    if fit_links:
        links_fitted = _fit_axis_links(mesh, axes, dims, dtype,
                                       warmup=warmup, repeats=repeats,
                                       deadline=deadline)
    model_links = tuple(LinkModel(l["alpha"], l["bandwidth"])
                        for l in links_fitted) if links_fitted \
        else default_links(axes)

    # ---- candidate list on the caller's axes (winner-eligible) ----
    d_active = len([D for D in dims if D > 1])
    ident = tuple(range(d_active))
    cands = [("direct", ident, 1)]
    for order in _round_orders(d_active, round_orders):
        cands.append(("factorized", order, 1))
    if d_active >= 1:
        for n in _chunk_candidates(dims, model_links, float(block_bytes),
                                   max_chunks):
            cands.append(("overlap", ident, n))

    table, skipped = [], []
    for i, (backend, order, n) in enumerate(cands):
        if i >= 2 and _past(deadline):
            skipped.append({"backend": backend, "round_order": list(order),
                            "n_chunks": n})
            continue
        plan = plan_all_to_all(mesh, axes, block_shape, dtype,
                               backend=backend, variant=variant,
                               round_order=order, n_chunks=n)
        med = _timed(plan.forward, x, warmup=warmup, repeats=repeats,
                     backend=backend, n_chunks=n,
                     round_order=",".join(str(o) for o in order))
        table.append({"backend": backend, "dims": list(dims),
                      "round_order": list(order), "n_chunks": n,
                      "median_us": med * 1e6, "eligible": True})
        if verbose:
            print(f"[autotune] {backend} order={order} n={n}: "
                  f"{med * 1e6:.1f}us")

    # ---- alternative factorizations of p (informational rows: they need
    # a different Cartesian mesh, so they can't be applied behind the
    # caller's axes — recorded to steer mesh construction) ----
    for dims_ff in alt:
        if _past(deadline):
            skipped.append({"backend": "factorized",
                            "dims": list(dims_ff), "n_chunks": 1})
            continue
        aux_names = tuple(f"at{i}" for i in range(len(dims_ff)))
        aux_mesh = cart_create(group_ranks, dims_ff, aux_names,
                               device_type=mesh.device_type)
        plan = plan_all_to_all(aux_mesh, aux_names, block_shape, dtype,
                               backend="factorized", variant=variant)
        x_aux = _operand(p, block_shape, dtype, plan.fact.rank, device)
        med = _timed(plan.forward, x_aux, warmup=warmup, repeats=repeats,
                     backend="factorized",
                     dims="x".join(str(s) for s in dims_ff))
        table.append({"backend": "factorized", "dims": list(dims_ff),
                      "round_order": list(range(len(dims_ff))),
                      "n_chunks": 1, "median_us": med * 1e6,
                      "eligible": False})
        if verbose:
            print(f"[autotune] factorized dims={dims_ff}: "
                  f"{med * 1e6:.1f}us")
    if skipped and verbose:
        print(f"[autotune] budget exhausted; skipped {len(skipped)} "
              f"candidates: {skipped}")

    eligible = [r for r in table if r["eligible"]]
    win = min(eligible, key=lambda r: r["median_us"])
    best_row = min(table, key=lambda r: r["median_us"])
    record = {
        "version": DB_VERSION,
        "winner": {"backend": win["backend"],
                   "round_order": win["round_order"],
                   "n_chunks": int(win["n_chunks"]),
                   "median_us": win["median_us"]},
        "p": p, "dims": list(dims), "axis_names": list(axes),
        "block_shape": list(block_shape),
        "dtype": dtype_name(dtype), "variant": variant,
        "best_factorization": {"dims": best_row["dims"],
                               "backend": best_row["backend"],
                               "median_us": best_row["median_us"]},
        "measured_links": links_fitted,
        "table": table, "skipped": skipped,
        "warmup": warmup, "repeats": repeats,
        "created": time.time(),
    }
    _publish(db, plan_db_key(dev_key, dims, axes, block_shape, dtype,
                             variant), record)
    # Reconstruct through the DB path so the returned plan is the exact
    # object later backend="autotune" callers fetch (tuned_from="measured").
    return plan_all_to_all(mesh, axes, block_shape, dtype,
                           backend="autotune", variant=variant, db=db)


def _sparse_counts_operand(p: int, max_count: int, density: float,
                           seed: int = 0):
    """Deterministic global (p, p) int32 count matrix at roughly the
    requested non-zero density (at least one non-zero pair, so the
    operand always exercises the data rounds) — the reference's draw."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = (rng.random((p, p)) < density) \
        * rng.integers(1, max_count + 1, (p, p))
    counts = counts.astype(np.int32)
    if not counts.any():
        counts[0, p - 1] = max_count
    return torch.from_numpy(counts)


def autotune_ragged(mesh: DeviceMesh, axis_names, row_shape, dtype, *,
                    max_count: int, density: float, **kwargs):
    """Measure dense-bucketed ragged vs sparse-neighborhood Alltoallv on
    a representative sparse operand and persist the winner.

    Collective, like :func:`autotune`.  Both candidates run ``forward``
    on the same deterministic ``(p, bucket, *row)`` payload per rank and
    a count matrix drawn at the requested ``density`` — so the sparse
    backend's skip predicates see realistic emptiness, and it is
    recorded as the winner **only when it wins on measured time**.
    Returns the winning plan; the record is consumed by
    :func:`lookup_ragged_measured` (the dropless-MoE plan chooser under
    ``a2a_backend="autotune"``).  The sweep runs under one
    ``autotune.search`` telemetry span like the dense search.
    """
    axes = _as_tuple(axis_names)
    shape = mesh_shape(mesh)
    with telemetry.get_tracer().span(
            "autotune.search", cat="autotune", kind="ragged",
            axes=",".join(axes), density=float(density),
            dims="x".join(str(int(shape[a])) for a in axes)):
        return _autotune_ragged_impl(mesh, axes, row_shape, dtype,
                                     max_count=max_count, density=density,
                                     **kwargs)


def _autotune_ragged_impl(mesh: DeviceMesh, axis_names, row_shape, dtype, *,
                          max_count: int, density: float,
                          avg_count: float | None = None,
                          variant: str = "natural", warmup: int = 2,
                          repeats: int = 5, seed: int = 0,
                          db: TuningDB | None = None,
                          verbose: bool = False):
    from .comm import torus_comm
    from .ragged import next_pow2

    axes = _as_tuple(axis_names)
    shape = mesh_shape(mesh)
    dims = tuple(int(shape[a]) for a in axes)
    p = math.prod(dims)
    dev_key = db_fingerprint(mesh)
    db = db if db is not None else TuningDB()
    _STATS["searches"] += 1

    row_shape = tuple(int(s) for s in row_shape)
    max_count = int(max_count)
    bucket = next_pow2(max_count)

    comm = torus_comm(mesh, axes, variant=variant, db=db)
    ragged_plan = comm.ragged_all_to_all(row_shape, dtype,
                                         max_count=max_count,
                                         avg_count=avg_count)
    sparse_plan = comm.sparse_all_to_all(row_shape, dtype,
                                         max_count=max_count,
                                         avg_count=avg_count,
                                         density=density)
    rank = comm.rank
    device = _device(mesh)
    counts = _sparse_counts_operand(p, max_count, density, seed)[rank]
    counts = counts.to(device)
    x = _operand(p, (bucket,) + row_shape, dtype, rank, device)
    table = []
    for backend, plan in (("ragged", ragged_plan), ("sparse", sparse_plan)):
        med = _timed(lambda _, run=plan.forward: run(x, counts), None,
                     warmup=warmup, repeats=repeats, backend=backend)
        table.append({"backend": backend, "median_us": med * 1e6})
        if verbose:
            print(f"[autotune_ragged] {backend}: {med * 1e6:.1f}us")

    win = min(table, key=lambda r: r["median_us"])
    record = {
        "version": DB_VERSION,
        "winner": {"backend": win["backend"],
                   "median_us": win["median_us"]},
        "p": p, "dims": list(dims), "axis_names": list(axes),
        "row_shape": list(row_shape), "dtype": dtype_name(dtype),
        "max_count": max_count, "bucket": bucket, "variant": variant,
        "density": float(density), "table": table,
        "warmup": warmup, "repeats": repeats, "seed": seed,
        "created": time.time(),
    }
    _publish(db, ragged_db_key(dev_key, dims, axes, row_shape, dtype,
                               max_count, variant, density), record)
    return sparse_plan if win["backend"] == "sparse" else ragged_plan
