"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

Batches are a pure function of ``(seed, step)``, so a restart needs only
the step cursor, which checkpoints carry.  The tasks are the reference's:

* ``make_lm_batch`` — Zipf-ish tokens ``floor((1/u)^0.9) - 1 mod V``,
  labels the next token;
* ``make_copy_task_batch`` — prefix | SEP = V-1 | prefix | zeros, with
  only the copy region scored (a learnable task).

The reference draws from ``jax.random``, which the port cannot reproduce,
so the port draws the same distributions from a numpy ``Generator``
seeded by ``(seed, step)``: the two packages' batches differ, and parity
tests feed one numpy batch to both.

On a ``DeviceMesh`` :class:`SyntheticLM` yields this rank's row block of
the global batch, the block the reference's ``P(("pod", "data"))``
placement gives the device at the same mesh coordinates
(``parallel.sharding.batch_split``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.parallel.sharding import batch_split


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


@dataclass(frozen=True)
class CopyTaskConfig(DataConfig):
    prefix_len: int = 0   # default seq_len // 2

    @property
    def plen(self):
        return self.prefix_len or (self.seq_len // 2)


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng([cfg.seed, step])


def _tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_lm_batch(cfg: DataConfig, step: int, device="cpu"):
    """Zipf-distributed tokens; labels = next token.  Int32 ``tokens`` and
    ``labels`` (B, S), f32 ``mask`` of ones, on ``device``."""
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    u = _rng(cfg, step).uniform(1e-6, 1.0, (B, S + 1)).astype(np.float32)
    # inverse-CDF power law (Zipf-ish) truncated to the vocab
    ranks = np.floor((1.0 / u) ** 0.9)
    toks = ((ranks.astype(np.int64) - 1) % V).astype(np.int32)
    return _tensors({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                     "mask": np.ones((B, S), np.float32)}, device)


def make_copy_task_batch(cfg: CopyTaskConfig, step: int, device="cpu"):
    """prefix | SEP | prefix | zeros, labels = next token, ``mask`` 1 on
    the copy region [plen, 2 plen) only; on ``device``."""
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    plen = cfg.plen
    if 2 * plen + 1 > S + 1:
        raise ValueError(f"prefix of {plen} too long for seq_len {S}")
    prefix = _rng(cfg, step).integers(0, V - 1, (B, plen), dtype=np.int32)
    seq = np.concatenate(
        [prefix, np.full((B, 1), V - 1, np.int32), prefix,
         np.zeros((B, S + 1 - 2 * plen - 1), np.int32)], axis=1)
    pos = np.arange(S)[None]
    mask = np.broadcast_to((pos >= plen) & (pos < 2 * plen), (B, S))
    return _tensors({"tokens": seq[:, :-1], "labels": seq[:, 1:],
                     "mask": mask.astype(np.float32)}, device)


class SyntheticLM:
    """Stateful iterator with a resumable cursor; batches land on
    ``device`` (``cuda`` unless the caller asks for the CPU).  With a
    ``mesh`` each batch is this rank's row block of the global one (the
    "batch" rule of ``rules`` over the mesh)."""

    def __init__(self, cfg: DataConfig, mesh=None, task: str = "lm",
                 start_step: int = 0, device="cuda", rules=None):
        if task not in ("lm", "copy"):
            raise ValueError(f"task must be 'lm' or 'copy', not {task!r}")
        self.cfg = cfg
        self.task = task
        self.step = start_step
        self.device = resolve_device(device)
        n, self._block = batch_split(mesh, rules)
        if cfg.global_batch % n:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n} row blocks")
        self._rows = cfg.global_batch // n

    def next(self):
        fn = make_copy_task_batch if self.task == "copy" else make_lm_batch
        batch = fn(self.cfg, self.step, "cpu")
        self.step += 1
        lo = self._block * self._rows
        return {k: v[lo:lo + self._rows].to(self.device)
                for k, v in batch.items()}

    # ---- checkpointable cursor ----
    def state_dict(self):
        return {"step": self.step, "seed": self.cfg.seed,
                "task": self.task}

    def load_state_dict(self, d):
        if d["seed"] != self.cfg.seed or d["task"] != self.task:
            raise ValueError(f"resuming with a different data stream: "
                             f"checkpoint {d}, this stream seed "
                             f"{self.cfg.seed} task {self.task!r}")
        self.step = int(d["step"])
