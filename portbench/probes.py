"""Counting wrappers that a traced run installs around functions of the
program, so the work counts come from the inputs of the window itself.
Each is a context manager that puts the original back on exit; no file
of the program changes.

* :class:`RouterProbe` — the rows the router keeps in each MoE call
  (``models.moe._moe_inner``);
* :class:`ReorderProbe` — the bytes each launched reorder pass reads and
  writes (``kernels.ops.pack_round`` / ``unpack_round`` /
  ``repack_round``, counted by the kernels' own launch counters, so a
  skipped identity pass counts nothing).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .reference.model import capacity


class RouterProbe(contextlib.AbstractContextManager):
    """``calls``: ``(tokens, kept rows)`` of each MoE call."""

    def __init__(self, model: dict):
        self.model = model
        self.calls: list = []
        self._pending: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._mod, self._orig = moe, moe._moe_inner
        orig, m = self._orig, self.model

        @functools.wraps(orig)
        def wrapped(x, router_w, *a, **kw):
            with torch.no_grad():
                xt = x.detach().reshape(-1, x.shape[-1]).float()
                probs = torch.softmax(xt @ router_w.detach().float(), -1)
                ei = torch.topk(probs, m["top_k"], -1).indices.reshape(-1)
                onehot = torch.nn.functional.one_hot(ei, m["n_experts"])
                pos = (torch.cumsum(onehot, 0) - 1).gather(
                    1, ei[:, None])[:, 0]
                self._pending.append(
                    (xt.shape[0], (pos < capacity(m, xt.shape[0])).sum()))
            return orig(x, router_w, *a, **kw)

        moe._moe_inner = wrapped
        return self

    def __exit__(self, *exc):
        self._mod._moe_inner = self._orig
        self.calls += [(n, int(k)) for n, k in self._pending]
        self._pending = []
        return False

    @property
    def kept(self) -> int:
        return sum(k for _, k in self.calls)


class ReorderProbe(contextlib.AbstractContextManager):
    """``bytes``: input plus output bytes of every launched reorder
    pass; ``launches``: their count."""

    NAMES = ("pack_round", "unpack_round", "repack_round")

    def __init__(self):
        self.bytes = 0
        self.launches = 0

    def _launched(self) -> int:
        from repro_torch.kernels import block_reorder as br
        return sum(getattr(f, "launches", 0) for f in
                   (br.datatype_pack, br.datatype_unpack, br.datatype_repack))

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = {n: getattr(ops, n) for n in self.NAMES}
        for n, orig in self._orig.items():
            setattr(ops, n, self._wrap(orig))
        return self

    def _wrap(self, orig):
        @functools.wraps(orig)
        def wrapped(x, *a, **kw):
            before = self._launched()
            out = orig(x, *a, **kw)
            n = self._launched() - before
            self.launches += n
            self.bytes += n * 2 * x.numel() * x.element_size()
            return out
        return wrapped

    def __exit__(self, *exc):
        for n, orig in self._orig.items():
            setattr(self._ops, n, orig)
        return False
