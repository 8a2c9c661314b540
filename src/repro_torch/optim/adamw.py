"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The moments are f32 (``moment_dtype``), leaves with ``ndim < 2`` (norms,
biases) get no weight decay, and the update is computed in the moments'
dtype and cast back to the parameter's.  Unlike the reference, which
returns new arrays, :meth:`AdamW.update` works leaf by leaf and in place
(``mul_``, ``add_``, ``addcmul_`` on the moments, ``copy_`` into the
parameter): at phi3.5-moe width one stacked expert weight is 3.4 GB in
f32, so the f32 temporaries of the whole tree at once would not fit
beside the state.  It returns the same ``params`` and ``state`` objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import DTYPES

from .transforms import global_norm


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: str = "float32"

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)


@dataclass(frozen=True)
class AdamW:
    config: AdamWConfig = field(default_factory=AdamWConfig)

    def init(self, params):
        """Zero moments shaped like ``params`` and ``step`` 0 (an int32
        0-d tensor on the parameters' device)."""
        mdt = DTYPES[self.config.moment_dtype]
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        device = tree_leaves(params)[0][1].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, params, grads, state, sharding=None):
        """One step: returns ``(params, state, gnorm)`` with ``gnorm`` the
        pre-clip global norm of ``grads``; ``params`` and ``state`` are
        updated in place.  On a mesh ``sharding`` (the parameters'
        ``ExpertSharding``) makes ``gnorm`` the global tree's, the same
        on every rank, so clipping scales every rank alike."""
        cfg = self.config
        state["step"] += 1
        step = int(state["step"])
        gnorm = global_norm(grads, sharding)
        scale = None
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
        lr = cfg.lr_at(step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        mu_by = dict(tree_leaves(state["mu"]))
        nu_by = dict(tree_leaves(state["nu"]))
        g_by = dict(tree_leaves(grads))
        for path, p in tree_leaves(params):
            mu, nu, g = mu_by[path], nu_by[path], g_by[path]
            if scale is not None:     # clip_by_global_norm: in the grad's
                g = (g.float() * scale).to(g.dtype)       # dtype, as there
            g32 = g.to(mu.dtype)
            mu.mul_(b1).add_(g32, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            del g, g32
            delta = nu / bc2
            delta.sqrt_().add_(cfg.eps)
            delta = torch.div(mu, bc1).div_(delta)
            p32 = p.to(mu.dtype)
            if cfg.weight_decay and p.dim() >= 2:   # no decay on norms/bias
                delta.add_(p32, alpha=cfg.weight_decay)
            p.copy_(p32.sub_(delta, alpha=lr))
        return params, state, gnorm
