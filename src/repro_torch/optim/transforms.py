"""Gradient transforms (port of ``repro.optim.transforms``): the global
norm and clipping by it.  The int8-compressed all-reduce and the expert
replica tying wait for the data-parallel and EP training slices
(ROADMAP.md)."""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    sq = [torch.sum(torch.square(x.float())) for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float, gnorm=None):
    """Each leaf times ``min(1, max_norm / (gnorm + 1e-12))``, computed in
    f32 and cast back to the leaf's dtype."""
    gnorm = global_norm(tree) if gnorm is None else gnorm
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)
