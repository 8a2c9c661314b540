"""Optimizer, schedules and gradient transforms of the port (port of
``repro.optim``; ``compress_dequantize``, ``compressed_psum`` and
``tie_expert_replica_grads`` are not ported yet, ROADMAP.md)."""

from .adamw import AdamW, AdamWConfig
from .schedules import constant, cosine_with_warmup, linear_warmup
from .transforms import clip_by_global_norm, global_norm

__all__ = ["AdamW", "AdamWConfig", "clip_by_global_norm", "constant",
           "cosine_with_warmup", "global_norm", "linear_warmup"]
