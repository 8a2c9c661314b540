"""Optimizer, schedules and gradient transforms of the port (port of
``repro.optim``)."""

from .adamw import AdamW, AdamWConfig
from .schedules import constant, cosine_with_warmup, linear_warmup
from .transforms import (clip_by_global_norm, compress_dequantize,
                         compressed_psum, global_norm,
                         tie_expert_replica_grads)

__all__ = ["AdamW", "AdamWConfig", "clip_by_global_norm",
           "compress_dequantize", "compressed_psum", "constant",
           "cosine_with_warmup", "global_norm", "linear_warmup",
           "tie_expert_replica_grads"]
