"""Deterministic synthetic data of the port (port of ``repro.data``)."""

from .pipeline import (CopyTaskConfig, DataConfig, SyntheticLM,
                       make_copy_task_batch, make_lm_batch)

__all__ = ["CopyTaskConfig", "DataConfig", "SyntheticLM",
           "make_copy_task_batch", "make_lm_batch"]
