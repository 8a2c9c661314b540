"""Checkpointing of the port: atomic, verified, async (port of
``repro.checkpoint``)."""

from .store import (CheckpointManager, all_steps, latest_step,
                    restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "all_steps", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
