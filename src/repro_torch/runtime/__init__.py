"""Runtime of the port: colocated continuous batching, the trainer (with
its elastic loop) and the straggler watchdog."""

from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
