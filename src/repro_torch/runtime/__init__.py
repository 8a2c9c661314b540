"""Runtime of the port: colocated continuous batching, the non-elastic
trainer and the straggler watchdog."""

from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
