"""The LM lane's training side on one device (the port of ``repro.train``):
the AdamW optimizer, the train step, the deterministic data pipeline and
atomic checkpoints (also what the coloring service checkpoints its streams
through)."""
from .optimizer import (AdamWConfig, init_opt_state, abstract_opt_state,
                        adamw_update)
from .train_step import make_train_step, TrainStepConfig
from . import checkpoint, data

__all__ = [
    "AdamWConfig", "init_opt_state", "abstract_opt_state", "adamw_update",
    "make_train_step", "TrainStepConfig", "checkpoint", "data",
]
