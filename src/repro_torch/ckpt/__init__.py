"""Checkpoint and restore (counterpart of ``repro.ckpt``): same on-disk
format, so a checkpoint written by either package loads in the other."""
from .checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
    available_steps,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "CorruptCheckpointError",
    "available_steps",
    "save_checkpoint",
    "restore_checkpoint",
]
