"""Checkpoints of the port (``src/repro/checkpoint/``): training
checkpoints in the reference's format (``save_checkpoint``,
``restore_checkpoint``, ``latest_step``, ``AsyncCheckpointer``) and
crash-safe named snapshots (``Index.save`` / ``Index.restore``)."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    load_snapshot,
    restore_checkpoint,
    save_checkpoint,
    save_snapshot,
)

__all__ = ["AsyncCheckpointer", "latest_step", "load_snapshot",
           "restore_checkpoint", "save_checkpoint", "save_snapshot"]
