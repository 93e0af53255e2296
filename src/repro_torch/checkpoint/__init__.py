"""Crash-safe named snapshots (``Index.save`` / ``Index.restore``); port
of ``src/repro/checkpoint/``.  Training checkpoints wait for ROADMAP
queue A item 13."""
from repro_torch.checkpoint.checkpoint import load_snapshot, save_snapshot

__all__ = ["load_snapshot", "save_snapshot"]
