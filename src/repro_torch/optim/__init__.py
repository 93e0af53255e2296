"""Optimizers of the port (``src/repro/optim``): AdamW and its learning
rate schedules."""
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    linear_warmup,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup"]
