"""AdamW optimizer + LR schedules.

Port of ``src/repro/optim/adamw.py``.  The state is two dicts of f32
tensors (``m``, ``v``) keyed as the parameters are (a model's
``named_parameters()`` names).  :func:`adamw_update` computes each update
in f32 and casts it back to the parameter's dtype, as the reference's
``upd``, but writes the parameters and the state in place (one tensor at
a time, so its temporaries are one tensor's, not the model's).  The
schedules return the step's learning rate as a float, computed in f32
as the reference's ``jnp`` schedules compute it.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule", "linear_warmup"]


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    return AdamWState(m=zeros(), v=zeros())


def _f32(x) -> np.float32:
    return np.float32(x)


@torch.no_grad()
def adamw_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamWState,
    *,
    step,
    learning_rate=3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step, in place; returns ``(params, state)``.

    ``step`` is the 0-based step (an int or a one-element tensor);
    ``learning_rate`` may be a float or callable(step).  Per parameter,
    in f32: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g²``,
    ``p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)`` with the bias
    corrections ``c = 1 - b**(step + 1)``."""
    step = int(step)
    lr = learning_rate(step) if callable(learning_rate) else learning_rate
    lr = float(_f32(lr))
    t = _f32(step + 1)
    c1 = float(_f32(1.0) - _f32(b1) ** t)
    c2 = float(_f32(1.0) - _f32(b2) ** t)
    for name, p in params.items():
        g = grads[name].to(torch.float32)
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (m / c1).div_((v / c2).sqrt_().add_(eps))
        p32 = p.to(torch.float32)
        update.add_(p32, alpha=weight_decay)
        if p.dtype == torch.float32:
            p.sub_(update, alpha=lr)
        else:
            p.copy_((p32 - lr * update).to(p.dtype))
    return params, state


def linear_warmup(base_lr: float, warmup_steps: int):
    def sched(step):
        return float(_f32(base_lr) * min(_f32(1.0),
                                         _f32(int(step) + 1) / _f32(warmup_steps)))

    return sched


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def sched(step):
        step = int(step)
        warm = min(_f32(1.0), _f32(step + 1) / _f32(warmup_steps))
        frac = np.clip(_f32(step - warmup_steps)
                       / _f32(max(1, total_steps - warmup_steps)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(min_ratio) + _f32(1 - min_ratio) * _f32(0.5) * (
            _f32(1.0) + np.cos(_f32(math.pi) * frac))
        return float(_f32(base_lr) * warm * cos)

    return sched
