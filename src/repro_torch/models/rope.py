"""Rotary position embeddings: standard RoPE, partial-rotary, and M-RoPE.

Port of ``src/repro/models/rope.py``.  M-RoPE (qwen2-vl): head_dim
channels are split into (temporal, height, width) sections, each rotated
by its own position stream.  For text tokens all three streams coincide,
recovering standard RoPE.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rope_freqs", "apply_rope", "apply_mrope", "default_mrope_positions"]


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for a (possibly partial) rotary dim."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(
    x: torch.Tensor,               # (..., seq, heads, head_dim)
    positions: torch.Tensor,       # (..., seq)
    *,
    theta: float = 10000.0,
    rotary_dim: Optional[int] = None,
) -> torch.Tensor:
    head_dim = x.shape[-1]
    rd = rotary_dim or head_dim
    freqs = rope_freqs(rd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, rd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    rot, rest = x[..., :rd], x[..., rd:]
    rot = _rotate(rot.to(torch.float32), cos, sin).to(x.dtype)
    return torch.cat([rot, rest], dim=-1) if rd < head_dim else rot


def default_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions: all three streams equal (..., seq) -> (3, ..., seq)."""
    return torch.stack([positions, positions, positions], dim=0)


def apply_mrope(
    x: torch.Tensor,               # (..., seq, heads, head_dim)
    positions3: torch.Tensor,      # (3, ..., seq): (t, h, w) streams
    *,
    theta: float = 10000.0,
    sections: Tuple[int, int, int] = (2, 1, 1),  # fractions of rd/2 (t,h,w) in 4ths
) -> torch.Tensor:
    head_dim = x.shape[-1]
    half = head_dim // 2
    s_t = half * sections[0] // 4
    s_h = half * sections[1] // 4
    freqs = rope_freqs(head_dim, theta, device=x.device)  # (half,)
    # Select which position stream drives each frequency channel.
    ch = torch.arange(half, device=x.device)
    stream = torch.where(ch < s_t, 0, torch.where(ch < s_t + s_h, 1, 2))
    pos = positions3[stream]                     # (half, ..., seq)
    pos = torch.movedim(pos, 0, -1)              # (..., seq, half)
    angles = pos.to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)
