"""Common layers: norms and the (gated) MLP.

Port of ``src/repro/models/layers.py`` (without the sharding hints: one
device).  Functions take plain tensors, or a dict of them (``params``),
as the reference's take its param dicts.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

__all__ = [
    "rms_norm",
    "layer_norm",
    "mlp_defs",
    "mlp_apply",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_defs(d_model: int, d_ff: int, *, gated: bool = True) -> Dict[str, ParamDef]:
    defs = {
        "wi": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "wo": ParamDef((d_ff, d_model), ("ffn", "embed")),
    }
    if gated:
        defs["wg"] = ParamDef((d_model, d_ff), ("embed", "ffn"))
    return defs


def mlp_apply(params, x, *, act: str = "silu"):
    h = x @ params["wi"]
    if "wg" in params:
        h = _act(act)(x @ params["wg"]) * h
    else:
        h = _act(act)(h)
    return h @ params["wo"]
