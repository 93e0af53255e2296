"""Parameter definitions: one source of truth for shape + logical axes.

Port of ``src/repro/models/params.py``.  A module describes its
parameters as ``{name: ParamDef(shape, axes, init)}``; :class:`ParamTree`
holds them as an ``nn.Module`` whose parameter names are the reference's
param dict keys (``attn.wq``, ``mlp.wi``, ...), :func:`init_params`
fills them with the port's own random values, and :func:`param_axes`
returns the logical-axes tree (kept as data: one device, no sharding
yet).  :func:`from_reference` turns the reference's param pytree into
the port's state dict, the way parity tests carry weights across, and
:func:`to_reference` is its inverse: a port state dict restacked into
the reference's runs, the layout its training checkpoints hold.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["ParamDef", "ParamTree", "init_params", "param_axes", "from_reference",
           "to_reference"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    # None -> fan-in scaled normal; float -> explicit stddev; "zeros"/"ones".
    init: object = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")


def _stddev(shape: Tuple[int, ...]) -> float:
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    return 1.0 / math.sqrt(max(fan_in, 1))


class ParamTree(nn.Module):
    """A (nested) dict of ``ParamDef`` as parameters and submodules,
    allocated uninitialized on ``device`` in ``dtype``.  ``tree()`` is
    the plain nested dict of tensors the forward functions read."""

    def __init__(self, defs: Dict, *, device=None, dtype=torch.float32):
        super().__init__()
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, device=device, dtype=dtype),
                    requires_grad=False))
            else:
                self.add_module(name, ParamTree(d, device=device, dtype=dtype))
        self.defs = defs

    def tree(self) -> Dict:
        out = {name: getattr(self, name) for name in self.defs}
        return {name: p.tree() if isinstance(p, ParamTree) else p
                for name, p in out.items()}


@torch.no_grad()
def init_params(tree: ParamTree, generator: torch.Generator, *,
                whole: Optional[Dict[str, Tuple[int, ...]]] = None,
                part=None, prefix: str = "") -> ParamTree:
    """Fill ``tree`` in place: normal draws from ``generator`` (on the
    parameters' device) scaled as each ``ParamDef`` says, zeros or ones.
    The values are the port's own, not ``jax.random``'s.

    A shard (``whole``: each parameter's whole shape by its name,
    ``prefix`` + its key joined by dots) draws each leaf at its whole
    shape, in the same order, and keeps ``part(name, drawn)``: the same
    values as drawing the whole tree and cutting it."""
    for name, d in tree.defs.items():
        p = getattr(tree, name)
        if not isinstance(d, ParamDef):
            init_params(p, generator, whole=whole, part=part,
                        prefix=f"{prefix}{name}.")
        elif d.init == "zeros":
            p.zero_()
        elif d.init == "ones":
            p.fill_(1.0)
        elif whole is None:
            std = d.init if isinstance(d.init, float) else _stddev(d.shape)
            p.normal_(0.0, std, generator=generator)
        else:
            shape = whole[prefix + name]
            std = d.init if isinstance(d.init, float) else _stddev(shape)
            drawn = torch.empty(shape, dtype=p.dtype, device=p.device)
            drawn.normal_(0.0, std, generator=generator)
            p.copy_(part(prefix + name, drawn))
            del drawn
    return tree


def param_axes(defs):
    """Logical-axes tree with the same structure as ``defs``."""
    if isinstance(defs, ParamDef):
        return defs.axes
    return {name: param_axes(d) for name, d in defs.items()}


def _tensor(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy -> torch path
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for name, sub in tree.items():
            _flatten(sub, f"{prefix}{name}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def from_reference(params, cfg) -> Dict[str, torch.Tensor]:
    """The reference's param pytree (``repro.models.transformer
    .init_model``: numpy-convertible leaves, each run of layers stacked on
    a leading axis, ``runs_of(cfg)`` order, and an encoder-decoder's
    ``encoder`` one stacked dict) as the port's state dict:
    ``layers.{i}.…`` for the i-th layer of the model, ``encoder.{i}.…``
    for the i-th encoder layer, the other keys joined with dots."""
    from repro_torch.models.transformer import runs_of

    out: Dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in params.items() if k not in ("layers", "encoder")},
             "", out)
    layer = 0
    for (_, count), stacked in zip(runs_of(cfg), params["layers"]):
        _unstack(stacked, "layers", layer, count, out)
        layer += count
    if "encoder" in params:
        _unstack(params["encoder"], "encoder", 0, cfg.encoder_layers, out)
    return out


def _unstack(stacked, key: str, start: int, count: int,
             out: Dict[str, torch.Tensor]) -> None:
    """``count`` layers stacked on a leading axis as ``{key}.{start + j}.…``."""
    flat: Dict[str, torch.Tensor] = {}
    _flatten(stacked, "", flat)
    for j in range(count):
        for name, t in flat.items():
            out[f"{key}.{start + j}.{name}"] = t[j].clone()


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    out: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _stack(state: Dict[str, torch.Tensor], key: str, start: int,
           count: int) -> Dict:
    """Layers ``{key}.{start}`` .. ``{key}.{start + count - 1}`` stacked
    on a leading axis, nested by name."""
    prefix = f"{key}.{start}."
    names = [n[len(prefix):] for n in state if n.startswith(prefix)]
    return _nest({name: torch.stack([state[f"{key}.{start + j}.{name}"]
                                     for j in range(count)])
                  for name in names})


def to_reference(state: Dict[str, torch.Tensor], cfg) -> Dict:
    """The inverse of :func:`from_reference`: a port state dict (a
    model's, or anything keyed as its parameters are, such as AdamW's
    moments) as the reference's param tree — nested dicts, ``layers`` a
    list with one dict a run of ``runs_of(cfg)``, each leaf stacked over
    the run's layers, and an encoder-decoder's ``encoder`` one stacked
    dict.  Leaves are tensors on the state's device."""
    from repro_torch.models.transformer import runs_of

    out = _nest({k: v for k, v in state.items()
                 if not k.startswith(("layers.", "encoder."))})
    layers, start = [], 0
    for _, count in runs_of(cfg):
        layers.append(_stack(state, "layers", start, count))
        start += count
    out["layers"] = layers
    if cfg.is_encoder_decoder:
        out["encoder"] = _stack(state, "encoder", 0, cfg.encoder_layers)
    return out
