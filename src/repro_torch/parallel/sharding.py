"""Logical-axis sharding rules (MaxText-style) for the model zoo.

Port of ``src/repro/parallel/sharding.py``.  Model code names the axes
of its activations and parameters *logically* (``"batch"``, ``"heads"``,
``"cp_seq"``, ...); the rules table maps each name to mesh axes.  DP over
("pod", "data"); TP/EP/CP over "model".  :func:`use_mesh` activates a
mesh (a :class:`repro_torch.parallel.mesh.Mesh`) and optional rule
overrides for the calling thread; :func:`logical_to_spec` turns logical
names into a :class:`PartitionSpec` under them.

The port runs one process with no partitioner, so a spec decides no
layout by itself.  Three things read it: the spec trees of
``repro_torch.launch.shardspecs`` (and the dry run's layout), the
context-parallel kNN attention (``models.attention.knn_decode_attention``
takes the §7 path where ``"cp_seq"`` maps to axes of the active mesh),
and :func:`place`, which puts a leaf whole on its mesh's first device,
or, on a process mesh (``parallel.distributed``: one process a device,
the trainer's), keeps the calling rank's shard of it.
:func:`shard` (the reference's ``with_sharding_constraint``) returns its
input: a constraint changes a layout and never a value.

>>> from repro_torch.parallel.mesh import make_mesh
>>> mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
>>> with use_mesh(mesh):
...     logical_to_spec(("batch", None, "heads", "head_dim"))
PartitionSpec('data', None, 'model', None)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = [
    "LOGICAL_RULES",
    "PartitionSpec",
    "NamedSharding",
    "logical_to_spec",
    "shard",
    "param_spec",
    "use_mesh",
    "current_mesh",
    "named_shardings",
    "place",
]

# logical axis -> mesh axes (None = replicated).  ("pod","data") only ever
# shards batch-like axes; "model" shards head/ffn/expert/vocab axes.
LOGICAL_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    ("batch", ("pod", "data")),
    ("seq", None),                  # sequence kept whole for training
    ("cp_seq", "model"),            # context-parallel KV cache sequence
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("ffn", "model"),
    ("moe_ffn", None),              # EP owns "model"; per-expert FFN unsharded
    ("experts", "model"),           # expert parallelism
    ("vocab", "model"),
    ("kv_lora", None),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("lru_width", "model"),
    ("conv_dim", "model"),
    ("group", None),
    ("capacity", None),
    ("fsdp_embed", ("pod", "data")),  # ZeRO/FSDP param sharding for huge archs
)


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name,
    or a tuple of them (``jax.sharding.PartitionSpec`` as a tuple; a
    one-name tuple is that name, as there)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1
                                     else a for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (``jax.sharding.NamedSharding``).
    ``device`` is where :func:`place` puts a leaf: the mesh's first
    device, the whole tensor (the port has no partitioner)."""

    mesh: object
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]


_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def _rules():
    return dict(getattr(_state, "rules", None) or LOGICAL_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Sequence] = None):
    """Activate a mesh (and optional rule overrides) for the calling
    thread."""
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", None)
    _state.mesh = mesh
    _state.rules = tuple(rules) if rules is not None else None
    try:
        yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec under the active rules."""
    mesh = current_mesh()
    rules = _rules()
    axes = []
    for name in logical_axes:
        if name is None:
            axes.append(None)
            continue
        target = rules.get(name)
        if target is None or mesh is None:
            axes.append(None)
            continue
        # Drop mesh axes that don't exist on this mesh (e.g. "pod" on the
        # single-pod mesh).
        if isinstance(target, tuple):
            present = tuple(a for a in target if a in mesh.axis_names)
            axes.append(present if present else None)
        else:
            axes.append(target if target in mesh.axis_names else None)
    return PartitionSpec(*axes)


def shard(x, *logical_axes):
    """The reference's sharding constraint by logical names: ``x`` itself
    (one process, no partitioner to hand the layout to)."""
    return x


def param_spec(*logical_axes) -> PartitionSpec:
    """PartitionSpec for a parameter tensor."""
    return logical_to_spec(logical_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) for e in x)


def named_shardings(axes_tree, mesh):
    """A :class:`NamedSharding` on ``mesh`` for each leaf of ``axes_tree``
    (a tuple of logical axis names) under the active rules; namedtuples,
    dicts and lists are walked, None stays None."""
    if axes_tree is None:
        return None
    if _is_axes(axes_tree):
        return NamedSharding(mesh, logical_to_spec(axes_tree))
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(named_shardings(a, mesh) for a in axes_tree))
    if isinstance(axes_tree, dict):
        return {k: named_shardings(a, mesh) for k, a in axes_tree.items()}
    return type(axes_tree)(named_shardings(a, mesh) for a in axes_tree)


@torch.no_grad()
def place(tree, shardings):
    """``tree`` with each tensor leaf on its :class:`NamedSharding`'s
    device (``jax.device_put`` over a matching tree).  A module (a
    model) pairs with a dict of shardings by parameter name and moves in
    place; a tensor already on its device is returned as it is; a CPU
    scalar (a ``TrainState``'s step) stays on the host.

    On a process mesh each leaf becomes the calling rank's shard
    (``parallel.distributed.local_shard``, a copy on the rank's device:
    a dim cut over ``"model"``, one cut over the data axis (ZeRO-3), or
    both) and a model the rank's part of it, which the model makes (its
    ``shard(shardings)``, ``models.transformer.Transformer.shard``): the
    leaves must be whole, as a state drawn or restored whole is
    (``models.model.init_train_state(..., shardings=)`` draws a state
    by shards and places it itself)."""
    if shardings is None or tree is None:
        return tree
    if isinstance(tree, nn.Module) and _on_processes(shardings):
        return tree.shard(shardings)
    if isinstance(tree, nn.Module):
        devices = {s.device for s in shardings.values()}
        if len(devices) != 1:
            raise ValueError(f"a module's shardings span devices {devices}")
        return tree.to(devices.pop())
    if hasattr(tree, "_fields"):
        return type(tree)(*(place(getattr(tree, f), getattr(shardings, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor) and not (tree.device.type == "cpu"
                                               and tree.ndim == 0):
        if _on_processes(shardings):
            from repro_torch.parallel.distributed import local_shard

            return local_shard(tree, shardings.spec, shardings.mesh).to(
                shardings.device, copy=True).contiguous()
        return tree.to(shardings.device)
    return tree


def _on_processes(shardings) -> bool:
    """Whether ``shardings`` (one, or a dict of them) lie on a process
    mesh."""
    if isinstance(shardings, dict):
        shardings = next(iter(shardings.values()), None)
    return bool(getattr(getattr(shardings, "mesh", None), "is_process_mesh", False))
