"""Elastic scaling: rebuild the mesh for whatever devices survive and
re-place state from the last checkpoint.

Port of ``src/repro/ft/elastic.py``.  Checkpoints store full logical
arrays and every sharding derives from the logical axis rules
(``parallel.sharding``), so a restart at another device count is: pick
the new mesh shape, rebuild the shardings, place the state
(:func:`remesh_state`, or ``checkpoint.restore_checkpoint(...,
shardings=)`` straight from disk).  ``choose_mesh_shape`` keeps the model
axis fixed when possible and shrinks the data axis.  The port places a
leaf whole on its mesh's first device (``parallel.sharding.place``): it
has no partitioner to split it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.parallel.mesh import Mesh, make_mesh
from repro_torch.parallel.sharding import named_shardings, place, use_mesh

__all__ = ["choose_mesh_shape", "remesh_state", "survivors_mesh"]


def choose_mesh_shape(
    n_devices: int, *, model_parallel: int = 16, multi_pod_threshold: int = 512
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable mesh for n_devices, preferring to keep TP width."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    dp = n_devices // mp
    if n_devices >= multi_pod_threshold:
        pods = n_devices // multi_pod_threshold
        while dp % pods:
            pods //= 2
        return (pods, dp // pods, mp), ("pod", "data", "model")
    return (dp, mp), ("data", "model")


def survivors_mesh(devices: Optional[Sequence] = None, *,
                   model_parallel: int = 16) -> Mesh:
    """The :func:`choose_mesh_shape` mesh over ``devices`` (torch devices
    or their names; default every visible card)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("no CUDA device survives; pass devices=")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    shape, axes = choose_mesh_shape(len(devices), model_parallel=model_parallel)
    return make_mesh(shape, axes, devices=devices[:math.prod(shape)])


def remesh_state(state, axes_tree, new_mesh: Mesh):
    """``state`` (a ``TrainState`` or a tree of tensors) placed on
    ``new_mesh`` by ``axes_tree``, a tree of logical axes matching it (a
    model's: a dict by parameter name, ``transformer.model_axes``).  Every
    leaf keeps its values bit for bit.  A process mesh
    (``parallel.distributed``) raises: re-meshing across process counts
    is ROADMAP item 14b.3 (a checkpoint restored with ``shardings=``
    crosses meshes)."""
    if getattr(new_mesh, "is_process_mesh", False):
        raise NotImplementedError(
            "remesh_state over a process mesh (elastic re-meshing across "
            "process counts) is ROADMAP item 14b.3; restore a checkpoint with "
            "shardings= instead")
    with use_mesh(new_mesh):
        shardings = named_shardings(axes_tree, new_mesh)
    return place(state, shardings)
