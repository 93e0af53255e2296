"""Elastic scaling: rebuild the mesh for whatever devices survive and
re-place state from the last checkpoint.

Port of ``src/repro/ft/elastic.py``.  Checkpoints store full logical
arrays and every sharding derives from the logical axis rules
(``parallel.sharding``), so a restart at another device count is: pick
the new mesh shape, rebuild the shardings, place the state
(:func:`remesh_state`, or ``checkpoint.restore_checkpoint(...,
shardings=)`` straight from disk).  ``choose_mesh_shape`` keeps the model
axis fixed when possible and shrinks the data axis.  In one process the
port places a leaf whole on its mesh's first device
(``parallel.sharding.place``): it has no partitioner to split it.

Under a process mesh (``parallel.distributed``, one process a device)
:func:`remesh_state` moves a rank's shard in place onto another process
mesh of the same ranks, say (4, 1) ZeRO-3 to (2, 2) or (1, 4) tensor
parallelism: a leaf at a time gathered over its old cut and cut for the
new mesh.  Changing the number of processes is a restart: a checkpoint
(``checkpoint.save_checkpoint`` or the trainer's ``--ckpt-dir``), then
``torchrun`` at the new count, which ``launch/train.py --ckpt-dir``
resumes from.
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
    leaf keeps its values bit for bit.

    A ``TrainState`` whose model is a rank's shard (its ``layout`` set,
    on a ``parallel.distributed.ProcessMesh``) moves in place onto
    ``new_mesh``, another ``ProcessMesh`` over the same process group
    (every rank calls this): the result is the rank's shard under
    ``launch.shardspecs.train_state_specs(cfg, new_mesh)`` (the config's
    rules, ``fsdp_params`` included: ``axes_tree`` is the model's axes),
    one parameter and its two moments at a time gathered whole over the
    old cut, cut for the new mesh and freed
    (``transformer.reshard_model``); nothing of it holds the old mesh.
    It equals a ``checkpoint.save_checkpoint`` of ``state`` restored with
    ``shardings=`` at ``new_mesh``, bit for bit.  Any other target
    raises: changing the process count is a checkpoint, then a restart
    (the module docstring)."""
    layout = getattr(getattr(state, "params", None), "layout", None)
    if layout is not None:
        import torch.distributed as dist

        from repro_torch.parallel import distributed as D

        if not (D.is_process_mesh(new_mesh) and dist.is_initialized()
                and new_mesh.size == dist.get_world_size()):
            raise ValueError(
                f"a rank's shard on {layout.mesh} re-meshes only onto a "
                f"ProcessMesh of the same process group (init_process_mesh on "
                f"every rank), not {new_mesh!r}; to change the number of "
                "processes, save a checkpoint (checkpoint.save_checkpoint, or "
                "the trainer's --ckpt-dir) and restart under torchrun at the new "
                "count: launch/train.py --ckpt-dir resumes from it")
        if new_mesh is layout.mesh:
            return state
        from repro_torch.launch.shardspecs import train_state_specs
        from repro_torch.models.transformer import reshard_model

        specs = train_state_specs(state.params.cfg, new_mesh)
        opt = state.opt_state
        model, (m, v) = reshard_model(state.params, specs.params, (opt.m, opt.v))
        return state._replace(params=model, opt_state=type(opt)(m=m, v=v))
    with use_mesh(new_mesh):
        shardings = named_shardings(axes_tree, new_mesh)
    return place(state, shardings)
