"""One process a device: a ``torch.distributed`` process mesh under the
port's mesh rules.

The reference trains over a mesh by handing its state's shardings to
``jax.jit(in_shardings=...)`` and letting GSPMD partition the step
(``src/repro/launch/train.py``).  The port runs one process a device
instead, started by ``torchrun``: :func:`init_process_mesh` starts the
process group and lays the ranks out as a ``("data", "model")``
``DeviceMesh`` of the shape ``ft.elastic.choose_mesh_shape`` picks,
and returns a :class:`ProcessMesh`, a :class:`repro_torch.parallel.mesh.Mesh`
whose every device is the calling rank's own.  The spec trees
(``launch.shardspecs.train_state_shardings``, ``sanitize_tree``) read its
shape and axis names as they read any mesh's; ``parallel.sharding.place``
keeps the calling rank's shard of each leaf (:func:`local_shard`); the
training step reduces over its axes (:func:`all_reduce`).

Rank ``r`` sits at ``(r // model, r % model)``: the ranks of one
``"model"`` group are consecutive.  A dim a spec maps to ``"model"`` is
split into equal parts in rank order along that axis; a dim it maps to
``("pod", "data")`` (the ``fsdp_params`` archs' embed dim, ZeRO-3) is
split the same way over the data axis, read as one data group, so a
leaf may be cut along two dims.  A ``"pod"`` axis of size > 1 raises:
ROADMAP item 14b.4.

Backends: NCCL for cards (with gloo beside it for host tensors, so a
checkpoint gathers over the same groups), gloo for the CPU.  gloo on a
card is for ranks that share one card, which NCCL refuses: a collective
on a CUDA tensor then copies it through a pinned host buffer, reduces
there and copies it back (gloo reduces host memory; the copies are the
design of that path, not a fallback).  The training path uses
:func:`all_reduce` and :func:`broadcast`, and under ZeRO-3
:func:`all_gather` and :func:`reduce_scatter` along a dim (the
parameters gathered a layer at a time, their gradients scattered back:
``parallel.zero3``).  A checkpoint gathers each slab to rank 0 over the
axes that cut it (``checkpoint.checkpoint``; :func:`axis_groups`, or
:func:`host_groups`, gloo groups of its own for a writer's thread), and
``ft.elastic.remesh_state`` moves a state onto another process mesh of
the same ranks a leaf at a time (:func:`reshard`).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ft.elastic import choose_mesh_shape
from repro_torch.parallel.mesh import Mesh

__all__ = [
    "ProcessMesh",
    "init_process_mesh",
    "torchrun_env",
    "local_shard",
    "gather_full",
    "reshard",
    "spec_cuts",
    "axis_groups",
    "host_groups",
    "all_reduce",
    "all_reduce_coalesced",
    "all_gather",
    "reduce_scatter",
    "broadcast",
    "barrier",
    "local_shape",
    "local_rows",
    "local_batch",
    "sum_forward",
    "ShardLayout",
    "spec_axes",
    "is_process_mesh",
    "DATA",
    "POD_ITEM",
    "data_dim",
    "COLLECTIVES",
    "reset_collectives",
    "fake_process_mesh",
]

# the data group: the batch's axes, and ZeRO-3's parameter split
DATA = ("pod", "data")
# what a "pod" axis waits for
POD_ITEM = ("the \"pod\" axis (a ('pod', 'data', 'model') mesh of 512 ranks "
            "and more) is ROADMAP item 14b.4")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the one-tensor gather and scatter (named *_single from torch 2.13 on,
# where the *_tensor names warn)
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)
# a bucket of the data-parallel gradient reduction
BUCKET_BYTES = 64 << 20
# calls, bytes and host seconds of this process's collectives by
# "op[axes]"; a host-staged collective's seconds hold its copies (NCCL's
# count only the enqueue)
COLLECTIVES: Dict[str, Dict[str, float]] = {}


def reset_collectives() -> Dict[str, Dict[str, float]]:
    """``COLLECTIVES`` as it stands, then cleared."""
    out = {k: dict(v) for k, v in COLLECTIVES.items()}
    COLLECTIVES.clear()
    return out


def _count(kind: str, t: torch.Tensor, t0: float) -> None:
    entry = COLLECTIVES.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    entry["calls"] += 1
    entry["bytes"] += t.numel() * t.element_size()
    entry["seconds"] += time.perf_counter() - t0


def torchrun_env() -> Optional[Tuple[int, int, int]]:
    """``(RANK, WORLD_SIZE, LOCAL_RANK)`` as torchrun sets them, or None
    where ``WORLD_SIZE`` is unset (a single process)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ.get("RANK", "0")), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", "0")))


class ProcessMesh(Mesh):
    """The ranks of a process group as a mesh.  ``devices`` holds the
    calling rank's device at every position (a process sees only its
    own), so a :class:`~repro_torch.parallel.sharding.NamedSharding` on
    it places on that device.  ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` whose groups the collectives
    use; ``backend`` is ``"nccl"`` or ``"gloo"`` (``"fake"`` for
    :func:`fake_process_mesh`)."""

    is_process_mesh = True

    def __init__(self, device_mesh, device: torch.device, backend: str):
        names = tuple(device_mesh.mesh_dim_names)
        grid = np.empty(tuple(device_mesh.mesh.shape), dtype=object)
        grid.fill(device)
        super().__init__(grid, names)
        self.device_mesh = device_mesh
        self.device = self.devices.flat[0]
        self.backend = backend
        self.rank = dist.get_rank()
        self._staging: Optional[torch.Tensor] = None

    def axis_index(self, axis: str) -> int:
        """The calling rank's coordinate along ``axis`` (0 for an axis
        the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axis)]))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def staging(self, nbytes: int) -> torch.Tensor:
        """A pinned host buffer of at least ``nbytes`` bytes (uint8),
        kept for the next collective."""
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging[:nbytes]

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, rank {self.rank}, "
                f"{self.backend} on {self.device})")


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def init_process_mesh(model_parallel: int = 1, *, device,
                      backend: Optional[str] = None,
                      init_method: Optional[str] = None) -> ProcessMesh:
    """Start this process's process group (unless one is running) and
    return the :class:`ProcessMesh` over its ranks.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from torchrun (or
    the caller's environment; ``init_method`` defaults to ``env://``).
    ``device`` is the rank's device: a card (``cuda:{LOCAL_RANK}`` under
    torchrun) or ``"cpu"``.  ``backend`` defaults to NCCL for a card and
    gloo for the CPU; ``backend="gloo"`` on a card lets ranks share one
    card.  The mesh's shape is ``ft.elastic.choose_mesh_shape(world,
    model_parallel=...)``: ``model_parallel`` halved until it divides
    the world, the rest data-parallel.  One all-reduce over every rank,
    on the device, checks the group before the mesh is returned."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the rank's device is {device} and no CUDA "
                               "device is available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dist.is_initialized() and "fake" in str(dist.get_backend()):
        raise RuntimeError("the process group is a fake one "
                           "(fake_process_mesh): it runs no collective")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on cards; the CPU takes backend='gloo'")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if local > torch.cuda.device_count():
            raise RuntimeError(
                f"{local} ranks on this host and {torch.cuda.device_count()} "
                "cards: NCCL takes one card a rank; ranks share a card only "
                "with backend='gloo'")
    if not dist.is_initialized():
        env = torchrun_env()
        rank, world = (env[0], env[1]) if env else (0, 1)
        if init_method is None and env is None:
            raise RuntimeError("no process group and no torchrun environment "
                               "(WORLD_SIZE); launch with torchrun or pass "
                               "init_method=")
        # NCCL for card tensors, gloo beside it for host tensors (a
        # checkpoint's gather)
        spec = "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo"
        # no device_id: NCCL makes a group's communicator at its first
        # collective, so the mesh's unused groups (size 1) cost nothing
        dist.init_process_group(spec, init_method=init_method or "env://",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(minutes=10))
    world = dist.get_world_size()
    shape, names = choose_mesh_shape(world, model_parallel=model_parallel)
    if "pod" in names:
        raise NotImplementedError(f"{world} ranks give a ('pod', 'data', "
                                  f"'model') mesh: {POD_ITEM}")
    from torch.distributed.device_mesh import init_device_mesh

    # on the device first: the DeviceMesh keeps the device it finds set
    one = torch.ones(1, device=device)
    dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    mesh = ProcessMesh(dm, device, backend)
    if _staged(one, mesh):
        _through_host(one, mesh, dist.all_reduce)
    else:
        dist.all_reduce(one)
    if int(one.item()) != world:
        raise RuntimeError(f"the process group counts {one.item()} ranks, "
                           f"not {world}")
    return mesh


@contextlib.contextmanager
def fake_process_mesh(shape: Sequence[int], names: Sequence[str], *,
                      rank: int = 0):
    """A :class:`ProcessMesh` of ``shape`` (axes ``names``) as rank
    ``rank`` of a process group that has no other process: torch's fake
    backend (``torch.testing._internal.distributed.fake_pg``), whose
    collectives return at once and change nothing, and ``"meta"`` as the
    rank's device.  Counting a rank's program (``launch.dryrun
    .count_cell``) runs the port's own collectives on it, so
    :data:`COLLECTIVES` records what the rank would send.  Refuses to
    start where a process group is up (it never counts on a trainer's
    group); the group it starts is destroyed on leaving."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process: a "
                           "fake process mesh runs only where none is")
    shape, world = tuple(int(n) for n in shape), int(np.prod(shape))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a {shape} mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=tuple(names))
        yield ProcessMesh(dm, torch.device("meta"), "fake")
    finally:
        dist.destroy_process_group()


# -- collectives --------------------------------------------------------------


def _mesh(mesh) -> ProcessMesh:
    if mesh is None:
        from repro_torch.parallel.sharding import current_mesh

        mesh = current_mesh()
    if not getattr(mesh, "is_process_mesh", False):
        raise ValueError("a collective needs a ProcessMesh (init_process_mesh)")
    return mesh


def _staged(t: torch.Tensor, mesh: ProcessMesh) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def _through_host(t: torch.Tensor, mesh: ProcessMesh, fn) -> None:
    """``fn`` on a host copy of ``t`` (a pinned buffer), copied back."""
    flat = t.reshape(-1)
    buf = mesh.staging(flat.numel() * flat.element_size()).view(t.dtype)
    buf.copy_(flat)
    fn(buf)
    t.copy_(buf.view(t.shape))


def all_reduce(t: torch.Tensor, axis, op: str = "sum", *,
               mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """Reduce ``t`` in place over the mesh ``axis`` (a name or a tuple of
    names; absent names and axes of size 1 are skipped) and return it.
    ``op``: ``"sum"`` or ``"max"``.  Under gloo a CUDA tensor goes
    through a pinned host buffer."""
    mesh = _mesh(mesh)
    axes = [a for a in _axes(axis) if mesh.shape.get(a, 1) > 1]
    if not axes:
        return t
    if len(axes) > 1:
        if tuple(axes) != tuple(a for a in mesh.axis_names if a in axes):
            raise ValueError(f"axes {axes} out of the mesh's order")
        if len(axes) != len(mesh.axis_names):
            raise NotImplementedError(f"a reduction over {axes} of "
                                      f"{mesh.axis_names}")
        group = dist.group.WORLD
    else:
        group = mesh.group(axes[0])
    if not t.is_contiguous():
        raise ValueError("all_reduce reduces a contiguous tensor in place")

    def reduce(x):
        dist.all_reduce(x, op=_OPS[op], group=group)

    t0 = time.perf_counter()
    if _staged(t, mesh):
        _through_host(t, mesh, reduce)
    else:
        reduce(t)
    _count(f"all_reduce[{','.join(axes)}]", t, t0)
    return t


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], axis, *,
                         mesh: Optional[ProcessMesh] = None) -> None:
    """Sum each tensor in place over ``axis``, packed into flat buckets
    of at most ``BUCKET_BYTES`` (one tensor may exceed it) of one dtype:
    one collective a bucket."""
    mesh = _mesh(mesh)
    if all(mesh.shape.get(a, 1) == 1 for a in _axes(axis)):
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group + [None]:
            nbytes = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nbytes > BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                all_reduce(flat, axis, mesh=mesh)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view(b.shape))
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nbytes


def broadcast(t: torch.Tensor, src: int = 0, *,
              mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """``t`` in place from global rank ``src`` to every rank."""
    mesh = _mesh(mesh)
    if mesh.size == 1:
        return t

    def send(x):
        dist.broadcast(x, src=src)

    t0 = time.perf_counter()
    if _staged(t, mesh):
        _through_host(t, mesh, send)
    else:
        send(t)
    _count("broadcast", t, t0)
    return t


def _data_axis(axis, mesh: ProcessMesh) -> Optional[str]:
    """The one axis of ``axis`` (a name or a tuple read as one group) of
    size > 1, or None; raises for a ``"pod"`` axis of size > 1 and for
    two axes."""
    axes = [a for a in _axes(axis) if mesh.shape.get(a, 1) > 1]
    if "pod" in axes:
        raise NotImplementedError(f"a collective over {axes}: {POD_ITEM}")
    if len(axes) > 1:
        raise NotImplementedError(f"a gather or scatter over {axes}")
    return axes[0] if axes else None


def _stage_pair(src: torch.Tensor, out_shape, mesh: ProcessMesh):
    """Host views for a collective whose input (``src``'s bytes) and
    output (``out_shape``) differ in size: both in the pinned buffer,
    the input first, ``src`` copied in."""
    nin = src.numel() * src.element_size()
    nout = int(np.prod(out_shape)) * src.element_size()
    buf = mesh.staging(nin + nout)
    host_in = buf[:nin].view(src.dtype).view(src.shape)
    host_out = buf[nin:].view(src.dtype).view(out_shape)
    host_in.copy_(src)
    return host_in, host_out


def all_gather(t: torch.Tensor, axis, dim: int = 0, *,
               mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """Every rank's ``t`` of the ``axis`` group concatenated along
    ``dim`` in rank order: a new contiguous tensor (``t`` itself where
    the axis has size 1).  Under gloo a CUDA tensor goes through the
    pinned host buffer, input and output side by side.  Counted with
    the gathered tensor's bytes."""
    mesh = _mesh(mesh)
    axis = _data_axis(axis, mesh)
    if axis is None:
        return t
    n = mesh.shape[axis]
    group = mesh.group(axis)
    t0 = time.perf_counter()
    src = t.movedim(dim, 0).contiguous()
    shape = (n * src.shape[0],) + tuple(src.shape[1:])
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    if _staged(t, mesh):
        host_in, host_out = _stage_pair(src, shape, mesh)
        _all_gather_single(host_out, host_in, group=group)
        out.copy_(host_out)
    else:
        _all_gather_single(out, src, group=group)
    if dim:
        out = out.movedim(0, dim).contiguous()
    _count(f"all_gather[{axis}]", out, t0)
    return out


def reduce_scatter(t: torch.Tensor, axis, dim: int = 0, *,
                   mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """The sum of every rank's ``t`` over the ``axis`` group, cut into
    equal parts along ``dim``: the calling rank's part by its index (a
    new contiguous tensor; ``t`` itself where the axis has size 1).
    Under gloo a CUDA tensor goes through the pinned host buffer.
    Counted with ``t``'s bytes."""
    mesh = _mesh(mesh)
    axis = _data_axis(axis, mesh)
    if axis is None:
        return t
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    group = mesh.group(axis)
    t0 = time.perf_counter()
    src = t.movedim(dim, 0).contiguous()
    shape = (src.shape[0] // n,) + tuple(src.shape[1:])
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    if _staged(t, mesh):
        host_in, host_out = _stage_pair(src, shape, mesh)
        _reduce_scatter_single(host_out, host_in, group=group)
        out.copy_(host_out)
    else:
        _reduce_scatter_single(out, src, group=group)
    if dim:
        out = out.movedim(0, dim).contiguous()
    _count(f"reduce_scatter[{axis}]", t, t0)
    return out


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x.contiguous().clone(), axis, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_forward(x: torch.Tensor, axis, mesh: ProcessMesh) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, its gradient passed through as it
    is (each rank's backward then yields its own part of the gradient):
    Megatron's "g" over ``"model"``, the global loss over
    ``("pod", "data")``."""
    return _SumForward.apply(x, axis, mesh)


def barrier(mesh: Optional[ProcessMesh] = None) -> None:
    """Every rank waits for the others: an all-reduce of one value."""
    mesh = _mesh(mesh)
    all_reduce(torch.zeros((), device=mesh.device), mesh.axis_names, mesh=mesh)


# -- shards --------------------------------------------------------------------


def spec_cuts(spec, ndim: int, mesh: Mesh):
    """``(dim, axis)`` for each dim ``spec`` cuts: ``axis`` is
    ``"model"`` or ``"data"`` (``("pod", "data")`` read as one group;
    axes of size 1 cut nothing)."""
    out = []
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        axes = [a for a in (_axes(entry) if entry is not None else ())
                if mesh.shape.get(a, 1) > 1]
        if not axes:
            continue
        if axes == ["model"]:
            out.append((dim, "model"))
        elif set(axes) <= set(DATA):
            if "pod" in axes:
                raise NotImplementedError(f"spec {tuple(spec)} splits dim {dim} "
                                          f"over {entry}: {POD_ITEM}")
            out.append((dim, "data"))
        else:
            raise ValueError(f"spec {tuple(spec)}: unknown axes {entry}")
    return out


def data_dim(spec, ndim: int, mesh: Mesh) -> Optional[int]:
    """The dim ``spec`` cuts over the data axis (ZeRO-3's), or None."""
    return next((dim for dim, axis in spec_cuts(spec, ndim, mesh)
                 if axis == "data"), None)


def local_shard(tensor: torch.Tensor, spec, mesh: ProcessMesh) -> torch.Tensor:
    """The calling rank's part of the full ``tensor`` under ``spec`` (a
    sanitized ``PartitionSpec``): each dim mapped to ``"model"`` or to
    ``("pod", "data")`` cut into equal parts, the rank's by its index
    along that axis.  A view; the caller copies."""
    for dim, axis in spec_cuts(spec, tensor.ndim, mesh):
        n = mesh.shape[axis]
        if tensor.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split into {n}")
        tensor = tensor.chunk(n, dim=dim)[mesh.axis_index(axis)]
    return tensor


def local_shape(shape: Sequence[int], spec, mesh: ProcessMesh) -> Tuple[int, ...]:
    """The shape of the calling rank's part of a ``shape`` tensor under
    ``spec``."""
    out = list(shape)
    for dim, axis in spec_cuts(spec, len(shape), mesh):
        out[dim] //= mesh.shape[axis]
    return tuple(out)


def reshard(shard: torch.Tensor, spec, mesh: ProcessMesh, new_spec,
            new_mesh: ProcessMesh) -> torch.Tensor:
    """The calling rank's part under ``new_spec`` on ``new_mesh`` of the
    tensor whose part under ``spec`` on ``mesh`` is ``shard`` (two
    process meshes of the same ranks): gathered whole over ``mesh``'s
    cuts (:func:`gather_full`, a collective: every rank calls it), then
    cut for ``new_mesh``; a new contiguous tensor on ``new_mesh``'s
    device, the whole freed on return.  Under gloo a card's shard is
    gathered on the host (as :func:`gather_full` stages it) and cut
    there: only the new part goes back to the card."""
    shard = shard.detach()
    if _staged(shard, mesh):
        shard = shard.cpu()
    part = local_shard(gather_full(shard, spec, mesh), new_spec, new_mesh)
    return part.to(new_mesh.device, copy=True).contiguous()


def gather_full(shard: torch.Tensor, spec, mesh: ProcessMesh) -> torch.Tensor:
    """The full tensor from each rank's ``shard`` under ``spec``: the
    shards gathered in rank order over each axis that cuts a dim (every
    group gathers its own).  On the shard's device; under gloo a CUDA
    shard is gathered on the host."""
    cuts = spec_cuts(spec, shard.ndim, mesh)
    if not cuts:
        return shard
    device = shard.device
    if _staged(shard, mesh):
        shard = shard.cpu()
    for dim, axis in cuts:
        shard = shard.contiguous()
        parts = [torch.empty_like(shard) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, shard, group=mesh.group(axis))
        shard = torch.cat(parts, dim=dim)
    return shard.to(device)


# -- the batch -----------------------------------------------------------------


def local_rows(batch_size: int, mesh: Mesh) -> np.ndarray:
    """The global batch's rows the calling rank takes: its contiguous
    part by its index over ``("pod", "data")`` (the reference's batch
    sharding).  Every rank of a ``"model"`` group takes the same rows."""
    dp = mesh.axis_size(("pod", "data"))
    d = mesh.axis_index("data")
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} does not split over {dp} data "
                         "ranks")
    part = batch_size // dp
    return np.arange(d * part, (d + 1) * part)


# batch entries every rank holds whole (the reference's replicated ones)
_REPLICATED_INPUTS = ("mrope_positions",)


def local_batch(batch: Dict, mesh: Mesh) -> Dict:
    """``batch`` (the global batch: numpy arrays or tensors) with each
    batch-sharded entry cut to :func:`local_rows`."""
    n = batch["labels"].shape[0]
    rows = local_rows(n, mesh)
    if len(rows) == n:
        return batch
    return {k: v if k in _REPLICATED_INPUTS else v[rows]
            for k, v in batch.items()}


# -- a model's shard -------------------------------------------------------------


class ShardLayout:
    """How a rank's model shard sits on its :class:`ProcessMesh`:
    ``specs`` (each parameter's sanitized spec, by name), ``split`` (the
    names the ``"model"`` axis cuts), ``partial`` (the leaves of a split
    block it leaves whole, whose gradients hold one rank's heads' or
    experts' part: kv heads that do not divide the group, MLA's latent
    projections and norms, the MoE router;
    ``parallel.tensor_parallel.SPLIT_BLOCKS``) and
    ``data_split`` (the names the data axis cuts, ZeRO-3's; ``data_dims``
    maps each to its dim).  The training step reduces gradients and
    their norm through it."""

    def __init__(self, mesh: ProcessMesh, specs: Dict, split, partial,
                 data_dims: Optional[Dict[str, int]] = None):
        self.mesh = mesh
        self.specs = dict(specs)
        self.split = frozenset(split)
        self.partial = frozenset(partial)
        self.data_dims = dict(data_dims or {})
        self.data_split = frozenset(self.data_dims)
        self.model_size = mesh.shape.get("model", 1)
        self.data_size = mesh.axis_size(DATA)

    def __deepcopy__(self, memo):
        # a copy of a shard's model lies on the same ranks (the fake
        # copies of ``analysis.op_cost.program_cost``)
        return self

    def reduce_gradients(self, names, grads, grad_dtype=None):
        """The step's f32 gradients: the partial ones summed over
        ``"model"``, then every one the data axis leaves whole summed
        over ``("pod", "data")`` in buckets (each rank's loss is its share
        of the global mean), in bf16 under ``grad_dtype="bfloat16"`` (the
        compressed reduction).  A ZeRO-3 leaf's gradient was
        reduce-scattered into its shard in the backward."""
        partial = [g for n, g in zip(names, grads) if n in self.partial]
        all_reduce_coalesced(partial, "model", mesh=self.mesh)
        out = list(grads)
        whole = [i for i, n in enumerate(names) if n not in self.data_split]
        reduce = [grads[i] for i in whole]
        if grad_dtype == "bfloat16":
            reduce = [g.to(torch.bfloat16) for g in reduce]
        all_reduce_coalesced(reduce, DATA, mesh=self.mesh)
        for i, g in zip(whole, reduce):
            out[i] = g
        return [g.to(torch.float32) for g in out]

    def grad_norm(self, names, grads) -> torch.Tensor:
        """The global norm: each leaf's squares summed over every axis
        that cuts it (``"model"``, the data axis, or both), the leaves
        nothing cuts counted once.  The data axis is summed over only
        where it cuts a leaf (ZeRO-3): the other gradients are already
        summed over it."""
        # by (cut over "model", cut over the data axis)
        sums = {key: torch.zeros((), dtype=torch.float32, device=self.mesh.device)
                for key in ((False, False), (True, False), (False, True),
                            (True, True))}
        for n, g in zip(names, grads):
            key = (n in self.split, n in self.data_split)
            sums[key] = sums[key] + torch.sum(torch.square(g))
        model = all_reduce(torch.stack([sums[True, False], sums[True, True]]),
                           "model", mesh=self.mesh)
        data = sums[False, True] + model[1]
        if self.data_split:
            data = all_reduce(data, DATA, mesh=self.mesh)
        return torch.sqrt(sums[False, False] + model[0] + data)


def _axis_ranks(mesh: ProcessMesh, axis: str):
    """The rank lists of the groups along ``axis`` (rank ``r`` sits at
    ``(r // model, r % model)``), in axis order."""
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    if axis == "model":
        return [[i * m + j for j in range(m)] for i in range(d)]
    return [[i * m + j for i in range(d)] for j in range(m)]


def axis_groups(mesh: ProcessMesh) -> Dict[str, object]:
    """The calling rank's groups of ``mesh``: ``"model"``, ``"data"`` and
    ``"world"`` (every rank), the ones the mesh's collectives use (gloo
    for host tensors, also beside NCCL)."""
    return {"model": mesh.group("model"), "data": mesh.group("data"),
            "world": dist.group.WORLD}


def host_groups(mesh: ProcessMesh) -> Dict[str, object]:
    """New gloo groups over ``mesh``'s ranks, as :func:`axis_groups` lays
    them out: for collectives of host tensors that run beside the mesh's
    own (a checkpoint writer's thread) and so must never interleave with
    them.  Every rank calls this, in the same order (each group is made
    by every rank)."""
    out = {"world": dist.new_group(backend="gloo")}
    for axis in ("model", "data"):
        for ranks in _axis_ranks(mesh, axis):
            if len(ranks) > 1:
                group = dist.new_group(ranks, backend="gloo")
                if mesh.rank in ranks:
                    out[axis] = group
    return out


def is_process_mesh(mesh) -> bool:
    return bool(getattr(mesh, "is_process_mesh", False))


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis name ``spec`` mentions."""
    out = []
    for entry in tuple(spec):
        if entry is not None:
            out += list(_axes(entry))
    return tuple(out)

