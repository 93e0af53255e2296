"""A mesh of torch devices: the port's counterpart of ``jax.sharding.Mesh``.

The reference's ``Index.shard(mesh)`` is a single controller: one caller
searches an object whose rows live on a mesh of devices.  The port keeps
that shape in one process: a :class:`Mesh` is an ndarray of
``torch.device`` with axis names, and the sharded backend
(``repro_torch.search.backends``) launches each shard's search on its own
device and gathers the winners to the first, as FAISS's ``IndexShards``
does across GPUs.  No ``torch.distributed`` is involved.

A mesh may name one device more than once.  Such a mesh runs S logical
shards through the same code a machine with S cards runs (per-shard
launches, global-id offsets, recall accounted against the global N, the
gather and the merge) on one card or on the CPU: the counterpart of the
reference's fake host devices.

>>> m = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
>>> dict(m.shape), m.devices.shape, str(m.devices[1, 0])
({'data': 2, 'model': 2}, (2, 2), 'cpu')
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it names (the current one), so that a mesh's
    device compares equal to its tensors' ``.device``."""
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return device


class Mesh:
    """``devices``: an ndarray of ``torch.device``, one dimension per name
    in ``axis_names``.  ``shape`` is an ordered dict of axis extents, as
    ``jax.sharding.Mesh.shape`` is."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[pos] = _indexed(torch.device(dev))
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"{grid.ndim}-D device grid but {len(axis_names)} axis names "
                f"{axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_grid(self, db_axes: Tuple[str, ...],
                    batch_axis: Optional[str] = None) -> list:
        """The devices as ``[batch group][database shard]``: shards
        linearized row-major over ``db_axes`` (the reference's shard ids),
        groups along ``batch_axis`` (one group without it); every other
        axis is a replica, and its first entry serves."""
        names = tuple(db_axes) + ((batch_axis,) if batch_axis else ())
        for a in names:
            if a not in self.axis_names:
                raise ValueError(
                    f"axis {a!r} is not in the mesh's axes {self.axis_names}")
        order = ([self.axis_names.index(batch_axis)] if batch_axis else []) \
            + [self.axis_names.index(a) for a in db_axes]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
        groups = self.shape[batch_axis] if batch_axis else 1
        return grid.reshape(groups, -1).tolist()

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.ravel()]})"


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` named ``names`` (``jax.make_mesh``).

    ``devices`` (row-major over ``shape``) defaults to ``cuda:0`` ..
    ``cuda:{n-1}`` and raises where the machine has fewer cards.  An
    explicit list may name a device more than once: logical shards on
    one card, or on the CPU."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} CUDA devices and this machine has "
                f"{have}; pass devices= (a device may repeat, e.g. "
                f"['cuda:0'] * {n} or ['cpu'] * {n})"
            )
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a {shape} mesh of {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(shape), names)
