"""Production and host meshes.

Port of ``src/repro/launch/mesh.py`` over :class:`repro_torch.parallel
.mesh.Mesh`.

Single pod: (16, 16) = ("data", "model") — 256 chips.
Multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 chips; the "pod"
axis carries only data parallelism.

:func:`make_production_mesh` is that logical mesh over one named device
(``"meta"`` by default: nothing lives there): it serves the spec trees of
``launch/shardspecs.py``.  :func:`production_process_mesh` is the same
mesh as one rank of a fake process group: the dry run counts that rank's
program on it.  :func:`make_host_mesh` is a small mesh over the visible
cards (or given devices) for the trainer, examples and tests.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

from repro_torch.parallel import distributed as D
from repro_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_production_mesh", "production_process_mesh", "make_host_mesh"]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> Mesh:
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, devices=[device] * math.prod(shape))


@contextlib.contextmanager
def production_process_mesh():
    """The (16, 16) production mesh as rank 0 of a fake process
    group (``parallel.distributed.fake_process_mesh``: no other process,
    the rank's tensors on ``"meta"``), destroyed on leaving."""
    with D.fake_process_mesh(*SINGLE_POD) as mesh:
        yield mesh


def make_host_mesh(model_parallel: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (default every visible
    card; raises without one): ``model_parallel`` halved until it divides
    the device count, the rest data-parallel.  One card with
    ``model_parallel=2`` gives (1, 1), as the reference's one device does."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "make_host_mesh runs over the visible CUDA devices and none "
                "is available; pass devices=['cpu'] to build it on the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    n = len(devices)
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    return make_mesh((n // mp, mp), ("data", "model"), devices=devices)
