"""Functional one-shot search API.

Port of ``src/repro/search/functional.py``.  Prefer
``repro_torch.search.Index`` for anything called more than once: it
prepares and packs the database once.  These functions prepare the raw
database on every call, fuse its metric bias with ``packed.fuse_bias``
(the packed path's finite clamp) and search it on ``device``: the
``"cuda"`` kernels there (``backends.cuda_search``), or the plain path
(``backends.dense_search``) on the CPU.  ``device`` defaults to the card
and raises without one, as ``Index.build`` does; pass ``device="cpu"``
for the plain PyTorch path.  ``mesh=`` (a ``repro_torch.parallel.mesh.
Mesh``) searches the rows split over its devices
(``backends.make_sharded_search_fn``).

Value conventions are owned by ``repro_torch.search.metrics``.

>>> import torch
>>> v, i = search(torch.eye(4)[:1], torch.eye(4), k=2, device="cpu")
>>> int(i[0, 0]), float(v[0, 0])
(0, 1.0)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.search import backends
from repro_torch.search.metrics import (
    exact_cosine_nns,
    exact_l2nns,
    exact_mips,
    exact_search,
    get_metric,
    half_norms,
)
from repro_torch.search.packed import fuse_bias

__all__ = [
    "search",
    "mips",
    "l2nns",
    "cosine_nns",
    "half_norms",
    "exact_mips",
    "exact_l2nns",
    "exact_cosine_nns",
    "exact_search",
]


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the functional search runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _run(backend: str, queries, database, row_bias, **kw):
    if backend == "cuda":
        return backends.cuda_search(queries, database, row_bias, **kw)
    if backend == "torch":
        return backends.dense_search(queries, database, row_bias, **kw)
    if backend == "sharded":
        raise ValueError("backend='sharded' requires a mesh")
    raise ValueError(f"unknown backend {backend!r}")


def search(
    queries,
    database,
    *,
    metric: str = "mips",
    k: int = 10,
    recall_target: float = 0.95,
    backend: str = "auto",
    mesh=None,
    db_axis="model",
    batch_axis: Optional[str] = None,
    row_bias=None,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot search of ``queries`` against a raw ``database``.

    ``backend="auto"`` runs the kernels on a CUDA ``device`` and the
    plain path on the CPU (``"torch"`` and ``"cuda"`` pick one; the
    kernels run their plain versions on CPU tensors).  With ``mesh=``
    ``"auto"`` is ``"sharded"``: the rows split over ``db_axis``, the
    query rows over ``batch_axis``, each shard searched on its device and
    the results gathered to the mesh's first device (``device`` is then
    that device), the recall accounted against the global N
    (``reduction_input_size_override`` does not apply), as in the
    reference.
    """
    if mesh is not None:
        device = mesh.devices.flat[0]
    device = _device(device)
    queries, database = _tensor(queries, device), _tensor(database, device)
    db, metric_bias = get_metric(metric).prepare_database(database)
    if row_bias is not None:
        row_bias = _tensor(row_bias, device)
    if metric_bias is not None:
        # Same finite-mask clamp as the packed path (Appendix A.5 fusion).
        fused = fuse_bias(metric_bias, num_rows=db.shape[0])
        row_bias = fused if row_bias is None else row_bias + fused
    if backend == "auto":
        backend = backends.default_backend(device, mesh)
    if backend == "sharded" and mesh is not None:
        fn = backends.make_sharded_search_fn(
            mesh, metric=metric, k=k, recall_target=recall_target,
            db_axis=db_axis, batch_axis=batch_axis)
        return fn(queries, db, row_bias)
    return _run(
        backend, queries, db, row_bias, metric=metric, k=k,
        recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk,
    )


# --- Legacy-signature functional entry points -------------------------------


def _legacy(metric: str, queries, database, row_bias, k, device, **kw):
    device = _device(device)
    return _run(backends.default_backend(device), _tensor(queries, device),
                _tensor(database, device),
                None if row_bias is None else _tensor(row_bias, device),
                metric=metric, k=k, **kw)


def mips(
    queries,
    database,
    k: int = 10,
    *,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum inner product search (paper Listing 1)."""
    return _legacy(
        "mips", queries, database, None, k, device,
        recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk,
    )


def l2nns(
    queries,
    database,
    k: int = 10,
    *,
    db_half_norm=None,
    recall_target: float = 0.95,
    reduction_input_size_override: int = -1,
    aggregate_to_topk: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean NN search (paper Listing 2); values follow the L2 contract
    in ``repro_torch.search.metrics`` (relaxed distances, ascending)."""
    if db_half_norm is None:
        db_half_norm = half_norms(_tensor(database, _device(device)))
    return _legacy(
        "l2", queries, database, -_tensor(db_half_norm, _device(device)), k,
        device, recall_target=recall_target,
        reduction_input_size_override=reduction_input_size_override,
        aggregate_to_topk=aggregate_to_topk,
    )


def cosine_nns(
    queries,
    database_normalized,
    k: int = 10,
    *,
    device=None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine search == MIPS on l2-normalized operands (paper §2).

    Legacy contract: ``database_normalized`` rows are already unit-norm;
    queries are normalized here.  ``Index`` with metric="cosine" handles
    raw databases instead.
    """
    q = get_metric("cosine").prepare_queries(_tensor(queries, _device(device)))
    return mips(q, database_normalized, k, device=device, **kwargs)
