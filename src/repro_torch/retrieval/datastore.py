"""kNN-LM datastore on the search API.

Port of ``src/repro/retrieval/datastore.py``.  The datastore is a
``repro_torch.search.Index`` over (key, value-token) pairs, optionally
split over a mesh of torch devices (``Index.shard``: each shard scanned
on its device with the recall accounted against the global N, the
winners gathered and merged), plus the kNN-LM interpolation head.  The
index is index-free, so the datastore takes frequent updates: ``extend``
appends pairs and ``forget`` tombstones old ones with no rebuild.

``lookup`` never prepares or pads the (N, D) key matrix (that happened
once at construction or ``extend``); on the card a lookup is the fused
scan and the carry merge, two kernel launches.  ``attach_server`` puts a
``SearchServer`` in front of the index, so lookups from independent
callers coalesce into micro-batches (one CUDA graph replay each on the
card).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.search import Index
from repro_torch.search import telemetry
from repro_torch.search.backends import DISPATCH_COUNTS
from repro_torch.search.packed import PACK_EVENTS
from repro_torch.search.serve import SearchServer, ServeConfig

__all__ = ["KNNDatastore", "knn_lm_logits"]


class KNNDatastore:
    """``keys`` (N, D) and the token each predicts, ``value_tokens`` (N,),
    indexed on ``device`` (default "cuda", which must exist; "cpu" runs
    the plain path).  ``build_kwargs`` go to ``Index.build`` (the
    default ``cluster="auto"`` lets the planner decide on pruning).
    ``mesh=`` (a ``repro_torch.parallel.mesh.Mesh``) shards the keys
    over ``db_axis`` and the lookups over ``batch_axis`` (where the mesh
    has that axis), on the mesh's devices; ``device`` is then the mesh's
    first."""

    def __init__(
        self,
        keys,
        value_tokens,
        mesh=None,
        *,
        k: int = 32,
        recall_target: float = 0.95,
        db_axis="model",
        batch_axis: Optional[str] = "data",
        metric: str = "mips",
        capacity: Optional[int] = None,
        device=None,
        **build_kwargs,
    ):
        # Pre-allocating ``capacity`` keeps ``extend`` on the cheap path:
        # append-slice patches only, no packed-layout growth copies.  With
        # a mesh, backend="sharded" packs nothing before ``shard`` does.
        if mesh is not None:
            device = mesh.devices.flat[0]
            build_kwargs.setdefault("backend", "sharded")
        self.index = Index.build(
            keys, metric=metric, k=k, recall_target=recall_target,
            capacity=capacity, device=device, **build_kwargs,
        )
        if mesh is not None:
            if batch_axis is not None and batch_axis not in mesh.shape:
                batch_axis = None  # a mesh without the axis: no batch split
            self.index = self.index.shard(mesh, db_axis=db_axis,
                                          batch_axis=batch_axis)
        self.mesh = mesh
        self.k = k
        self.value_tokens = torch.as_tensor(value_tokens, device=self.index.device)
        self.server: Optional[SearchServer] = None

    @property
    def keys(self) -> torch.Tensor:
        return self.index._db

    def __len__(self) -> int:
        return len(self.index)

    def attach_server(
        self,
        server: Optional[SearchServer] = None,
        *,
        config: Optional[ServeConfig] = None,
        **server_kwargs,
    ) -> SearchServer:
        """Route ``lookup`` through a coalescing ``SearchServer``.

        Builds one over this datastore's index (``config`` / keyword
        arguments forwarded to ``SearchServer``) unless an existing
        ``server``, which must already serve this index, is handed in.
        Returns the attached server so callers can ``submit`` directly or
        ``close`` it.
        """
        if server is None:
            server = SearchServer(self.index, config, **server_kwargs)
        elif server.index is not self.index:
            raise ValueError("server serves a different Index instance")
        self.server = server
        return server

    def lookup(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (scores (M, k), neighbour value tokens (M, k)).

        With an attached server the batch rides the coalescing queue;
        otherwise it is a direct index search (on the card the two are
        bit-identical); both return tensors on the index's device.  A
        masked result slot (index -1: fewer live keys than k, on the
        kernel path) maps to the last value token, as the reference's
        ``jnp.take`` maps it.
        """
        if self.server is not None:
            # the server hands results back in host memory
            vals, idxs = (t.to(self.index.device) for t in self.server.search(queries))
        else:
            vals, idxs = self.index.search(queries)
        return vals, self.value_tokens[idxs.long()]

    # -- frequent updates (the paper's "no index maintenance" claim) ---------

    def _mutation_gate(self):
        """The attached server's mutation gate, or a no-op without one:
        index updates must never interleave with a worker-thread dispatch
        (``SearchServer.mutation``)."""
        if self.server is not None:
            return self.server.mutation()
        return contextlib.nullcontext()

    def extend(self, keys, value_tokens) -> "KNNDatastore":
        """Append (key, token) pairs in place; no rebuild."""
        device = self.index.device
        keys = torch.atleast_2d(torch.as_tensor(keys, dtype=torch.float32,
                                                device=device))
        value_tokens = torch.atleast_1d(torch.as_tensor(value_tokens, device=device))
        if keys.shape[0] != value_tokens.shape[0]:
            raise ValueError(
                f"{keys.shape[0]} keys vs {value_tokens.shape[0]} tokens"
            )
        with self._mutation_gate():
            start = self.index.num_appended
            self.index.add(keys)
            # Keep value_tokens aligned with the append-only row space.
            pad = self.index.capacity - self.value_tokens.shape[0]
            if pad > 0:
                self.value_tokens = torch.nn.functional.pad(self.value_tokens, (0, pad))
            self.value_tokens[start : start + value_tokens.shape[0]] = (
                value_tokens.to(self.value_tokens.dtype))
        return self

    def forget(self, ids) -> "KNNDatastore":
        """Tombstone datastore rows by index (e.g. stale documents): a
        bias patch on the device."""
        with self._mutation_gate():
            self.index.delete(ids)
        return self

    def stats(self) -> dict:
        """Graph-cache and packing observability for serving dashboards.

        ``telemetry`` carries the global dispatch and packing counters and
        the served latency histogram; the full registry export is
        ``self.index.telemetry()``.
        """
        info = dict(self.index.cache_info())
        info["capacity"] = self.index.capacity
        info["appended"] = self.index.num_appended
        reg = telemetry.registry()
        info["telemetry"] = {
            "dispatches": dict(DISPATCH_COUNTS),
            "pack_events": dict(PACK_EVENTS),
            "latency": reg.histogram_snapshot(
                "repro_serve_request_latency_seconds"
            ),
        }
        if self.server is not None:
            info["server"] = self.server.stats()
        return info


def knn_lm_logits(
    lm_logits: torch.Tensor,        # (M, V)
    knn_scores: torch.Tensor,       # (M, k) inner-product scores
    knn_tokens: torch.Tensor,       # (M, k)
    *,
    lam: float = 0.25,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Interpolate p_LM with the neighbour distribution (Khandelwal et
    al.).  A token met twice sums its weights (``scatter_add_``, whose
    order of summation on the card is its own)."""
    vocab = lm_logits.shape[-1]
    w = torch.softmax(knn_scores / temperature, dim=-1)
    p_knn = torch.zeros((w.shape[0], vocab), dtype=w.dtype, device=w.device)
    p_knn.scatter_add_(1, knn_tokens.long(), w)
    p_lm = torch.softmax(lm_logits, dim=-1)
    return torch.log((1 - lam) * p_lm + lam * p_knn + 1e-20)
