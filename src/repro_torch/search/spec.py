"""SearchSpec: the frozen, hashable description of a search problem.

Port of ``src/repro/search/spec.py``.  The field names are the
reference's; the backends are the port's own:

  * ``"torch"`` — plain PyTorch scores + PartialReduce (the reference's
    ``"xla"`` path, ``backends.dense_search``);
  * ``"cuda"``  — the hand-written Hopper kernels
    (``repro_torch.kernels.partial_reduce``; the reference's
    ``"pallas"``).  On a CPU tensor the kernels' front ends run their
    plain PyTorch versions, which is how the CPU tests drive this path;
  * ``"sharded"`` — the database rows split over a mesh of torch
    devices (``repro_torch.parallel.mesh``), each shard searched on its
    own device with that device's path, the winners merged on the first
    (the reference's ``"sharded"``, paper §7);
  * ``"auto"``  — ``"sharded"`` for an index with a mesh attached, else
    ``"cuda"`` for an index on a CUDA device, else ``"torch"``.

Fields the reference has but the port does not serve yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
``dtype="bfloat16"`` casts rows and queries to bf16 before preparation
(the CUDA scan then multiplies in one tensor-core pass), and
``cluster`` defaults to ``"auto"`` (the planner-derived pruned scan,
``repro_torch.search.cluster``), both as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.search import quant

__all__ = ["BACKENDS", "DTYPES", "SearchSpec", "check_tiles"]

BACKENDS = ("auto", "torch", "cuda", "sharded")

# Compute dtypes the port runs (None: the database's own, float32).
DTYPES = (None, "float32", "bfloat16")


def check_tiles(block_m: Optional[int], max_block_n: Optional[int]) -> None:
    """Accept unset tile fields or the CUDA kernels' fixed tiles
    (``kernels.partial_reduce.BLOCK_M`` x ``BLOCK_N``), which are compiled
    into ``csrc/partial_reduce.cu``; raise on any other value."""
    # imported here: the kernels' front end imports this package
    from repro_torch.kernels.partial_reduce import BLOCK_M, BLOCK_N

    for field, value, fixed in (("block_m", block_m, BLOCK_M),
                                ("max_block_n", max_block_n, BLOCK_N)):
        if value is not None and value != fixed:
            raise NotImplementedError(
                f"{field}={value}: the CUDA kernels' tiles are fixed at "
                f"{BLOCK_M}x{BLOCK_N} rows (csrc/partial_reduce.cu); leave "
                f"{field} unset or pass {fixed}"
            )


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Frozen description of an approximate-KNN search problem.

    Attributes (reference semantics unless noted):
      metric: registered metric name ("mips", "l2", "cosine", ...).
      k: neighbours returned per query.
      recall_target: analytic E[recall] target used to plan bins (Eq. 14).
      backend: one of ``BACKENDS`` (see the module docstring).
      dtype: compute dtype, one of ``DTYPES``: rows and queries are cast
        to it before metric preparation (None: float32).  With
        "bfloat16" the stored f32 tier holds bf16 rows, and a quantized
        tier quantizes the bf16-cast rows.
      storage: one of ``quant.STORAGE_TIERS``; a quantized tier scans
        its stored rows for an over-fetched candidate set and rescores
        it exactly (``repro_torch.search.quant``).
      cluster: "auto" (default: the planner decides whether a
        cluster-pruned scan pays, ``search.plan.plan_clusters``, and the
        build checks the tables' miss rate) or "off".
      rescore: None (on for quantized tiers) or a bool; True needs a
        quantized tier and ``aggregate_to_topk``.
      block_m / max_block_n: kernel tiles: None or the CUDA kernels'
        fixed 128 (``check_tiles``); ``Index.build`` resolves None to it.
      query_block: rows per block when a search streams queries.  Only the
        plain paths stream (to bound their (query_block, N) score tile);
        the CUDA kernels take any M in one call.
      stream: True (default): the CUDA kernels take a whole batch in one
        call, the plain paths stream it in ``query_block`` blocks.  False
        is the reference's per-block dispatch loop on every backend (one
        search of each ``query_block`` rows, the card included): the
        parity oracle and the dispatch baseline.  A host index streams
        its waves over the whole batch either way.
      aggregate_to_topk: rescore to the top-k (True) or return the raw
        bin winners (False).
      use_bitonic: the rescore and merge stages sort with the paper's
        bitonic network (``core.rescoring.bitonic_sort_pairs``) instead
        of a stable sort; off by default, as in the reference.
      fused_select: on the cuda backend, the single-pass scan→select
        kernel (None resolves to True when a selection happens); False
        runs the two-pass bin-winner kernel, then ``sentinelize_masked``
        and ``merge_topk``.
      reduction_input_size_override: recall-accounting N (-1: own N).
      serve_buckets: the serving micro-batch ladder (ascending positive
        sizes), or None; ``Index.build`` fills it from the planner
        (``plan.plan_buckets`` of the ``query_block``), and a
        ``SearchServer`` without its own ladder uses it.
      residency: where the packed database lives between searches:
        "hbm" (on the index's device) or "host" (the cold tier: pinned
        host memory, streamed through the device in fixed-size segment
        waves, ``repro_torch.search.hosttier``).  Unlike the reference,
        the "cuda" backend scans the waves with the kernels.
      segment_rows: rows a host-tier wave streams; None defers to the
        planner (``plan.plan_segments``).  Unused for "hbm".

    >>> SearchSpec(metric="l2", k=4).resolved
    False
    >>> SearchSpec(k=4, block_m=128, max_block_n=128, query_block=4096).resolved
    True
    """

    metric: str = "mips"
    k: int = 10
    recall_target: float = 0.95
    backend: str = "auto"
    dtype: Optional[str] = None
    storage: str = "f32"
    cluster: str = "auto"
    rescore: Optional[bool] = None
    block_m: Optional[int] = None
    max_block_n: Optional[int] = None
    query_block: Optional[int] = None
    stream: bool = True
    aggregate_to_topk: bool = True
    use_bitonic: bool = False
    fused_select: Optional[bool] = None
    reduction_input_size_override: int = -1
    serve_buckets: Optional[Tuple[int, ...]] = None
    residency: str = "hbm"
    segment_rows: Optional[int] = None

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if not 0.0 < self.recall_target < 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1), got {self.recall_target}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )
        quant.storage_bytes(self.storage)  # validate the tier name
        if self.residency not in ("hbm", "host"):
            raise ValueError(
                f'residency must be "hbm" or "host", got {self.residency!r}'
            )
        if self.segment_rows is not None and self.segment_rows <= 0:
            raise ValueError(
                f"segment_rows must be positive, got {self.segment_rows}"
            )
        if self.residency == "host" and not self.aggregate_to_topk:
            raise ValueError(
                'residency="host" merges per-segment top-k carries and '
                "needs aggregate_to_topk=True: the raw bin winners of one "
                "segment wave are not comparable across waves"
            )
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype={self.dtype!r}: the port computes in one of "
                f"{DTYPES[1:]} (None: float32).  Reduced-precision "
                'storage is storage="bf16"|"int8"|"int4"'
            )
        if self.cluster not in ("auto", "off"):
            raise ValueError(
                f'cluster must be "auto" or "off", got {self.cluster!r} — '
                "cluster parameters are planner-derived, not user knobs"
            )
        if self.residency == "host" and self.backend == "sharded":
            raise ValueError(
                'residency="host" streams database segments through one '
                "device; it cannot be sharded over a mesh"
            )
        if self.serve_buckets is not None:
            buckets = tuple(int(b) for b in self.serve_buckets)
            if not buckets or any(b <= 0 for b in buckets):
                raise ValueError(
                    f"serve_buckets must be positive, got {self.serve_buckets}"
                )
            if list(buckets) != sorted(set(buckets)):
                raise ValueError(
                    "serve_buckets must be strictly ascending, got "
                    f"{self.serve_buckets}"
                )
            object.__setattr__(self, "serve_buckets", buckets)
        if self.rescore and self.storage == "f32":
            raise ValueError(
                "rescore=True requires a quantized storage tier "
                '("bf16", "int8" or "int4"); storage="f32" is already exact'
            )
        if self.fused_select and not self.aggregate_to_topk:
            raise ValueError(
                "fused_select=True needs aggregate_to_topk=True: the fused "
                "kernel's carry is the top-k selection, so there are no raw "
                "bin winners to return"
            )
        if self.rescore and not self.aggregate_to_topk:
            raise ValueError(
                "rescore=True needs aggregate_to_topk=True: the raw bin "
                "winners are the output then, so there is no top-k to "
                "rescore into; use rescore=False for a raw quantized scan"
            )
        if self.storage != "f32":
            # Checked here for a registered metric; Index.build re-checks.
            from repro_torch.search.metrics import _REGISTRY

            metric = _REGISTRY.get(self.metric)
            if metric is not None:
                quant.check_metric_storage(metric, self.storage)
        for field in ("block_m", "max_block_n", "query_block"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"{field} must be positive, got {v}")
        check_tiles(self.block_m, self.max_block_n)

    @property
    def rescore_enabled(self) -> bool:
        """Whether the quantized search runs its exact rescore.

        >>> SearchSpec(storage="int8").rescore_enabled
        True
        >>> SearchSpec(storage="f32").rescore_enabled
        False
        """
        if self.storage == "f32" or not self.aggregate_to_topk:
            return False
        return True if self.rescore is None else self.rescore

    @property
    def fused_select_enabled(self) -> bool:
        """Resolved ``fused_select`` (the cuda backend consults this).

        >>> SearchSpec().fused_select_enabled
        True
        >>> SearchSpec(fused_select=False).fused_select_enabled
        False
        """
        if self.fused_select is not None:
            return self.fused_select
        return self.aggregate_to_topk

    @property
    def resolved(self) -> bool:
        """True once every planner-deferred block field holds a value."""
        return not (
            self.block_m is None
            or self.max_block_n is None
            or self.query_block is None
        )

    def with_backend(self, backend: str) -> "SearchSpec":
        return dataclasses.replace(self, backend=backend)

    # -- snapshot (de)serialization ------------------------------------------

    def to_json_dict(self) -> dict:
        """JSON-safe field dict (``Index.save`` stamps it into snapshots).

        >>> SearchSpec.from_json_dict(SearchSpec(k=4).to_json_dict()).k
        4
        """
        d = dataclasses.asdict(self)
        if d["serve_buckets"] is not None:
            d["serve_buckets"] = list(d["serve_buckets"])
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "SearchSpec":
        """Inverse of :meth:`to_json_dict`; a field this version does not
        know (a snapshot of a newer version) raises."""
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"snapshot spec carries unknown fields {unknown} — written "
                "by a newer version? Rebuild the index or upgrade."
            )
        if d.get("serve_buckets") is not None:
            d["serve_buckets"] = tuple(d["serve_buckets"])
        return cls(**d)
