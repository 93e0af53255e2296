"""The paper's own benchmark workloads (Table 2): Glove1.2M and Sift1M.

Port of ``src/repro/configs/knn_workloads.py``.  :meth:`KNNConfig.plan`
calls the port's ``plan_search``; the port has no TPU profile, so its
defaults are the card's profile and backend (``device="h100"``,
``backend="cuda"``) where the reference's are ``"tpu_v4"`` and
``"pallas"``.  ``plan(device="a100", backend="torch")`` is the
reference's ``plan(device="a100", backend="xla")`` field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["KNNConfig", "KNN_WORKLOADS"]


@dataclasses.dataclass(frozen=True)
class KNNConfig:
    name: str
    n: int                  # database size
    d: int                  # dimension (pre-padding)
    d_padded: int           # dimension after padding to 128
    m: int                  # query batch
    metric: str             # "cosine" | "l2"
    k: int = 10
    recall_target: float = 0.95
    # Appendix A.5 COP accounting flags
    non_pow2_n: bool = True
    broadcast_norm: bool = False

    @property
    def cops_per_dot(self) -> int:
        c = 3                       # PartialReduce
        c += int(self.metric == "l2")       # relaxed distance
        c += int(self.non_pow2_n)           # masking
        c += int(self.broadcast_norm)       # broadcasting ||x||^2/2
        return c

    def plan(self, device: str = "h100", backend: str = "cuda"):
        """The analytical kernel plan for this workload on ``device``.

        Thin hook into ``repro_torch.search.plan.plan_search`` so benchmark
        and figure scripts derive every kernel parameter the same way the
        live ``Index.build`` path does (imported lazily: configs must stay
        importable without pulling the search stack in).
        """
        from repro_torch.search.plan import plan_search

        return plan_search(
            n=self.n, d=self.d, k=self.k, m=self.m, metric=self.metric,
            recall_target=self.recall_target, device=device, backend=backend,
        )


KNN_WORKLOADS: Dict[str, KNNConfig] = {
    "glove1.2m": KNNConfig(
        name="glove1.2m", n=1_183_514, d=100, d_padded=128, m=10_000,
        metric="cosine", non_pow2_n=True, broadcast_norm=False,
    ),
    "sift1m": KNNConfig(
        name="sift1m", n=1_000_000, d=128, d_padded=128, m=10_000,
        metric="l2", non_pow2_n=True, broadcast_norm=True,
    ),
}
