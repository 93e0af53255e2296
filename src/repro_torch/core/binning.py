"""Recall <-> bin-count analytics for the PartialReduce kernel.

Port of ``src/repro/core/binning.py``: pure Python, kept as a verbatim
copy because the reference module is reachable only through
``repro.core``'s package import, which pulls in JAX.  Plans and integers
must equal the reference's exactly (``tests/test_torch_core.py``).

Implements Section 5.1 of the paper (Eqs. 13/14 and Appendix A.4):
the top-K entries are modelled as K balls thrown independently and
uniformly at random into L bins; PartialReduce keeps only the top-1 of
each bin, so a top-K entry survives iff no *better* top-K entry shares
its bin.  E[recall] = ((L-1)/L)^(K-1).
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "expected_recall",
    "bins_for_recall",
    "bins_for_recall_approx",
    "BinPlan",
    "plan_bins",
    "round_up",
]


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= ``x`` (tiling/layout helper)."""
    return ((x + mult - 1) // mult) * mult


def expected_recall(num_bins: int, k: int) -> float:
    """E[recall] of bin-wise top-1 reduction (Eq. 13)."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if num_bins <= 0:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    if k == 1:
        return 1.0  # the single best entry always wins its bin
    return ((num_bins - 1) / num_bins) ** (k - 1)


def bins_for_recall(k: int, recall_target: float) -> int:
    """Minimal L such that E[recall] >= recall_target (Eq. 14, exact inverse)."""
    if not 0.0 < recall_target < 1.0:
        raise ValueError(f"recall_target must be in (0, 1), got {recall_target}")
    if k <= 1:
        return 1
    # L >= 1 / (1 - r^{1/(K-1)})
    l = 1.0 / (1.0 - recall_target ** (1.0 / (k - 1)))
    l_int = int(math.ceil(l))
    # Guard against float round-off in both directions: the returned L is
    # the true minimum satisfying the guarantee.
    while expected_recall(l_int, k) < recall_target:
        l_int += 1
    while l_int > 1 and expected_recall(l_int - 1, k) >= recall_target:
        l_int -= 1
    return l_int


def bins_for_recall_approx(k: int, recall_target: float) -> float:
    """First-order approximation L ~= (K-1)/(1-r) (Eq. 14 / Appendix A.4)."""
    return (k - 1) / (1.0 - recall_target)


@dataclasses.dataclass(frozen=True)
class BinPlan:
    """Concrete binning layout chosen for an (N, K, recall_target) problem.

    Attributes:
      n: database size (reduction dimension length).
      k: number of neighbours requested.
      num_bins: L — number of bins actually emitted by PartialReduce.
      log2_bin_size: W — bins hold 2**W consecutive database entries.
      padded_n: num_bins * 2**W  (>= n; the tail is masked to -inf).
      expected_recall: analytical E[recall] of this plan (Eq. 13).
    """

    n: int
    k: int
    num_bins: int
    log2_bin_size: int
    padded_n: int
    expected_recall: float

    @property
    def bin_size(self) -> int:
        return 1 << self.log2_bin_size


def plan_bins(
    n: int,
    k: int,
    recall_target: float = 0.95,
    *,
    reduction_input_size_override: int = -1,
) -> BinPlan:
    """Choose (L, W) for PartialReduce.

    Mirrors the XLA ApproxTopK sizing logic: find the minimal L meeting the
    recall target (but at least K so rescoring can return K items), then use
    the largest power-of-two bin size 2**W with ceil(n / 2**W) >= L.

    ``reduction_input_size_override``: when the database is sharded across
    devices, each shard sees only n_local entries but the recall math must be
    evaluated against the *global* N (paper §7 / jax.lax.approx_max_k
    parameter of the same name).  The override sets the N used for recall
    accounting while bins are laid out over the local n.
    """
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if k > n:
        raise ValueError(f"k={k} exceeds database size n={n}")
    accounting_n = reduction_input_size_override if reduction_input_size_override > 0 else n

    l_min = max(bins_for_recall(k, recall_target), k)
    # Scale the global bin budget down to this shard.  The k-floor lives on
    # the *global* bin count (Eq. 13 holds over the union of shards; the
    # gathered candidate list has l * (N/n) >= l_min >= k entries), so a
    # shard only carries its proportional share of bins.
    l_target = (
        max(1, math.ceil(l_min * (n / accounting_n)))
        if accounting_n > n
        else l_min
    )
    if l_target >= n:
        # Degenerate: need (nearly) every entry — fall back to exact top-k
        # layout with bin size 1.
        w = 0
        l = n
    else:
        w = max(0, int(math.floor(math.log2(n / l_target))))
        l = math.ceil(n / (1 << w))
    padded = l * (1 << w)
    # Recall accounting always against the global bin count.
    l_global = l * max(1, accounting_n // n)
    return BinPlan(
        n=n,
        k=k,
        num_bins=l,
        log2_bin_size=w,
        padded_n=padded,
        expected_recall=expected_recall(l_global, k),
    )
