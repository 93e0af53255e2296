"""Op-level cost of one search: the port's counterpart of
``src/repro/analysis/hlo_cost.py``.

The reference audits its planner against the optimized HLO of the
compiled search: the dot FLOPs, a fusion-boundary byte estimate and an
element count of the other ops.  The port has no compiled program to
read.  It runs the index's plain search path once, at a batch of ``m``
queries on the index's device, under
``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes
propagate, nothing is computed or allocated.  Two modes count the ops
underneath:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode`` (2·M·N·K
    a matmul), the numerator of the compute roof, and 2·m·c·d for each
    fixed-order dot (``stages.dot_rows``: the rescore's and the pruned
    scan's, products and halving adds that the counter cannot tell from
    other element-wise ops); ``kernel_dot_flops`` is the part of it the
    CUDA scan computes;
  * ``hbm_bytes_hi``: operand plus result bytes of every aten op that is
    not a view (the reference's fusion-boundary model, at op
    granularity); ``hbm_bytes_lo``: the search's operands read once and
    its results written once (perfect fusion); ``hbm_bytes``: their
    geometric mean, as the reference reports;
  * ``cop_count``: the result elements of every op that is neither a
    dot nor a view.

The ``"cuda"`` kernels are ``ctypes`` calls that the modes cannot see
into, so a ``"cuda"`` index is counted through the kernels' plain
version (``kernels.ref.partial_reduce_ref``) at the operands the kernels
run: ``n_pad`` rows (the layout's, whole ``max(bin_size, 128)`` blocks)
of ``d`` rounded up to 16 lanes (the k-steps the scan issues), then the
merge to ``k_scan`` and the rescore.  The plan prices those kernels at
the passes of their exact bf16 split; ``plan.hlo_check`` divides them
out of ``kernel_dot_flops`` (``split_passes``).  A sharded index is
counted on its first shard:
the shards run at once, and the plan prices one.

>>> import torch
>>> from repro_torch.search import Index
>>> idx = Index.build(torch.randn(512, 40), k=5, backend="torch",
...                   device="cpu", cluster="off")
>>> search_cost(idx, 64).dot_flops == 2 * 64 * 512 * 40
True
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.binning import round_up
from repro_torch.core.rescoring import stable_topk
from repro_torch.kernels.ref import partial_reduce_ref
from repro_torch.search.metrics import get_metric
from repro_torch.search.stages import finalize_values, rescore_candidates

__all__ = ["OpCost", "search_cost"]

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "einsum", "dot", "mv",
         "convolution", "_scaled_dot_product_flash_attention"}


@dataclasses.dataclass(frozen=True)
class OpCost:
    """What one search's ops would do (the reference's ``HloCost``)."""

    dot_flops: float
    kernel_dot_flops: float
    hbm_bytes: float
    hbm_bytes_lo: float
    hbm_bytes_hi: float
    cop_count: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCounter(TorchDispatchMode):
    """Operand plus result bytes of each aten op that is not a view, and
    the result elements of each op that is neither a view nor a dot."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.cops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if func.overloadpacket.__name__ not in _DOTS:
                self.cops += sum(t.numel() for t in outs)
        return out


@contextlib.contextmanager
def _counted_dot_rows(tally: list):
    """Count 2·m·c·d a ``stages.dot_rows`` call into ``tally[0]``."""
    from repro_torch.search import stages

    plain = stages.dot_rows

    def dot_rows(rows, q):
        tally[0] += 2.0 * rows.shape[0] * rows.shape[1] * rows.shape[2]
        return plain(rows, q)
    stages.dot_rows = dot_rows
    try:
        yield
    finally:
        stages.dot_rows = plain


def _cuda_search(index, pk, q, flops, tally):
    """The ``"cuda"`` search of one block through the kernels' plain
    version at the kernels' operands (see the module docstring); the
    scan's FLOPs go to ``tally[1]``."""
    spec = index.spec
    d16 = round_up(pk.d, 16)
    n_pad = pk.db.shape[0]
    dev = q.device
    m_obj = get_metric(spec.metric)
    qp = m_obj.prepare_queries(q)
    qk = torch.empty((q.shape[0], d16), dtype=torch.float32, device=dev)
    rows = torch.empty((n_pad, d16), dtype=pk.db.dtype, device=dev)
    bias = torch.empty((1, n_pad), dtype=torch.float32, device=dev)
    scale = (None if pk.scale is None
             else torch.empty((1, n_pad), dtype=torch.float32, device=dev))
    before = flops.get_total_flops()
    vals, idxs = partial_reduce_ref(qk, rows.to(torch.float32), bias, scale,
                                    bin_size=pk.bin_size)
    tally[1] += flops.get_total_flops() - before
    rescore = pk.rescore_db is not None
    k_sel = index._k_scan if rescore else spec.k
    vals, sel = stable_topk(vals, min(k_sel, vals.shape[-1]))
    idxs = torch.gather(idxs, -1, sel)
    if rescore:
        vals, idxs = rescore_candidates(qp, vals, idxs, pk.rescore_db,
                                        pk.rescore_bias, spec.k,
                                        index._k_scan)
    return finalize_values(vals, m_obj.negate_output), idxs


def _first_shard_search(index, state, q):
    """A sharded index's plain search of its first shard."""
    from repro_torch.search import backends

    spec = index.spec
    m_obj = get_metric(spec.metric)
    cl = state.cluster
    vals, idxs = backends._shard_candidates(
        m_obj.prepare_queries(q), state.shards[0], 0, n=state.n, k=spec.k,
        k_scan=index._k_scan, recall_target=spec.recall_target,
        use_bitonic=spec.use_bitonic, fused_select=spec.fused_select_enabled,
        cluster=None if cl is None else (cl.operands(), cl.plan.probes,
                                         cl.plan.target_scan))
    return finalize_values(vals, m_obj.negate_output), idxs


def search_cost(index, m: int) -> OpCost:
    """Count the ops of one search of ``m`` queries on ``index`` (an
    ``repro_torch.search.Index``) without running it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    state = index.pack()
    shards = getattr(state, "shards", None)
    pk = state if shards is None else shards[0]
    counter, flops = _OpCounter(), FlopCounterMode(display=False)
    tally = [0.0, 0.0]  # dot_rows FLOPs, the kernel's FLOPs
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((m, index.dim), dtype=index.query_dtype,
                        device=pk.db.device)
        with flops, counter, _counted_dot_rows(tally):
            if pk.backend == "cuda" and state.cluster is None:
                out = _cuda_search(index, pk, q, flops, tally)
            elif shards is not None:
                out = _first_shard_search(index, state, q)
            else:
                out = index._search_ops(q)
    operands = [t for t in pk.operands() if t is not None]
    lo = (sum(map(_nbytes, operands)) + m * index.dim * q.element_size()
          + sum(_nbytes(t) for t in out))
    hi = float(counter.bytes)
    return OpCost(
        dot_flops=float(flops.get_total_flops()) + tally[0],
        kernel_dot_flops=tally[1],
        hbm_bytes=math.sqrt(lo * hi) if lo and hi else float(hi),
        hbm_bytes_lo=float(lo), hbm_bytes_hi=hi,
        cop_count=float(counter.cops),
    )
