"""Op-level cost of a torch program: the port's counterpart of
``src/repro/analysis/hlo_cost.py`` (``analyze_hlo``) and of
``src/repro/analysis/hlo.py`` (``collective_bytes``, ``op_census``:
:func:`collective_traffic`, :func:`op_census`).

The reference reads the optimized HLO of a compiled program: the dot
FLOPs, a fusion-boundary byte estimate, an element count of the other
ops, while-loop trip counts, and the collectives' wire bytes.  The port
has no compiled program to read.  :func:`program_cost` runs any callable
once under ``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and
dtypes propagate, nothing is computed or allocated (``device="meta"``
inputs, or real ones, which the mode stands in for).  Two modes count
the ops underneath:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode`` (2·M·N·K
    a matmul), the numerator of the compute roof;
  * ``hbm_bytes_hi``: operand plus result bytes of every aten op that is
    not a view (the reference's fusion-boundary model, at op
    granularity); ``hbm_bytes_lo``: the program's arguments read once
    and its results written once (perfect fusion); ``hbm_bytes``: their
    geometric mean, as the reference reports;
  * ``cop_count``: the result elements of every op that is neither a
    dot nor a view;
  * ``peak_bytes``: the arguments' bytes plus the most bytes of storages
    the program created that were alive at once (a storage lives until
    its last tensor goes, an autograd-saved one included);
  * ``trace``: one :class:`OpRecord` an aten op, which :func:`op_census`
    counts by name;
  * ``collectives``: what the port's own collective layer
    (``parallel.distributed.COLLECTIVES``) recorded in the run, calls
    and bytes by ``"op[axes]"``: a rank's program on a process mesh
    (``parallel.distributed.fake_process_mesh``), which
    :func:`collective_traffic` prices as the reference prices its HLO's
    collectives.

The port's models loop over their layers in Python, so every layer is
counted as it runs and ``while_trips`` (the reference's scan trip
counts) is empty.  A program that reads a value on the host
(``.item()``) cannot be counted, except a CPU scalar among its arguments
(a ``TrainState``'s step), which is carried in as a constant.

:func:`search_cost` counts one search of an index this way.  The
``"cuda"`` kernels are ``ctypes`` calls that the modes cannot see into,
so a ``"cuda"`` index is counted through the kernels' plain version
(``kernels.ref.partial_reduce_ref``) at the operands the kernels run:
``n_pad`` rows (the layout's, whole ``max(bin_size, 128)`` blocks) of
``d`` rounded up to 16 lanes (the k-steps the scan issues), then the
merge to ``k_scan`` and the rescore.  The fixed-order dots of
``stages.dot_rows`` (the rescore's and the pruned scan's, products and
halving adds that the counter cannot tell from other element-wise ops)
are counted as 2·m·c·d each; ``kernel_dot_flops`` is the part the CUDA
scan computes.  The plan prices those kernels at the passes of their
exact bf16 split; ``plan.hlo_check`` divides them out of
``kernel_dot_flops`` (``split_passes``).  A sharded index is counted on
its first shard: the shards run at once, and the plan prices one.

>>> import torch
>>> from repro_torch.search import Index
>>> idx = Index.build(torch.randn(512, 40), k=5, backend="torch",
...                   device="cpu", cluster="off")
>>> search_cost(idx, 64).dot_flops == 2 * 64 * 512 * 40
True
>>> program_cost(torch.mm, torch.empty(8, 4, device="meta"),
...              torch.empty(4, 2, device="meta")).dot_flops
128.0
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.binning import round_up
from repro_torch.core.rescoring import stable_topk
from repro_torch.kernels.ref import partial_reduce_ref
from repro_torch.search.metrics import get_metric
from repro_torch.search.stages import finalize_values, rescore_candidates

__all__ = ["OpCost", "OpRecord", "ProgramCost", "program_cost", "op_census",
           "collective_traffic", "search_cost"]

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


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of a program: its name (``"mm"``, ``"_to_copy"``), the
    devices of its tensor inputs in order and of its outputs, and their
    bytes."""

    op: str
    in_devices: Tuple[torch.device, ...]
    out_devices: Tuple[torch.device, ...]
    in_bytes: int
    out_bytes: int


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """What a program's ops would do (the reference's ``HloCost`` and its
    compiled memory analysis)."""

    dot_flops: float
    hbm_bytes: float        # geometric mean of the hi/lo traffic models
    hbm_bytes_lo: float     # the arguments read once, the results written once
    hbm_bytes_hi: float     # every op's operands and results
    cop_count: float
    while_trips: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    trace: Tuple[OpRecord, ...]
    # calls and bytes of the port's collectives by "op[axes]"
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The distinct tensors of a tree, a module's parameters and buffers
    included."""
    seen, out = set(), []
    for leaf in tree_leaves(tree):
        ts = ([*leaf.parameters(), *leaf.buffers()] if isinstance(leaf, nn.Module)
              else [leaf] if isinstance(leaf, torch.Tensor) else [])
        for t in ts:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


class _OpCounter(TorchDispatchMode):
    """Operand plus result bytes of each aten op that is not a view, the
    result elements of each op that is neither a view nor a dot, the
    live bytes of the storages the ops create and their peak, and the
    trace.

    A storage is live until the last tensor on it goes: autograd may keep
    one (a saved output) after every tensor the program held is gone, so
    storages are held by weak references and swept whenever the running
    total, which can only overstate, passes the peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.cops = 0
        self.live = 0
        self.peak = 0
        self.trace = []
        self._storages = {}  # StorageImpl address -> (weak ref, bytes)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._storages.items() if ref.expired()]:
            self.live -= self._storages.pop(key)[1]

    def _created(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        old = self._storages.get(key)
        if old is not None:
            if not old[0].expired():
                return  # an alias of a storage already counted
            self.live -= self._storages.pop(key)[1]
        self._storages[key] = (StorageWeakRef(storage), storage.nbytes())
        self.live += storage.nbytes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_bytes, out_bytes = sum(map(_nbytes, ins)), sum(map(_nbytes, outs))
        name = func.overloadpacket.__name__
        if not func.is_view:
            self.bytes += in_bytes + out_bytes
            if name not in _DOTS:
                self.cops += sum(t.numel() for t in outs)
            given = {t.untyped_storage()._cdata for t in ins}
            for t in outs:  # a new storage (an in-place op returns its input)
                if t.untyped_storage()._cdata not in given:
                    self._created(t)
            if self.live > self.peak:
                self._sweep()
                self.peak = max(self.peak, self.live)
        self.trace.append(OpRecord(name, tuple(t.device for t in ins),
                                   tuple(t.device for t in outs), in_bytes,
                                   out_bytes))
        return out


def program_cost(fn, *args, device=None, **kwargs) -> ProgramCost:
    """Count the ops of ``fn(*args, **kwargs)`` without running it (see the
    module docstring).  Arguments may be ``device="meta"`` tensors, real
    tensors, modules holding either, and trees of them: each is copied
    into a fake tensor first (``FakeCopyMode``; shared tensors stay
    shared), so nothing is computed, allocated or written.  With
    ``device``, a ``"meta"`` tensor argument stands for one on that
    device.  Tensors ``fn`` reaches other than through its arguments are
    converted where an op meets a fake tensor; an op that meets none runs
    on them for real."""
    from torch._subclasses.fake_tensor import FakeCopyMode, FakeTensorMode

    from repro_torch.parallel import distributed as D

    arg_bytes = sum(map(_nbytes, _tensors((args, kwargs))))
    leaves = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    # a host scalar (a TrainState's step) goes in as a constant of its value
    host = {id(t): t.item() for t in leaves
            if t.device.type == "cpu" and t.ndim == 0}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    memo = {}
    with mode:
        for t in leaves:
            if id(t) in host:
                memo[id(t)] = torch.tensor(host[id(t)], dtype=t.dtype)
            elif device is not None and t.device.type == "meta":
                memo[id(t)] = torch.empty_strided(t.shape, t.stride(),
                                                  dtype=t.dtype, device=device)
    with FakeCopyMode(mode):
        args, kwargs = copy.deepcopy((args, kwargs), memo)
    counter, flops = _OpCounter(), FlopCounterMode(display=False)
    before = D.reset_collectives()
    try:
        with mode:
            with flops, counter:
                out = fn(*args, **kwargs)
    finally:
        ran = D.reset_collectives()
        D.COLLECTIVES.update(before)
    out_bytes = sum(map(_nbytes, _tensors(out)))
    lo, hi = float(arg_bytes + out_bytes), float(counter.bytes)
    return ProgramCost(
        dot_flops=float(flops.get_total_flops()),
        hbm_bytes=math.sqrt(lo * hi) if lo and hi else max(lo, hi),
        hbm_bytes_lo=lo, hbm_bytes_hi=hi, cop_count=float(counter.cops),
        while_trips={}, argument_bytes=arg_bytes, output_bytes=out_bytes,
        peak_bytes=arg_bytes + counter.peak, trace=tuple(counter.trace),
        collectives={k: {"calls": v["calls"], "bytes": v["bytes"]}
                     for k, v in sorted(ran.items())})


def op_census(trace) -> Dict[str, int]:
    """Count each aten op of a :class:`ProgramCost` ``trace`` by name (the
    reference's census of HLO op kinds)."""
    return dict(collections.Counter(r.op for r in trace))


# the reference's kind of each of the port's collective ops, and the
# multiple of the recorded bytes (an all-reduce's result, an all-gather's
# result, a reduce-scatter's operand, a broadcast's tensor) its ring
# conventions count (src/repro/analysis/hlo.py)
_WIRE = {"all_reduce": ("all-reduce", 2), "all_gather": ("all-gather", 1),
         "reduce_scatter": ("reduce-scatter", 1),
         "broadcast": ("collective-broadcast", 1)}


def collective_traffic(collectives) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """A :class:`ProgramCost`'s ``collectives`` (calls and bytes by
    ``"op[axes]"``) as the reference reads a per-device program's
    collectives: (wire bytes in all, wire bytes by kind, calls by kind),
    the kinds ``"all-reduce"``, ``"all-gather"`` and ``"reduce-scatter"``;
    an all-reduce moves twice its result's bytes, an all-gather its
    result's, a reduce-scatter its operand's."""
    by_kind: Dict[str, float] = collections.Counter()
    calls: Dict[str, int] = collections.Counter()
    for key, entry in collectives.items():
        kind, times = _WIRE[key.split("[")[0]]
        by_kind[kind] += times * entry["bytes"]
        calls[kind] += int(entry["calls"])
    return float(sum(by_kind.values())), dict(by_kind), dict(calls)


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


def _cuda_search(index, pk, q, tally):
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
    with FlopCounterMode(display=False) as scan:
        vals, idxs = partial_reduce_ref(qk, rows.to(torch.float32), bias, scale,
                                        bin_size=pk.bin_size)
    tally[1] += scan.get_total_flops()
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
    state = index.pack()
    shards = getattr(state, "shards", None)
    pk = state if shards is None else shards[0]
    tally = [0.0, 0.0]  # dot_rows FLOPs, the kernel's FLOPs

    def search(q):
        with _counted_dot_rows(tally):
            if pk.backend == "cuda" and state.cluster is None:
                return _cuda_search(index, pk, q, tally)
            if shards is not None:
                return _first_shard_search(index, state, q)
            return index._search_ops(q)

    q = torch.empty((m, index.dim), dtype=index.query_dtype, device="meta")
    cost = program_cost(search, q, device=pk.db.device)
    operands = [t for t in pk.operands() if t is not None]
    lo = float(sum(map(_nbytes, operands)) + cost.argument_bytes
               + cost.output_bytes)
    hi = cost.hbm_bytes_hi
    return OpCost(
        dot_flops=cost.dot_flops + tally[0],
        kernel_dot_flops=tally[1],
        hbm_bytes=math.sqrt(lo * hi) if lo and hi else hi,
        hbm_bytes_lo=lo, hbm_bytes_hi=hi, cop_count=cost.cop_count,
    )
