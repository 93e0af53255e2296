"""Front ends of the fused score + PartialReduce kernels.

Port of ``src/repro/kernels/partial_reduce.py``.  Operand contract (the
reference's): a packed ``(n_pad, d_pad)`` database, a ``(1, n_pad)`` f32
bias row (metric bias, tombstones and tail mask fused), an optional
``(1, n_pad)`` f32 per-row ``scale`` and ``(m, d)`` f32 queries with
``d <= d_pad`` (or bf16 queries, the ``dtype="bfloat16"`` compute dtype,
against bf16, int8 or int4 rows); only the query block is padded here.  The database is
stored in one of four forms (``FORMS``):

  * f32 or bf16 rows, unscaled;
  * int8 codes, with ``scale``;
  * int4 codes two per byte (``int4_packed=True``: an ``(n_pad, d_pad/2)``
    int8 array, column 2j in byte j's low nibble, 2j+1 in its high
    nibble), with ``scale``.

Every form scores ``(q @ x̂ᵀ) * scale + bias`` over the rows widened to
f32 (x̂), the product and the sum rounded apart, as the reference's
``_tile_winners``.  The port's layout (``repro_torch.search.packed``)
makes ``n_pad`` a multiple of ``max(bin_size, BLOCK_N)`` and ``d_pad`` a
multiple of 128 for every form (an int4 row is then ``d_pad / 2`` bytes).

On CUDA the kernels multiply on the tensor cores in bf16: they split f32
queries exactly into three bf16 parts (:func:`split_queries` is the
plain version of that split), over the lanes the function needs, ``d``
rounded up to 16, and sum the exact products of each part with the rows
(six for f32 rows, which they split the same way).  bf16 queries are
one part already: the one-pass form of each kernel multiplies them as
they are (one tensor-core pass), the reference's bf16 x bf16 product
into f32.  The plain versions widen bf16 queries to f32, which is exact.

  * :func:`partial_reduce_packed` (two-pass, B2/B3a): every bin winner,
    ``(m, n_pad // bin_size)`` values and raw int32 global indices.
  * :func:`partial_reduce_fused` (fused, B1/B3b): the top-``k_scan`` bin
    winners per query, values descending (earlier rows first among
    ties), masked winners as ``(MASK_VALUE, -1)``; any ``k_scan``.

Each front end runs its kernel's plain PyTorch version for a tensor on
the CPU, and launches the CUDA kernel (``csrc/partial_reduce.cu``) for a
tensor on a CUDA device; any other device raises.  ``LAUNCHES`` counts
kernel launches and ``PLAIN_CALLS`` calls of the plain versions, by
name, each stored form under its own name (``partial_reduce_fused`` for
f32 rows, ``partial_reduce_fused[int8]`` for int8 ones, and
``partial_reduce_fused[bf16xint8]`` for the one-pass form, bf16 queries
against int8 rows), so a run can show which path it took.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import partial_reduce_ref
from repro_torch.search.quant import unpack_int4_rows
from repro_torch.search.telemetry import AtomicCounter

__all__ = [
    "BLOCK_M",
    "BLOCK_N",
    "FORMS",
    "LAUNCHES",
    "PLAIN_CALLS",
    "SMEM_K_SCAN",
    "fused_carry_merge",
    "fused_carry_merge_plain",
    "fused_scan",
    "kernel_name",
    "merge_cost",
    "merge_plan",
    "partial_reduce_fused",
    "partial_reduce_fused_plain",
    "partial_reduce_packed",
    "partial_reduce_packed_plain",
    "query_parts",
    "reset_counts",
    "scan_smem",
    "split_plan",
    "split_queries",
    "storage_form",
]

# Tiles and limits compiled into csrc/partial_reduce.cu (its BQ, BN,
# SMEM_K_SCAN, MAX_SPLITS); the C entry points reject arguments that
# disagree with them.  A block scans BLOCK_M queries against a split of
# the rows, cut in BLOCK_N-row units.  A fused carry of more than
# SMEM_K_SCAN entries lives in device memory instead of shared memory.
BLOCK_M = 128
BLOCK_N = 128
SMEM_K_SCAN = 32
MAX_SPLITS = 256
# The split plan's cost model, in BLOCK_N-row tiles of scan of a
# three-pass form (about 3.5 us a tile at M=16 on an H100; an f32 tile
# takes twice that), fitted to split-count sweeps at the Sift1M shape
# (scripts/bench_torch_scan.py --splits and --merge; PERF.md): a block's
# fixed cost (its queries' split into shared memory, the ring's first
# fill and last drain; 3 to 15 tiles by form), and the merge kernel's
# time (merge_cost): each of a query's k_scan outputs is a step of the
# group's reduction, dearer by _MERGE_SLOT_TILES for every 32 splits a
# lane owns, and every carry entry is staged once (at M=16 the fit is
# within 22% of the measured merge from 1 to 245 splits).
_BLOCK_COST_TILES = 8
_MERGE_STEP_TILES = 0.039
_MERGE_SLOT_TILES = 0.0127
_MERGE_ENTRY_TILES = 1.4e-6

# Stored forms of the database, in the order of the C interface's `form`.
FORMS = ("f32", "bf16", "int8", "int4")
_FORM_OF_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.int8: "int8"}
_SCALED_FORMS = ("int8", "int4")

_MASK = float(np.finfo(np.float32).min)  # stages.MASK_VALUE

LAUNCHES = AtomicCounter()
PLAIN_CALLS = AtomicCounter()


def reset_counts() -> None:
    """Zero ``LAUNCHES`` and ``PLAIN_CALLS``."""
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def storage_form(database: torch.Tensor, scale: Optional[torch.Tensor],
                 int4_packed: bool = False) -> str:
    """The stored form (one of ``FORMS``) of a database operand; raises
    where the dtype, ``int4_packed`` and ``scale`` disagree."""
    form = _FORM_OF_DTYPE.get(database.dtype)
    if form is None:
        raise ValueError(
            f"database must be float32, bfloat16 or int8, got {database.dtype}"
        )
    if int4_packed:
        if form != "int8":
            raise ValueError(
                f"int4_packed needs int8 nibble pairs, got {database.dtype}"
            )
        form = "int4"
    if (scale is not None) != (form in _SCALED_FORMS):
        raise ValueError(
            f"a per-row scale goes with int8 and int4 rows and only with "
            f"them: got {form} rows and "
            f"{'a scale' if scale is not None else 'no scale'}"
        )
    return form


def kernel_name(base: str, form: str, qparts: int = 3) -> str:
    """Counter name of a kernel for one stored form, and for the one-pass
    form (``qparts`` 1: bf16 queries).

    >>> kernel_name("partial_reduce_fused", "f32")
    'partial_reduce_fused'
    >>> kernel_name("partial_reduce_fused", "int4")
    'partial_reduce_fused[int4]'
    >>> kernel_name("partial_reduce_packed", "int8", qparts=1)
    'partial_reduce_packed[bf16xint8]'
    """
    if qparts == 1:
        return f"{base}[bf16x{form}]"
    return base if form == "f32" else f"{base}[{form}]"


def query_parts(queries: torch.Tensor, form: str) -> int:
    """The bf16 parts the kernels take ``queries`` in: 3 for f32 (the exact
    split), 1 for bf16 (the one-pass form); raises for bf16 queries
    against f32 rows (the pack never pairs them: a bf16 compute dtype
    stores bf16 rows) and for any other dtype."""
    if queries.dtype == torch.float32:
        return 3
    if queries.dtype == torch.bfloat16:
        if form == "f32":
            raise ValueError(
                "bf16 queries need bf16, int8 or int4 rows, got f32 rows "
                "(the bf16 compute dtype stores its f32 tier as bf16)"
            )
        return 1
    raise ValueError(f"queries must be float32 or bfloat16, got {queries.dtype}")


# --- plain PyTorch versions (the CPU path and the kernels' oracle) -----------


def _widen(database: torch.Tensor, int4_packed: bool) -> torch.Tensor:
    """The stored rows as f32 (int4 nibble pairs unpacked first)."""
    rows = unpack_int4_rows(database) if int4_packed else database
    return rows.to(torch.float32)


def partial_reduce_packed_plain(
    q: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None, *, bin_size: int,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the two-pass kernel over ``d_pad``-wide queries
    (f32, or bf16 widened to f32: every product is then exact)."""
    form = storage_form(database, scale, int4_packed)
    qparts = query_parts(q, form)
    PLAIN_CALLS.inc(kernel_name("partial_reduce_packed", form, qparts))
    return partial_reduce_ref(q.to(torch.float32), _widen(database, int4_packed),
                              bias, scale, bin_size=bin_size)


def partial_reduce_fused_plain(
    q: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None, *, k_scan: int, bin_size: int,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel: all bin winners, masked ones
    paired with -1, then a stable descending sort.

    The reference's carry starts as ``k_scan`` (MASK, -1) entries that
    precede the winners; appending them instead is the same result,
    because a winner that ties them at MASK is itself (MASK, -1).
    """
    form = storage_form(database, scale, int4_packed)
    qparts = query_parts(q, form)
    PLAIN_CALLS.inc(kernel_name("partial_reduce_fused", form, qparts))
    vals, idxs = partial_reduce_ref(q.to(torch.float32),
                                    _widen(database, int4_packed), bias,
                                    scale, bin_size=bin_size)
    idxs = torch.where(vals > _MASK * 0.5, idxs, torch.full_like(idxs, -1))
    m = q.shape[0]
    vals = torch.cat([vals, vals.new_full((m, k_scan), _MASK)], dim=1)
    idxs = torch.cat([idxs, idxs.new_full((m, k_scan), -1)], dim=1)
    top, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return top[:, :k_scan], torch.gather(idxs, 1, pos[:, :k_scan])


def split_queries(q: torch.Tensor) -> torch.Tensor:
    """The exact three-way bf16 split of f32 queries, ``(3, m, d)`` bf16
    with ``q == p[0] + p[1] + p[2]`` (each part the bf16 rounding of what
    the earlier ones leave; every residual is exact in f32, and the last
    fits bf16's 8 significant bits while the parts stay normal: for 0 and
    for 2^-100 <= |q| <= 2^127, well past any query a metric prepares).
    The CUDA kernels split their queries so in their prologue: a part
    times a stored bf16, int8 or int4 value is exact in f32.

    >>> q = torch.tensor([[1 / 3, -1e-20, 3.0e7]])
    >>> p = split_queries(q)
    >>> p.dtype, bool((p.double().sum(0) == q.double()).all())
    (torch.bfloat16, True)
    """
    parts = []
    rest = q.to(torch.float32)
    for _ in range(3):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest = rest - part.to(torch.float32)
    return torch.stack(parts)


# --- front ends ---------------------------------------------------------------


def _front(queries, database, bias, scale, bin_size, int4_packed):
    """Check the operand contract; return the queries padded to d_pad and
    the stored form (f32 queries, or bf16 ones against bf16, int8 or
    int4 rows: :func:`query_parts`)."""
    if queries.ndim != 2 or database.ndim != 2:
        raise ValueError(
            f"queries and database must be 2-D, got {tuple(queries.shape)} "
            f"and {tuple(database.shape)}"
        )
    form = storage_form(database, scale, int4_packed)
    n_pad = database.shape[0]
    d_pad = database.shape[1] * (2 if int4_packed else 1)
    if queries.shape[1] > d_pad:
        raise ValueError(f"query dim {queries.shape[1]} exceeds packed dim {d_pad}")
    rowwise = (("bias", bias),) + ((("scale", scale),) if scale is not None else ())
    for name, t in rowwise:
        if tuple(t.shape) != (1, n_pad):
            raise ValueError(f"{name} must be (1, {n_pad}), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    query_parts(queries, form)  # f32, or bf16 against bf16/int8/int4 rows
    for name, t in (("queries", queries),) + rowwise:
        if t.device != database.device:
            raise ValueError(
                f"{name} on {t.device}, database on {database.device}"
            )
    if bin_size <= 0 or bin_size & (bin_size - 1) or n_pad % bin_size:
        raise ValueError(
            f"bin_size={bin_size} must be a power of two dividing n_pad={n_pad}"
        )
    if queries.shape[1] < d_pad:  # F.pad copies even when it pads nothing
        queries = F.pad(queries, (0, d_pad - queries.shape[1]))
    return queries, form


def _cuda_operands(q, database, bias, scale, bin_size, width, int4_packed):
    """Contiguity, alignment and tiling checks of the CUDA kernels; ``q``
    is already ``d_pad`` wide, and the function needs its first ``width``
    lanes.  Returns the checked operands and the k-steps of 16 lanes that
    cover ``width`` (the kernels split the queries in their prologue, as
    :func:`split_queries` does)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"partial_reduce kernels run on CPU or CUDA tensors, got {q.device}"
        )
    q, database, bias = q.contiguous(), database.contiguous(), bias.contiguous()
    if scale is not None:
        scale = scale.contiguous()
    n_pad, d_pad = database.shape[0], q.shape[1]
    if d_pad % (32 if int4_packed else 16) or n_pad % max(bin_size, BLOCK_N):
        raise ValueError(
            f"CUDA tiling contract: d_pad={d_pad} must be a multiple of "
            f"{32 if int4_packed else 16} and n_pad={n_pad} of "
            f"max(bin_size={bin_size}, {BLOCK_N})"
        )
    if n_pad >= 2**31:
        raise ValueError(f"n_pad={n_pad} overflows the int32 row indices")
    if not 0 < width <= d_pad:
        raise ValueError(f"width={width} must be in 1..d_pad={d_pad}")
    for t in (q, database):
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    return q, -(-width // 16), database, bias, scale


def merge_cost(m: int, splits: int, k_scan: int) -> float:
    """The split plan's estimate of the carry merge's time for ``m``
    queries, in BLOCK_N-row tiles of scan; 0 without a carry
    (``k_scan`` 0).  Non-decreasing in ``splits``, so a carry never makes
    the plan take more splits than no carry does."""
    if not k_scan:
        return 0.0
    step = _MERGE_STEP_TILES + _MERGE_SLOT_TILES * -(-splits // 32)
    return k_scan * step + _MERGE_ENTRY_TILES * m * splits * k_scan


@functools.lru_cache(maxsize=256)
def split_plan(m: int, n_pad: int, bin_size: int, num_sms: int,
               k_scan: int = 0) -> Tuple[int, int]:
    """(tiles_per_split, splits): cut the row range into bin-aligned
    splits for ceil(m / BLOCK_M) * splits blocks, one at a time on each of
    ``num_sms`` SMs, whose carries of ``k_scan`` entries (0: the two-pass
    kernel, nothing to merge) the merge kernel folds.  Of the cuts, the
    one with the least time in BLOCK_N-row tiles of scan: waves x (the
    tiles of one block + a block's fixed cost), plus :func:`merge_cost`;
    fewer splits on a tie.

    >>> split_plan(10_000, 1_003_520, 4096, 132, 10)   # Sift1M f32
    (1568, 5)
    >>> split_plan(16, 1_003_520, 4096, 132, 10)
    (64, 123)
    >>> split_plan(16, 1_000_448, 1024, 132, 30)       # Sift1M int4
    (64, 123)
    """
    tiles_per_bin = max(1, bin_size // BLOCK_N)
    groups = n_pad // BLOCK_N // tiles_per_bin
    q_tiles = -(-m // BLOCK_M)
    best = None
    for want in range(1, min(groups, MAX_SPLITS) + 1):
        per = -(-groups // want)
        splits = -(-groups // per)
        waves = -(-q_tiles * splits // num_sms)
        cost = (waves * (per * tiles_per_bin + _BLOCK_COST_TILES)
                + merge_cost(m, splits, k_scan))
        if best is None or cost < best[0]:
            best = (cost, per * tiles_per_bin, splits)
    return best[1], best[2]


def scan_smem(form: str, fused: bool, width: int, k_scan: int = 0,
              qparts: int = 3) -> dict:
    """The shared-memory plan of one scan launch on the current CUDA
    device, for ``width`` query lanes in ``qparts`` bf16 parts (1: the
    one-pass form): its dynamic ``bytes``, the depth of its row-stage
    ring (``stages``) and whether the queries' parts stay ``resident``
    for the whole row range."""
    lib = build.load_library()
    stages, resident = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.pr_scan_plan(FORMS.index(form), qparts, int(fused),
                            -(-width // 16), k_scan, ctypes.byref(stages),
                            ctypes.byref(resident))
    if code < 0:
        raise ValueError(f"no scan plan for {form}, width={width}, "
                         f"k_scan={k_scan}, qparts={qparts} ({code})")
    return dict(bytes=code, stages=stages.value, resident=bool(resident.value))


def merge_plan(splits: int, k_scan: int) -> dict:
    """The carry merge's launch plan on the current CUDA device: the
    ``lanes`` of a query's group, the splits each lane owns at most
    (``per_lane``), the ``warps`` of a block, and the bytes of carries a
    block stages in shared memory (``staged_bytes``; 0: the heads are read
    from device memory, where the carries do not fit)."""
    lib = build.load_library()
    lanes, per_lane, warps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    code = lib.pr_merge_plan(splits, k_scan, ctypes.byref(lanes),
                             ctypes.byref(per_lane), ctypes.byref(warps))
    if code < 0:
        raise ValueError(f"no merge plan for {splits} splits of k_scan={k_scan}")
    return dict(lanes=lanes.value, per_lane=per_lane.value, warps=warps.value,
                staged_bytes=code)


def _launch_setup(q):
    lib = build.load_library()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return lib, sms, torch.cuda.current_stream(q.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def partial_reduce_packed(
    queries: torch.Tensor,
    database: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    bin_size: int,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass bin winners: (m, n_pad // bin_size) values + int32 indices
    (raw: masked bins keep their own first index; the caller applies
    ``stages.sentinelize_masked``)."""
    q, form = _front(queries, database, bias, scale, bin_size, int4_packed)
    if q.device.type == "cpu":
        return partial_reduce_packed_plain(q, database, bias, scale,
                                           bin_size=bin_size,
                                           int4_packed=int4_packed)
    qparts = query_parts(q, form)
    m, d_pad = q.shape
    q, nks, database, bias, scale = _cuda_operands(
        q, database, bias, scale, bin_size, queries.shape[1], int4_packed)
    n_pad = database.shape[0]
    out_v = torch.empty((m, n_pad // bin_size), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, n_pad // bin_size), dtype=torch.int32, device=q.device)
    if m == 0:
        return out_v, out_i
    with torch.cuda.device(q.device):
        lib, sms, stream = _launch_setup(q)
        tps, splits = split_plan(m, n_pad, bin_size, sms)
        code = lib.pr_two_pass(
            FORMS.index(form), qparts, q.data_ptr(), database.data_ptr(),
            _ptr(scale), bias.data_ptr(), m, nks, d_pad, n_pad,
            int(math.log2(bin_size)), tps, splits, out_v.data_ptr(),
            out_i.data_ptr(), stream,
        )
        name = kernel_name("partial_reduce_packed", form, qparts)
        build.check(lib, code, f"{name} kernel")
        LAUNCHES.inc(name)
    return out_v, out_i


def partial_reduce_fused(
    queries: torch.Tensor,
    database: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    k_scan: int,
    bin_size: int,
    int4_packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass scan→select: (m, k_scan) values sorted descending and
    int32 indices; masked entries are (MASK_VALUE, -1).

    On CUDA this is two launches, :func:`fused_scan` then
    :func:`fused_carry_merge`.
    """
    if k_scan <= 0:
        raise ValueError(f"k_scan must be positive, got {k_scan}")
    q, _ = _front(queries, database, bias, scale, bin_size, int4_packed)
    if q.device.type == "cpu":
        return partial_reduce_fused_plain(
            q, database, bias, scale, k_scan=k_scan, bin_size=bin_size,
            int4_packed=int4_packed,
        )
    return fused_carry_merge(*fused_scan(
        q, database, bias, scale, k_scan=k_scan, bin_size=bin_size,
        int4_packed=int4_packed, width=queries.shape[1],
    ))


def fused_scan(
    q: torch.Tensor, database: torch.Tensor, bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None, *, k_scan: int, bin_size: int,
    int4_packed: bool = False, width: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused form's scan kernel on CUDA operands (queries already
    ``d_pad`` wide, of which the first ``width`` lanes are the queries';
    default all): each split of the row range keeps its own
    top-``k_scan`` carry.  Returns the carries, (splits, m, k_scan) values
    and int32 indices."""
    if k_scan <= 0:
        raise ValueError(f"k_scan must be positive, got {k_scan}")
    form = storage_form(database, scale, int4_packed)
    qparts = query_parts(q, form)
    m, d_pad = q.shape
    q, nks, database, bias, scale = _cuda_operands(
        q, database, bias, scale, bin_size, width or d_pad, int4_packed)
    n_pad = database.shape[0]
    with torch.cuda.device(q.device):
        lib, sms, stream = _launch_setup(q)
        tps, splits = split_plan(max(m, 1), n_pad, bin_size, sms, k_scan)
        part_v = torch.empty((splits, m, k_scan), dtype=torch.float32, device=q.device)
        part_i = torch.empty((splits, m, k_scan), dtype=torch.int32, device=q.device)
        if m == 0:
            return part_v, part_i
        code = lib.pr_fused_scan(
            FORMS.index(form), qparts, q.data_ptr(), database.data_ptr(),
            _ptr(scale), bias.data_ptr(), m, nks, d_pad, n_pad,
            int(math.log2(bin_size)), k_scan, tps, splits, part_v.data_ptr(),
            part_i.data_ptr(), stream,
        )
        name = kernel_name("partial_reduce_fused", form, qparts)
        build.check(lib, code, f"{name} kernel")
        LAUNCHES.inc(name)
    return part_v, part_i


def fused_carry_merge_plain(
    part_v: torch.Tensor, part_i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the carry merge: a stable descending sort of the
    splits' carries laid end to end (split order is row order)."""
    PLAIN_CALLS.inc("fused_carry_merge")
    splits, m, k_scan = part_v.shape
    vals = part_v.permute(1, 0, 2).reshape(m, splits * k_scan)
    idxs = part_i.permute(1, 0, 2).reshape(m, splits * k_scan)
    top, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return top[:, :k_scan], torch.gather(idxs, 1, pos[:, :k_scan])


def fused_carry_merge(
    part_v: torch.Tensor, part_i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused form's second kernel: merge (splits, m, k_scan) sorted
    carries into the (m, k_scan) result; among equal values (-0.0 and
    +0.0 too) the lower split wins, as in :func:`fused_carry_merge_plain`,
    bit for bit.  One kernel for every stored form (:func:`merge_plan`)."""
    if part_v.ndim != 3 or part_v.shape != part_i.shape:
        raise ValueError(
            f"carries must be two (splits, m, k_scan) tensors, got "
            f"{tuple(part_v.shape)} and {tuple(part_i.shape)}"
        )
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise ValueError("carries must be float32 values and int32 indices")
    if part_v.device.type == "cpu":
        return fused_carry_merge_plain(part_v, part_i)
    if part_v.device.type != "cuda" or part_i.device != part_v.device:
        raise ValueError(f"carries on {part_v.device} and {part_i.device}")
    splits, m, k_scan = part_v.shape
    if not 0 < splits <= MAX_SPLITS or k_scan <= 0:
        raise ValueError(
            f"{splits} splits of k_scan={k_scan}: the merge kernel takes "
            f"1..{MAX_SPLITS} splits and k_scan >= 1"
        )
    part_v, part_i = part_v.contiguous(), part_i.contiguous()
    out_v = torch.empty((m, k_scan), dtype=torch.float32, device=part_v.device)
    out_i = torch.empty((m, k_scan), dtype=torch.int32, device=part_v.device)
    if m == 0:
        return out_v, out_i
    with torch.cuda.device(part_v.device):
        lib = build.load_library()
        code = lib.pr_merge(
            part_v.data_ptr(), part_i.data_ptr(), m, k_scan, splits,
            out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(part_v.device).cuda_stream,
        )
        build.check(lib, code, "fused_carry_merge kernel")
        LAUNCHES.inc("fused_carry_merge")
    return out_v, out_i
