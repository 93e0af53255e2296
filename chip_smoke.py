#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  The phases
run in order and the first failure exits non-zero:

  1. the card and toolchain lines;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel, in each stored form (f32, bf16, int8, int4), against
     its plain PyTorch version, at the small test shapes and at the
     Sift1M shape (512 queries, full N, 10% tombstones); the fused
     kernel at k_scan 129 and 512 (its carry in device memory); and the
     merge kernel, bit for bit, on carries dense in ties (both zeros,
     masked tails) over a grid of splits x k_scan x M that runs both of
     its paths;
  4. the f32 main path at the Sift1M shape (N=1,000,000, D=128, l2, k=10,
     recall target 0.95, 10,000 queries): ``Index.build`` -> ``search``
     -> recall against an exact oracle -> ``add`` 10,000 rows ->
     ``delete`` 50,000 ids -> ``search`` again, and the two-pass path
     (``fused_select=False``) against the fused one;
  5. the same at the Glove1.2M shape (N=1,183,514, D=100, cosine), with
     fewer queries after the updates;
  6. the quantized main path: phase 4 once per storage tier (bf16, int8,
     int4) at the Sift1M shape, and int4 at the Glove1.2M shape (2,000
     queries after the updates), each also checking that the returned
     values are the exact scores of the returned ids (the rescore ran);
  7. launch counts, read after each path (every kernel of the path
     launched, no plain version called; 2 launches a fused search, 1 a
     two-pass one); then each kernel against its plain version at the
     main paths' own shapes (all 10,000 queries);
  8. CUDA-event timings at the Sift1M shape, f32 and each tier, of both
     scan kernels at M=10,000 and M=16 beside their bounds (tensor
     cores, bytes, the instructions a score the function needs; beside
     them the kernel's own epilogue count and the f32 FFMA bound of the
     earlier kernel) and their earlier times, each tier's stored bytes
     per row, the fused kernel at k_scan 32 (carry in shared memory), 33
     and 512 (in device memory), and the launches of one search; and per
     tier at M=10,000 and M=16 (and int4 at k=20) the merge at the split
     count the plan chose, checked bit for bit, beside its byte bound, an
     empty kernel's launch and ``torch.topk`` over the same carries (device
     times of calls queued back to back);
  9. the planner and the bitonic network: ``detect_device()`` must name
     the ``"h100"`` profile; each Sift1M tier's model plan (and Glove1.2M
     f32's) must have PERF.md's bins, and ``explain(measure=True)`` at
     M=10,000 and M=16 prints the predicted bound, its wall and the
     measured search (a prediction within 1% of phase 8's tensor bound
     at M=10,000 and byte bound at M=16, and no search faster than 0.95
     x its prediction); ``plan="measure"`` at the Sift1M shape (f32,
     int4) prints each candidate's time and the winner, a second build
     on the same cache must time nothing and give the same plan, and its
     search passes phase 4's recall check; ``exact_rescoring`` with the
     bitonic network on 10,000 x 60 candidates against the stable sort,
     and an int8 search with ``use_bitonic=True`` against the default
     one, both timed; an int4 index of 12 rows grown by 100 without
     growth must take ``k_scan`` 30 and search as the same index on the
     CPU.  Its searches are one more path whose launches are counted;
 10. the one-pass forms (bf16 queries, ``dtype="bfloat16"``): each of the
     six one-pass instantiations against its plain version at the small
     test shapes and on 512 queries at the Sift1M shape, and bit for bit
     on integer-valued inputs; then ``dtype="bfloat16"`` indexes at the
     Sift1M shape (storage f32, int8, int4) searched at M=10,000 and
     M=16, recall against an exact oracle in the compute dtype (the
     bf16-cast rows, prepared as the index prepares them) at E[recall] -
     eps, the launch counts of the path (the one-pass kernels, no plain
     version), and the kernels' and searches' times beside the tensor,
     score-operation and byte bounds of one pass (and the kernel's own
     epilogue count);
 11. clusters on Gaussian data (C3): ``Index.build(db)`` at the Sift1M
     shape (``cluster="auto"``, the default) timed beside
     ``cluster="off"``: the crossover enables pruning, the ``"h100"``
     profile must veto it (both predicted times printed), the build must
     run no k-means, and the search must be bit-identical to
     ``cluster="off"``;
 12. clusters on a mixture corpus (the Sift1M shape drawn as
     ``tests/test_cluster.py`` draws its corpora: 64 components, centers
     N(0, 1) x 2.5, unit noise, queries from the same centers): the plan
     must be C=1024, R=1224, 32 probes, a spill block of 15,632; the
     build's seconds (k-means, the host assignment loop, the miss check)
     and its sampled miss rate; recall at E[recall] - eps (the collision
     x miss product) for f32 and int8, before and after an add of 10,000
     rows and a delete of 50,000; the pruned search timed at M=10,000 and
     M=16 beside the same corpus with ``cluster="off"``, the ``"h100"``
     profile's prediction of each and the peak device memory.  The indexes
     are built with ``profile="a100"``, which keeps the reference's
     decision (the card's own profile vetoes the pruned scan).  The pruned
     scan is plain PyTorch (the reference has no Pallas kernel there), so
     its path must launch no kernel and call no plain version;
 13. serving at the Sift1M shape, for the f32 tier, int8 and f32 at bf16
     compute: ``SearchServer(index, warmup=True)`` captures one CUDA graph
     per bucket (the ladder, the captures and each bucket's warm-up and
     capture seconds printed; each graph must hold the path's scan and
     merge once and no plain version); a seeded stream of 200 requests of
     1-64 rows, each with its own k, on a virtual clock, every ticket
     bit-equal to a direct ``Index.search`` of its rows and every batch a
     graph replay; at M=16 an eager call, a replay with its host round
     trip, a served request from submit to result and the card's queued
     time; a transient fault at ``serve.dispatch`` retried to the clean
     result; then four threads sending 2,000 requests on the wall clock,
     with an add of 10,000 rows (growth: recapture) and a delete of 50,000
     under ``server.mutation()`` midway: QPS, occupancy, p50 and p99,
     replays against batches, recaptures, and every request after the
     mutation bit-equal to a direct search;
 14. snapshots: a card index (f32 and int8, with and without cluster
     tables) saved and restored on the card, searching bit for bit the
     same with no build work at restore, and an index written on the CPU
     restored on the card.

The build step prints, per kernel, ptxas's registers, spills and shared
memory, and the tensor-core (HGMMA) instructions in its SASS; a scan
instantiation without any, a scan or merge instantiation with a stack
frame or a spill, or a build without the six one-pass scan
instantiations fails the run.

It prints the ``kernels`` JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Data is random from
``--seed``; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): bf16 dense on the tensor cores (the
# scan's split products), f32 outside them (the earlier FFMA scan, kept as
# a column), HBM3, and CUDA-core instructions: 132 SMs x 4 schedulers x
# 32 lanes at the 1,980 MHz boost clock.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_INSTR = 132 * 4 * 32 * 1.98e9
# CUDA-core instructions per score that the scan's function needs,
# whatever the kernel: one add of the bias (one FFMA with the scale where
# there is one), then one compare and two selects (value and index) to
# keep the bin's winner.  This is the operations part of the bound.
SCORE_INSTR = 4
# Epilogue instructions per score of this kernel on the main paths (bins
# of 16 rows and more), counted from csrc/partial_reduce.cu: 1 add of the
# bias (and 1 multiply by the scale), 1.5 to pick the better of each
# thread's two rows, then 3 shuffle levels of 8 (two shuffles, three
# compares, two selects and a predicate) over half the scores.  The
# butterfly follows from the wgmma accumulator's layout, a choice of the
# kernel, so this count is printed beside the bound, never part of it.
EPILOGUE_INSTR = {"f32": 14.5, "bf16": 14.5, "int8": 15.5, "int4": 15.5}
# Tensor-core passes of the split product: three query parts against the
# stored rows, six products for f32 rows (split in three as well); one
# for bf16 queries (the one-pass forms).
PASSES = {"f32": 6, "bf16": 3, "int8": 3, "int4": 3}
ONE_PASS_FORMS = ("bf16", "int8", "int4")
# The scan kernels' times with the earlier FFMA main loop (Sift1M shape,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): (fused, two-pass) at
# M=10,000, and the fused one at M=16 (two-pass not timed there then).
FFMA_KERNEL_MS = {"f32": (86.228, 84.481, 1.963), "bf16": (82.944, 85.268, 1.784),
           "int8": (89.454, 82.503, 2.097), "int4": (167.508, 152.351, 3.771)}
DELTA = 1e-6  # Hoeffding false-failure budget of the recall checks

SIFT = dict(name="sift1m", n=1_000_000, d=128, metric="l2", m=10_000)
GLOVE = dict(name="glove1.2m", n=1_183_514, d=100, metric="cosine", m=10_000)
K, TARGET = 10, 0.95
TIERS = ("bf16", "int8", "int4")
FORMS = ("f32",) + TIERS
SRC = "src/repro_torch/kernels/csrc/partial_reduce.cu"
REF = "src/repro/kernels/partial_reduce.py"
# The Pallas body each (kernel, form) replaces: f32 as listed since the
# first slice (the entry points), bf16 the unscaled bodies, int8 and int4
# the scaled ones.
REPLACES = {
    ("partial_reduce_fused", "f32"): f"{REF}:417",
    ("partial_reduce_packed", "f32"): f"{REF}:352",
    ("partial_reduce_fused", "bf16"): f"{REF}:316",
    ("partial_reduce_packed", "bf16"): f"{REF}:285",
    ("partial_reduce_fused", "int8"): f"{REF}:323",
    ("partial_reduce_packed", "int8"): f"{REF}:300",
    ("partial_reduce_fused", "int4"): f"{REF}:323",
    ("partial_reduce_packed", "int4"): f"{REF}:300",
}


def log(*parts):
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hoeffding_eps(n: int) -> float:
    return math.sqrt(math.log(1.0 / DELTA) / (2.0 * n))


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def queued_ms(fn, reps: int = 50) -> float:
    """Device time per call of ``fn()``: ``reps`` calls queued behind a
    sleep kernel, so the card runs them back to back (one call between two
    events would time the host's Python as well, which is longer than a
    kernel of a few microseconds); the median of three such runs, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # holds the stream while the host queues
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def scan_bounds(form: str, m: int, n_pad: int, d: int, nbytes: float,
                passes=None) -> dict:
    """The scan's bound, the largest of its tensor-core passes over the
    lanes the loop covers (d rounded up to 16; ``passes`` default the
    split's, 1 for bf16 queries), the bytes it must move and the
    CUDA-core instructions per score its function needs, each printed;
    beside it, not part of it, this kernel's own epilogue instructions
    per score (``epilogue_ms``), and the FFMA bound of the earlier kernel
    (f32 operations over d rounded up to 128, or the bytes)."""
    d16, d128 = -(-d // 16) * 16, -(-d // 128) * 128
    passes = PASSES[form] if passes is None else passes
    parts = {
        "tensor_ms": 1e3 * passes * 2.0 * m * n_pad * d16 / PEAK_BF16_FLOPS,
        "bytes_ms": 1e3 * nbytes / PEAK_HBM_BYTES,
        "score_ops_ms": 1e3 * SCORE_INSTR * m * n_pad / PEAK_INSTR,
    }
    top = max(parts, key=parts.get)
    return dict(bound_ms=parts[top],
                bound_by="bytes" if top == "bytes_ms" else "operations",
                bound_parts=parts,
                epilogue_ms=1e3 * EPILOGUE_INSTR[form] * m * n_pad / PEAK_INSTR,
                ffma_bound_ms=bound_ms(2.0 * m * n_pad * d128, nbytes)[0])


def kernel_label(mangled: str) -> str:
    """``pr_scan_kernel<fused, form, query parts>`` or
    ``pr_merge_kernel<lanes, per_lane, staged>`` from a mangled kernel
    name."""
    merge = re.search(r"pr_merge_kernelILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if merge:
        lanes, per_lane, staged = merge.groups()
        return (f"pr_merge_kernel<{lanes}, {per_lane}, "
                f"{'staged' if staged == '1' else 'global'}>")
    found = re.search(r"(pr_[a-z_]*kernel)(?:ILb([01])E(?:Li(\d)E)?(?:Li(\d)E)?E)?",
                      mangled)
    if not found:
        return mangled
    name, fused, form, parts = found.groups()
    args = [{"0": "two-pass", "1": "fused"}[fused]] if fused else []
    args += [FORMS[int(form)]] if form else []
    args += [f"{parts} query part{'s' if parts != '1' else ''}"] if parts else []
    return f"{name}<{', '.join(args)}>" if args else name


def names_of(form: str, qparts: int = 3):
    """Counter names of the kernels of one stored form (``qparts`` 1: the
    one-pass forms, bf16 queries)."""
    from repro_torch.kernels.partial_reduce import kernel_name

    return (kernel_name("partial_reduce_fused", form, qparts), "fused_carry_merge",
            kernel_name("partial_reduce_packed", form, qparts))


def exact_topk(metric, q, rows, live, k, chunk=1000):
    """Exact oracle: chunked f32 matmul + topk over the live rows."""
    from repro_torch.search import half_norms, l2_normalize

    if metric == "cosine":
        q, rows = l2_normalize(q), l2_normalize(rows)
    bias = torch.where(live, 0.0, float("-inf"))
    if metric == "l2":
        bias = bias - half_norms(rows)
    out = []
    for s in range(0, q.shape[0], chunk):
        scores = q[s : s + chunk] @ rows.T + bias
        out.append(torch.topk(scores, k, dim=1).indices)
    return torch.cat(out)


def exact_values(metric, q, rows, idx):
    """float64 public values (the metric's value contract) of the rows
    ``idx`` (m, k) for each query: what a rescored search returns."""
    x, qq = rows[idx.long().clamp_min(0)].double(), q.double()
    if metric == "cosine":
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        qq = qq / qq.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    dots = (x @ qq[:, :, None])[..., 0]
    return 0.5 * (x * x).sum(-1) - dots if metric == "l2" else dots


def recall(approx: torch.Tensor, truth: torch.Tensor) -> float:
    a, t = approx.long(), truth.long()
    hits = (a[:, :, None] == t[:, None, :]).any(dim=2).sum(dim=1)
    return float(hits.float().mean()) / t.shape[1]


def card_lines() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"nvcc: {nvcc}, SMs: {props.multi_processor_count}")
    return smi


def widened_rows(db, scale, int4_packed):
    """A packed database's stored rows as f32, scale applied: what the
    kernels score against, for the tie-tolerant scorer."""
    from repro_torch.search import dequantize_rows, unpack_int4_rows

    rows = unpack_int4_rows(db) if int4_packed else db
    return dequantize_rows(rows, None if scale is None else scale[0])


def compare_kernels(prk, testing, label, q, db, bias, bs, ks, acc, *,
                    scale=None, int4_packed=False, chunk=512):
    """Each kernel against its plain version on one set of operands, on
    the card.  The plain versions run ``chunk`` queries at a time to
    bound their (chunk, n_pad) score tile; ``acc`` gathers the largest
    difference and the index agreement of each kernel."""
    from repro_torch.search import pad_queries_to

    form = prk.storage_form(db, scale, int4_packed)
    fused, merge, packed = names_of(form, prk.query_parts(q, form))
    widened = widened_rows(db, scale, int4_packed)
    qp = pad_queries_to(q, widened.shape[1]).contiguous()
    score = testing.bias_scorer(q, widened, bias)
    kw = dict(bin_size=bs, int4_packed=int4_packed)
    v, i = prk.partial_reduce_packed(q, db, bias, scale, **kw)
    carries = prk.fused_scan(qp, db, bias, scale, k_scan=ks, **kw)
    fv, fi = prk.fused_carry_merge(*carries)
    torch.cuda.synchronize()
    plain_packed, plain_fused = [], []
    for s in range(0, qp.shape[0], chunk):
        plain_packed.append(prk.partial_reduce_packed_plain(
            qp[s : s + chunk], db, bias, scale, **kw))
        plain_fused.append(prk.partial_reduce_fused_plain(
            qp[s : s + chunk], db, bias, scale, k_scan=ks, **kw))
    pv, pi = (torch.cat(t) for t in zip(*plain_packed))
    pfv, pfi = (torch.cat(t) for t in zip(*plain_fused))
    mv, mi = prk.fused_carry_merge_plain(*carries)
    testing.assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(),
                                     bin_size=bs, score=score)
    testing.assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(),
                              score=score)
    if not (testing.bits_equal(mv, fv) and torch.equal(mi, fi)):
        fail(f"{label}: fused_carry_merge differs from its plain version")
    for kernel, a, b, x, y in ((packed, i, pi, v, pv), (fused, fi, pfi, fv, pfv),
                               (merge, fi, mi, fv, mv)):
        acc["agree"][kernel] += int((a == b).sum())
        acc["total"][kernel] += a.numel()
        acc["errs"][kernel] = max(acc["errs"][kernel], float((x - y).abs().max()))
    log(f"kernels vs plain [{label}, {fused}]: m={q.shape[0]} n_pad={db.shape[0]} "
        f"bin={bs} k_scan={ks} splits={carries[0].shape[0]}: ok (max |diff| "
        f"packed {float((v - pv).abs().max()):.3g}, fused "
        f"{float((fv - pfv).abs().max()):.3g})")


# Bins and k_scan that plan_bins gives the Sift1M shape per tier (the
# main path's own; k_scan = quant.scan_k).
SIFT_PLAN = {"f32": (4096, K), "bf16": (2048, 15), "int8": (2048, 20),
             "int4": (1024, 30)}
# Each index's plan as PERF.md section 4 lists it (k_scan, bins, rows a
# bin, E[recall] to 4 places): the reference's plan_bins.
PLAN_TABLE = {("sift1m", "f32"): (10, 245, 4096, 0.9639),
              ("sift1m", "bf16"): (15, 489, 2048, 0.9717),
              ("sift1m", "int8"): (20, 489, 2048, 0.9619),
              ("sift1m", "int4"): (30, 977, 1024, 0.9707),
              ("glove1.2m", "f32"): (10, 289, 4096, 0.9693)}
# k_scan of the fused kernel's carry-placement timings: the largest in
# shared memory (SMEM_K_SCAN), the smallest in device memory, and a large
# one.
KSCAN_TIMED = (32, 33, 512)


def phase_kernels(prk, testing, seed, acc):
    """Phase 3: every kernel in every stored form against its plain
    version at the small test shapes and on 512 queries at the Sift1M
    shape; then the fused kernel at k_scan 129 and 512."""
    cases = dict(testing.KERNEL_CASES)
    cases["sift1m_512"] = dict(m=512, n=SIFT["n"], d=SIFT["d"], bin_size=4096,
                               k_scan=K, dead=0.1, l2=True)
    for name, case in cases.items():
        q, db, bias = testing.packed_operands(**case, seed=seed, device="cuda")
        for form in FORMS:
            bs, ks = case["bin_size"], case["k_scan"]
            if name == "sift1m_512":
                bs, ks = SIFT_PLAN[form]
            stored, scale, packed, _ = testing.stored_operands(db, form)
            compare_kernels(prk, testing, name, q, stored, bias, bs, ks, acc,
                            scale=scale, int4_packed=packed)
            del stored, scale
        if name == "sift1m_512":  # the carry in device memory
            for ks in (129, 512):
                compare_kernels(prk, testing, f"{name} k_scan={ks}", q, db,
                                bias, 256, ks, acc)
        del q, db, bias


# The merge kernel's grid on carries dense in ties (tests/test_torch_cuda.py
# test_merge_bit_equal): group widths of 8, 16 and 32 lanes, 1 to 8 splits
# a lane, carries staged in shared memory and read from device memory.
MERGE_SPLITS = (1, 2, 5, 31, 32, 33, 82, 123, 256)
MERGE_K_SCAN = (1, 10, 30, 32, 33, 129, 512)
MERGE_M = (1, 16, 129, 1000)


def merge_equal(prk, testing, carries, label):
    """The merge kernel against its plain version on ``carries``, bit for
    bit; fails the run on any difference."""
    v, i = prk.fused_carry_merge(*carries)
    pv, pi = prk.fused_carry_merge_plain(*carries)
    if not (testing.bits_equal(v, pv) and torch.equal(i, pi)):
        fail(f"{label}: fused_carry_merge differs from its plain version")


def phase_merge_ties(prk, testing, seed):
    """Phase 3, the merge: bit for bit on the tie-heavy grid, which must
    run both of its paths (carries staged in shared memory, and not)."""
    paths = set()
    for splits in MERGE_SPLITS:
        for k_scan in MERGE_K_SCAN:
            paths.add(prk.merge_plan(splits, k_scan)["staged_bytes"] > 0)
            for m in MERGE_M:
                carries = testing.tied_carries(splits, m, k_scan,
                                               seed=seed + splits * 1000 + k_scan,
                                               device="cuda")
                merge_equal(prk, testing, carries,
                            f"tied carries splits={splits} k_scan={k_scan} m={m}")
                del carries
    if paths != {True, False}:
        fail(f"the merge grid ran only staged={paths}")
    log(f"merge vs plain on tied carries: splits {MERGE_SPLITS} x k_scan "
        f"{MERGE_K_SCAN} x m {MERGE_M}, both paths: bit-equal")


def make_data(cfg, seed):
    """The random database, queries, appended rows and deleted ids of one
    shape, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d = cfg["n"], cfg["d"]
    db = torch.randn((n, d), generator=g, device="cuda")
    q = torch.randn((cfg["m"], d), generator=g, device="cuda")
    extra = torch.randn((10_000, d), generator=g, device="cuda")
    dead = torch.randperm(n, generator=g, device="cuda")[:50_000]
    return db, q, extra, dead


def launches_of(search, want: int, label: str):
    """Run ``search()``; fail unless it launched ``want`` kernels."""
    from repro_torch.kernels import partial_reduce as prk

    before = sum(prk.LAUNCHES.values())
    out = search()
    got = sum(prk.LAUNCHES.values()) - before
    if got != want:
        fail(f"{label} search launched {got} kernels, not {want}")
    return out


def drive(cfg, data, m_after, results, storage="f32"):
    """Phases 4-6: build -> search -> recall -> add -> delete -> search,
    and the two-pass path against the fused one; a quantized tier also
    returns the exact scores of its ids (the rescore ran)."""
    from repro_torch.search import Index
    from repro_torch.testing import assert_topk_close, public_scorer

    db, q, extra, dead = data
    n, metric = cfg["n"], cfg["metric"]
    label = cfg["name"] if storage == "f32" else f"{cfg['name']} {storage}"
    kw = dict(metric=metric, k=K, recall_target=TARGET, cluster="off",
              storage=storage)

    t0 = time.perf_counter()
    index = Index.build(db, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = index.plan
    log(f"[{label}] build {build_s:.2f} s: L={plan.num_bins} bins of "
        f"{plan.bin_size}, k_scan={index.k_scan}, E[recall]="
        f"{plan.expected_recall:.4f}, backend={index._resolve_backend()}")
    v, i = index.search(q)
    torch.cuda.synchronize()
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    truth = exact_topk(metric, q, db, live, K)
    r1 = recall(i, truth)
    floor = plan.expected_recall - hoeffding_eps(q.shape[0])
    log(f"[{label}] search M={q.shape[0]}: recall {r1:.4f} (floor {floor:.4f})")
    if not r1 >= floor:
        fail(f"{label}: recall {r1} < {floor}")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
        fail(f"{label}: non-finite or misshapen values")

    two_pass = Index.build(db, fused_select=False, **kw)
    for idx in (index, two_pass):
        idx.add(extra)
        idx.delete(dead)
    plan = index.plan
    qa = q[:m_after]
    v, i = launches_of(lambda: index.search(qa), 2, f"{label} fused")
    tv, ti = launches_of(lambda: two_pass.search(qa), 1, f"{label} two-pass")
    torch.cuda.synchronize()
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[dead] = False
    if torch.isin(i.long(), dead).any() or torch.isin(ti.long(), dead).any():
        fail(f"{label}: a deleted id was returned")
    if index.size != n + 10_000 - 50_000:
        fail(f"{label}: size {index.size}")
    r2 = recall(i, exact_topk(metric, qa, rows, live, K))
    floor = plan.expected_recall - hoeffding_eps(qa.shape[0])
    log(f"[{label}] add 10000 + delete 50000 -> capacity {index.capacity}, "
        f"L={plan.num_bins}: recall {r2:.4f} (floor {floor:.4f})")
    if not r2 >= floor:
        fail(f"{label}: recall after updates {r2} < {floor}")
    assert_topk_close(v.cpu(), i.cpu(), tv.cpu(), ti.cpu(),
                      score=public_scorer(metric, qa, rows))
    log(f"[{label}] fused_select=False agrees with the fused path")
    if storage != "f32":
        exact = exact_values(metric, qa, rows, i)
        err = float(((v.double() - exact).abs()
                     - 1e-5 * exact.abs()).max())
        if (i < 0).any() or not err <= 1e-4:
            fail(f"{label}: returned values are not the exact scores of the "
                 f"returned ids (excess {err})")
        log(f"[{label}] values are the exact scores of the returned ids "
            f"(largest |diff| beyond rtol 1e-5: {err:.3g})")
    results[label] = dict(
        build_s=build_s, recall=r1, recall_after_updates=r2,
        expected_recall=index.expected_recall, bins=plan.num_bins,
        k_scan=index.k_scan,
    )
    del two_pass
    return index


def read_counts(prk, label, forms, results, two_pass=True, qparts=3):
    """The launches of the path just driven: every kernel of ``forms``
    (without the two-pass kernel unless ``two_pass``; the one-pass forms
    for ``qparts`` 1) launched at least once, no plain version called."""
    launches, plain = dict(prk.LAUNCHES), dict(prk.PLAIN_CALLS)
    log(f"[{label}] launches {launches}, plain calls {plain}")
    for form in forms:
        for name in names_of(form, qparts)[:3 if two_pass else 2]:
            if launches.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the {label} path")
    if sum(plain.values()):
        fail(f"plain versions ran on the {label} path: {plain}")
    for key, counts in (("launches", launches), ("plain_calls", plain)):
        for name, count in counts.items():
            results[key][name] = results[key].get(name, 0) + count


def phase_main_shapes(prk, testing, cases, acc):
    """Phase 7: every kernel against its plain version at the main paths'
    own shapes: all of each index's queries, over its packed operands."""
    from repro_torch.search import get_metric

    for label, cfg, index, q in cases:
        pk = index.pack()
        ops = pk.operands()
        scale = None if pk.storage == "f32" else ops[2]
        qm = get_metric(cfg["metric"]).prepare_queries(q)
        compare_kernels(prk, testing, f"{label} M={q.shape[0]}", qm, ops[0],
                        ops[1], pk.bin_size, index.k_scan, acc, scale=scale,
                        int4_packed=pk.int4_packed)


def time_merge(prk, testing, carries, label, rows, empty_ms):
    """The merge on one plan's carries: bit for bit against its plain
    version, then its device time beside ``torch.topk`` over the same
    carries laid end to end (one PyTorch call that computes the same
    values; the port never calls it), its byte bound (each carry entry
    read once, each output written once) and an empty launch; appended
    to ``rows`` and logged."""
    merge_equal(prk, testing, carries, label)
    splits, m, k_scan = carries[0].shape
    flat = carries[0].permute(1, 0, 2).reshape(m, splits * k_scan).contiguous()
    row = dict(label=label, m=m, splits=splits, k_scan=k_scan,
               plan=prk.merge_plan(splits, k_scan),
               ms=queued_ms(lambda: prk.fused_carry_merge(*carries)),
               topk_ms=queued_ms(lambda: torch.topk(flat, k_scan, dim=1)),
               bound_ms=1e3 * 8.0 * (splits + 1) * m * k_scan / PEAK_HBM_BYTES,
               empty_ms=empty_ms)
    rows.append(row)
    log(f"  merge [{label}] M={m}: {splits} splits, k_scan {k_scan}, plan "
        f"{row['plan']}: {row['ms']:.4f} ms, torch.topk {row['topk_ms']:.4f} "
        f"ms, byte bound {row['bound_ms']:.5f} ms, empty launch "
        f"{empty_ms:.4f} ms; bit-equal to its plain version")
    return row


def time_form(prk, testing, db, q, storage, results, empty_ms, merge_rows):
    """Phase 8, one stored form: CUDA-event timings at the Sift1M shape on
    a fresh index of the form over the main path's data (before its
    updates), at M=10,000 and M=16: both scan kernels, the merge, their
    plain versions, a quantized tier's rescore stage and the whole
    search (at M=16 also as the device time of searches queued back to
    back: a single search there takes about as long on the host as on
    the card); for f32 also cuBLAS's f32 GEMM of the same product (a
    yardstick the port never calls) and the fused kernel at bins of 256
    rows for each k_scan of KSCAN_TIMED; for int4 also the fused scan of
    an index at k=20, whose carry lives in device memory.  The merge at
    each of these plans goes through :func:`time_merge`."""
    from repro_torch.search import (Index, get_metric, pad_queries_to,
                                    rescore_candidates)

    index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                        cluster="off", storage=storage)
    pk = index.pack()
    ops = pk.operands()
    sdb, bias = ops[0], ops[1]
    scale = None if storage == "f32" else ops[2]
    bs, ks, i4 = pk.bin_size, index.k_scan, pk.int4_packed
    m, n_pad, d = q.shape[0], sdb.shape[0], SIFT["d"]
    d_pad = sdb.shape[1] * (2 if i4 else 1)
    row_bytes = sdb.shape[1] * sdb.element_size()
    qm = get_metric(SIFT["metric"]).prepare_queries(q)
    qp = pad_queries_to(qm, d_pad).contiguous()
    kw = dict(bin_size=bs, int4_packed=i4)

    def fused(qq, k_scan=ks, **extra):
        return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), sdb,
                              bias, scale, k_scan=k_scan, width=d,
                              **{**kw, **extra})

    def packed(qq):
        return prk.partial_reduce_packed(qq, sdb, bias, scale, **kw)

    def plain(fn, **extra):
        for s in range(0, m, 512):
            fn(qp[s : s + 512], sdb, bias, scale, **kw, **extra)

    carries = fused(qm)
    splits = carries[0].shape[0]
    q16 = qm[:16].contiguous()
    c16 = fused(q16)
    merge = {m_: time_merge(prk, testing, c, storage, merge_rows, empty_ms)
             for m_, c in ((m, carries), (16, c16))}
    t = {
        "fused": cuda_ms(lambda: fused(qm)),
        "merge": merge[m]["ms"],
        "packed": cuda_ms(lambda: packed(qm)),
        "fused_m16": cuda_ms(lambda: fused(q16), reps=20),
        "merge_m16": merge[16]["ms"],
        "packed_m16": cuda_ms(lambda: packed(q16), reps=20),
        "search": cuda_ms(lambda: index.search(q)),
        "search_m16": cuda_ms(lambda: index.search(q[:16]), reps=20),
        "search_m16_device": queued_ms(lambda: index.search(q[:16])),
        "fused_plain": cuda_ms(lambda: plain(prk.partial_reduce_fused_plain,
                                             k_scan=ks), reps=3),
        "packed_plain": cuda_ms(lambda: plain(prk.partial_reduce_packed_plain),
                                reps=3),
    }
    if storage == "f32":
        def gemm():
            for s in range(0, m, 1000):
                torch.matmul(qp[s : s + 1000], sdb.T)
        t["merge_plain"] = queued_ms(
            lambda: prk.fused_carry_merge_plain(*carries))
        t["gemm"] = cuda_ms(gemm, reps=3)
        # The carry in shared memory (k_scan <= SMEM_K_SCAN) against the
        # carry in device memory (above), at bins of 256 rows: 3,920
        # bins, enough winners to fill a carry of 512.
        for k_scan in KSCAN_TIMED:
            ck = fused(qm, k_scan=k_scan, bin_size=256)
            t[f"fused_k{k_scan}"] = cuda_ms(
                lambda: fused(qm, k_scan=k_scan, bin_size=256))
            t[f"merge_k{k_scan}"] = queued_ms(lambda: prk.fused_carry_merge(*ck))
            del ck
    else:
        fv, fi = prk.fused_carry_merge(*carries)
        rdb, rbias = ops[3], ops[4]
        t["rescore"] = cuda_ms(lambda: rescore_candidates(qm, fv, fi, rdb, rbias,
                                                          K, ks), reps=20)
    if storage == "int4":
        # An int4 index at k=20: its carry (k_scan 3k = 60) is above
        # SMEM_K_SCAN, so it lives in device memory.
        i20 = Index.build(db, metric=SIFT["metric"], k=20, recall_target=TARGET,
                          cluster="off", storage=storage)
        p20 = i20.pack()
        o20 = p20.operands()
        k20 = dict(k=20, k_scan=i20.k_scan, bin_size=p20.bin_size)

        def fused20(qq):
            return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), o20[0],
                                  o20[1], o20[2], k_scan=k20["k_scan"],
                                  bin_size=k20["bin_size"], int4_packed=True,
                                  width=d)
        c20 = fused20(qm)
        t["fused_k20"] = cuda_ms(lambda: fused20(qm))
        t["merge_k20"] = time_merge(prk, testing, c20, "int4 k=20", merge_rows,
                                    empty_ms)["ms"]
        t["fused_k20_m16"] = cuda_ms(lambda: fused20(q16), reps=20)
        t["merge_k20_m16"] = time_merge(prk, testing, fused20(q16), "int4 k=20",
                                        merge_rows, empty_ms)["ms"]
        t["search_k20_m16"] = cuda_ms(lambda: i20.search(q[:16]), reps=20)
        t["search_k20_m16_device"] = queued_ms(lambda: i20.search(q[:16]))
        del i20, p20, o20, c20
    prk.reset_counts()
    index.search(q)
    torch.cuda.synchronize()
    per_search = dict(prk.LAUNCHES)
    if sum(per_search.values()) != 2:
        fail(f"{storage}: one search launched {per_search}, not 2 kernels")

    stored = row_bytes * n_pad + 4.0 * n_pad * (1 if scale is None else 2)

    def bounds(rows, out_bytes):
        return scan_bounds(storage, rows, n_pad, d,
                           4.0 * rows * d + stored + out_bytes)
    fb = bounds(m, 8.0 * splits * m * ks)
    pb = bounds(m, 8.0 * m * (n_pad // bs))
    fb16 = bounds(16, 8.0 * c16[0].shape[0] * 16 * ks)
    pb16 = bounds(16, 8.0 * 16 * (n_pad // bs))
    fname, mname, pname = names_of(storage)
    err = results["max_abs_err"]
    was = FFMA_KERNEL_MS[storage]

    def counts(name):
        """Main-path launches and plain calls, and the share of indices
        equal to the plain version's in the kernel comparisons (the rest
        are near ties)."""
        return dict(launches=results["launches"].get(name, 0),
                    plain_calls=results["plain_calls"].get(name, 0),
                    index_agreement=results["index_agreement"][name])

    def entry(name, kind, b, b16, **extra):
        fused_kernel = kind == "partial_reduce_fused"
        return dict(
            name=name, route="cuda", source=SRC,
            replaces=REPLACES[(kind, storage)], **counts(name),
            max_abs_err=err[name], ms=t["fused" if fused_kernel else "packed"],
            plain_ms=t["fused_plain" if fused_kernel else "packed_plain"],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None,
            bound_parts=b["bound_parts"], epilogue_ms=b["epilogue_ms"],
            ffma_bound_ms=b["ffma_bound_ms"],
            ms_m16=t["fused_m16" if fused_kernel else "packed_m16"],
            bound_ms_m16=b16["bound_ms"], bound_by_m16=b16["bound_by"],
            bound_parts_m16=b16["bound_parts"],
            stored_bytes_per_row=row_bytes,
            smem=prk.scan_smem(storage, fused_kernel, d, ks if fused_kernel else 0),
            **extra)
    extra = dict(splits=splits, splits_m16=c16[0].shape[0],
                 merge_ms=t["merge"], merge_ms_m16=t["merge_m16"],
                 search_ms=t["search"], qps=m / t["search"] * 1e3,
                 search_ms_m16=t["search_m16"],
                 search_ms_m16_device=t["search_m16_device"],
                 recall=results["sift1m" if storage == "f32"
                                 else f"sift1m {storage}"]["recall"])
    if storage == "f32":
        extra.update(gemm_ms=t["gemm"],
                     ms_bin256_by_k_scan={k: t[f"fused_k{k}"] for k in KSCAN_TIMED},
                     merge_ms_bin256_by_k_scan={k: t[f"merge_k{k}"]
                                                for k in KSCAN_TIMED})
    else:
        extra.update(rescore_ms=t["rescore"])
    if storage == "int4":
        extra.update(k20={**k20, "ms": t["fused_k20"], "merge_ms": t["merge_k20"],
                          "ms_m16": t["fused_k20_m16"],
                          "merge_ms_m16": t["merge_k20_m16"],
                          "search_ms_m16": t["search_k20_m16"],
                          "search_ms_m16_device": t["search_k20_m16_device"]})
    kernels = [entry(fname, "partial_reduce_fused", fb, fb16, **extra),
               entry(pname, "partial_reduce_packed", pb, pb16)]
    if storage == "f32":
        mb = bound_ms(m * K * splits, 8.0 * (splits + 1) * m * K)
        kernels.insert(1, dict(
            name=mname, route="cuda", source=SRC, replaces=f"{REF}:219",
            **counts(mname), max_abs_err=err[mname], ms=t["merge"],
            plain_ms=t["merge_plain"], bound_ms=mb[0], bound_by=mb[1],
            library_ms=merge[m]["topk_ms"], ms_m16=t["merge_m16"],
            library_ms_m16=merge[16]["topk_ms"],
            bound_ms_m16=merge[16]["bound_ms"], empty_launch_ms=empty_ms))

    log(f"timing {storage} at M={m}, n_pad={n_pad}, d={d} (d_pad {d_pad}), "
        f"{row_bytes} stored bytes a row, bin={bs}, k_scan={ks}, "
        f"splits={splits} ({c16[0].shape[0]} at M=16; CUDA events, median):")
    for key, ms in t.items():
        log(f"  {key:13s} {ms:10.3f} ms")
    for label, ms, b, ffma in (("fused", t["fused"], fb, was[0]),
                               ("two-pass", t["packed"], pb, was[1]),
                               ("fused M=16", t["fused_m16"], fb16, was[2]),
                               ("two-pass M=16", t["packed_m16"], pb16, None)):
        parts = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in b["bound_parts"].items())
        log(f"  {storage} {label} scan {ms:.3f} ms (FFMA kernel, as recorded "
            f"in PERF.md: {'not timed' if ffma is None else f'{ffma:.3f} ms'}): "
            f"{100 * b['bound_ms'] / ms:.1f}% of its {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms ({parts}); this kernel's epilogue "
            f"{b['epilogue_ms']:.4f} ms; FFMA bound {b['ffma_bound_ms']:.4f} ms")
    log(f"  search QPS {m / t['search'] * 1e3:.0f} at recall "
        f"{extra['recall']:.4f}; launches per search: {per_search}")
    return kernels, row_bytes


def phase_planner(prk, testing, sift, glove, bounds, results, seed):
    """Phase 9: the planner and the bitonic network on the card (see the
    module docstring), on the device of the ``sift`` and ``glove`` (db,
    queries) pairs; ``bounds`` holds phase 8's bounds by tier: the
    tensor-core bound at M=10,000 and the byte bound at M=16.  Returns
    what it measured, for the JSON line."""
    from repro_torch.core import exact_rescoring
    from repro_torch.search import Index, PlanCache, detect_device
    from repro_torch.search import plan as planlib

    out = {"profile": detect_device()}
    log(f"planner: detect_device() = {out['profile']!r}")
    if out["profile"] != "h100":
        fail(f"detect_device() gave {out['profile']!r} on this card, not 'h100'")
    timed = []  # (query_block, seconds) of every time_search call
    real_time_search = planlib.time_search

    def counting(index, queries, **kw):
        wall = real_time_search(index, queries, **kw)
        timed.append((index.spec.query_block, wall))
        return wall
    planlib.time_search = counting

    dev = sift[0].device
    prk.reset_counts()
    models, explained = {}, []
    for cfg, (db, q), storages in ((SIFT, sift, FORMS), (GLOVE, glove, ("f32",))):
        for storage in storages:
            label = f"{cfg['name']} {storage}"
            index = Index.build(db, metric=cfg["metric"], k=K,
                                recall_target=TARGET, cluster="off",
                                storage=storage, device=dev)
            kp = index.kernel_plan
            got = (kp.k_scan, kp.num_bins, kp.bin_size,
                   round(kp.expected_recall, 4))
            if got != PLAN_TABLE[cfg["name"], storage]:
                fail(f"{label}: plan {got}, not PERF.md's "
                     f"{PLAN_TABLE[cfg['name'], storage]}")
            for m in (cfg["m"], 16):
                rep = index.explain(m=m, measure=True)
                pred, meas = rep["predicted"], rep["measured"]
                row = dict(label=label, m=m, predicted_ms=1e3 * pred["wall_s"],
                           bottleneck=pred["bottleneck"],
                           measured_ms=1e3 * meas["wall_s"],
                           share=meas["roofline_fraction"],
                           splits=rep["plan"]["splits"])
                explained.append(row)
                log(f"  explain [{label}] M={m}: predicted {row['predicted_ms']:.4f}"
                    f" ms ({row['bottleneck']}), measured {row['measured_ms']:.4f}"
                    f" ms, {100 * row['share']:.1f}% of the roof; "
                    f"{row['splits']} splits")
                if meas["wall_s"] < 0.95 * pred["wall_s"]:
                    fail(f"{label} M={m}: measured {meas['wall_s']} s beats "
                         f"0.95 x the bound {pred['wall_s']} s (a wrong count)")
                want = bounds.get((storage, m)) if cfg is SIFT else None
                if want is not None and abs(row["predicted_ms"] / want - 1) > 0.01:
                    fail(f"{label} M={m}: predicted {row['predicted_ms']} ms, "
                         f"not within 1% of phase 8's bound {want} ms")
            if cfg is SIFT:
                models[storage] = index
            del index
    out["explain"] = explained

    # plan="measure": the sweep, its cache, and a search with its plan
    db, q = sift
    live = torch.ones(db.shape[0], dtype=torch.bool, device=dev)
    truth = exact_topk(SIFT["metric"], q, db, live, K)
    out["measure"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(str(pathlib.Path(tmp) / "plans.json"))
        for storage in ("f32", "int4"):
            kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET,
                      cluster="off", storage=storage, device=dev)
            del timed[:]
            t0 = time.perf_counter()
            index = Index.build(db, plan="measure", plan_cache=cache, **kw)
            sweep_s = time.perf_counter() - t0
            cands = list(timed)
            kp = index.kernel_plan
            log(f"  plan=measure [sift1m {storage}] sweep {sweep_s:.2f} s, "
                f"query_block: seconds a search {cands}; winner query_block "
                f"{kp.query_block} ({kp.source})")
            del timed[:]
            again = Index.build(db, plan="measure", plan_cache=cache, **kw)
            if timed or again.kernel_plan != kp or kp.source != "measure":
                fail(f"sift1m {storage}: the second plan=measure build timed "
                     f"{len(timed)} searches or planned {again.kernel_plan}")
            del again
            _, i = index.search(q)
            r = recall(i, truth)
            floor = index.plan.expected_recall - hoeffding_eps(q.shape[0])
            log(f"  plan=measure [sift1m {storage}] cache hit, no timing; "
                f"search M={q.shape[0]}: recall {r:.4f} (floor {floor:.4f})")
            if not r >= floor:
                fail(f"sift1m {storage} measured plan: recall {r} < {floor}")
            out["measure"][storage] = dict(candidates=cands,
                                           query_block=kp.query_block,
                                           sweep_s=sweep_s, recall=r)
            del index
    planlib.time_search = real_time_search

    # the bitonic network: a rescore's shape, then an int8 search
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randint(-3, 4, (q.shape[0], 60), generator=g, device=dev).float()
    vals = torch.where((vals == 0) & (torch.randint(0, 2, vals.shape, generator=g,
                                                    device=dev) == 1),
                       torch.full_like(vals, -0.0), vals)
    idxs = torch.randperm(vals.numel(), generator=g,
                          device=dev).int().reshape(vals.shape)
    bv, bi = exact_rescoring(vals, idxs, 2 * K)
    sv, si = exact_rescoring(vals, idxs, 2 * K, use_bitonic=False)
    value_of = torch.empty(vals.numel())  # each index's value (a scorer)
    value_of[idxs.flatten().long().cpu()] = vals.flatten().cpu()
    testing.assert_topk_close(
        sv.cpu(), si.cpu(), bv.cpu(), bi.cpu(), rtol=0.0, atol=0.0,
        score=lambda row, idx: value_of[torch.as_tensor(idx).long()].double().numpy())
    out["bitonic"] = dict(
        ms=cuda_ms(lambda: exact_rescoring(vals, idxs, 2 * K)),
        stable_ms=cuda_ms(lambda: exact_rescoring(vals, idxs, 2 * K,
                                                  use_bitonic=False)))
    bitonic = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                          cluster="off", storage="int8", use_bitonic=True,
                          device=dev)
    v, i = bitonic.search(q)
    dv, di = models["int8"].search(q)
    testing.assert_topk_close(dv.cpu(), di.cpu(), v.cpu(), i.cpu(),
                              score=testing.public_scorer(SIFT["metric"], q, db))
    out["bitonic"].update(
        search_ms=cuda_ms(lambda: bitonic.search(q)),
        default_search_ms=cuda_ms(lambda: models["int8"].search(q)))
    log(f"  bitonic exact_rescoring {tuple(vals.shape)} -> top {2 * K}: "
        f"{out['bitonic']['ms']:.3f} ms (stable sort {out['bitonic']['stable_ms']:.3f}"
        f" ms), equal up to the order of tied values; sift1m int8 search "
        f"M={q.shape[0]} use_bitonic=True {out['bitonic']['search_ms']:.3f} ms, "
        f"default {out['bitonic']['default_search_ms']:.3f} ms: same results")
    del bitonic, models

    # C1: an add without growth lifts the over-fetch cap of a small index
    small = db[:112]
    c1 = Index.build(small[:12], metric=SIFT["metric"], k=K, storage="int4",
                     capacity=1024, device=dev)
    c1.add(small[12:])
    cv, ci = c1.search(q[:100])
    read_counts(prk, "planner", FORMS, results, two_pass=False)
    out["c1"] = dict(k_scan=c1.k_scan, capacity=c1.capacity)
    if (c1.k_scan, c1.capacity) != (3 * K, 1024):
        fail(f"C1: k_scan {c1.k_scan} after add without growth, not {3 * K}")
    cpu = Index.build(small[:12].cpu(), metric=SIFT["metric"], k=K,
                      storage="int4", capacity=1024, device="cpu", backend="cuda")
    cpu.add(small[12:].cpu())
    pv, pi = cpu.search(q[:100].cpu())
    testing.assert_topk_close(pv, pi, cv.cpu(), ci.cpu(),
                              score=testing.public_scorer(SIFT["metric"], q[:100],
                                                          small))
    log(f"  C1: int4 index of 12 rows (capacity 1024) + 100 rows: k_scan "
        f"{c1.k_scan}, search equal to the same index on the CPU")
    return out


def exact_topk_bf16(metric, q, rows, live, k, chunk=1000):
    """Exact oracle in the bf16 compute dtype: the rows and queries cast
    to bf16 and prepared as the index prepares them (its bf16 norms and
    bias), scored with exact products and f32 sums."""
    from repro_torch.search import get_metric

    m_obj = get_metric(metric)
    prepped, bias = m_obj.prepare_database(rows.to(torch.bfloat16))
    prepped = prepped.float()
    qq = m_obj.prepare_queries(q.to(torch.bfloat16)).float()
    full = torch.where(live, 0.0, float("-inf"))
    if bias is not None:
        full = full + bias.float()
    out = []
    for s in range(0, qq.shape[0], chunk):
        out.append(torch.topk(qq[s : s + chunk] @ prepped.T + full, k,
                              dim=1).indices)
    return torch.cat(out)


def integer_bits_equal(prk, label, m, n, d, bin_size, k_scan, seed):
    """Integer-valued bf16 queries and rows in each one-pass form: both
    kernels bit-equal to their plain versions (every sum is exact)."""
    from repro_torch.search import pad_queries_to, quant

    g = torch.Generator(device="cuda").manual_seed(seed)
    block = max(bin_size, 128)
    n_pad = -(-n // block) * block
    d_pad = -(-d // 128) * 128
    q = torch.randint(-3, 4, (m, d), generator=g, device="cuda").float()
    db = torch.zeros((n_pad, d_pad), device="cuda")
    db[:n, :d] = torch.randint(-7, 8, (n, d), generator=g, device="cuda").float()
    bias = torch.full((1, n_pad), -3.4028234663852886e38, device="cuda")
    live = torch.rand(n, generator=g, device="cuda") >= 0.1
    bias[0, :n] = torch.where(live, -0.5 * (db[:n] * db[:n]).sum(1), bias[0, :n])
    qb = q.to(torch.bfloat16)
    qp = pad_queries_to(qb, d_pad)
    for form in ONE_PASS_FORMS:
        scale = None
        if form == "bf16":
            stored = db.to(torch.bfloat16)
        else:
            stored = db.to(torch.int8)
            scale = torch.ones((1, n_pad), device="cuda")
            if form == "int4":
                stored = quant.pack_int4_rows(stored)
        kw = dict(bin_size=bin_size, int4_packed=form == "int4")
        got = (*prk.partial_reduce_packed(qb, stored, bias, scale, **kw),
               *prk.partial_reduce_fused(qb, stored, bias, scale, k_scan=k_scan,
                                         **kw))
        want = (*prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw),
                *prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                                k_scan=k_scan, **kw))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"one-pass {form} [{label}]: not bit-equal to its plain "
                 f"version on integer-valued inputs")
    log(f"one-pass kernels vs plain on integer-valued inputs [{label}]: m={m} "
        f"n={n} d={d} bin={bin_size} k_scan={k_scan}, {ONE_PASS_FORMS}: "
        f"bit-equal")


def phase_one_pass_kernels(prk, testing, seed, acc):
    """Phase 10, the kernels: each one-pass instantiation against its
    plain version at the small test shapes and on 512 bf16 queries at the
    Sift1M shape, and bit for bit on integer-valued inputs."""
    cases = dict(testing.KERNEL_CASES)
    cases["sift1m_512"] = dict(m=512, n=SIFT["n"], d=SIFT["d"], bin_size=4096,
                               k_scan=K, dead=0.1, l2=True)
    for name, case in cases.items():
        q, db, bias = testing.packed_operands(**case, seed=seed, device="cuda")
        qb = q.to(torch.bfloat16)
        for form in ONE_PASS_FORMS:
            bs, ks = case["bin_size"], case["k_scan"]
            if name == "sift1m_512":
                bs, ks = SIFT_PLAN[form]
            stored, scale, packed, _ = testing.stored_operands(db, form)
            compare_kernels(prk, testing, f"{name} bf16 queries", qb, stored,
                            bias, bs, ks, acc, scale=scale, int4_packed=packed)
            del stored, scale
        del q, qb, db, bias
    integer_bits_equal(prk, "small", 150, 2000, 100, 16, 10, seed)
    integer_bits_equal(prk, "sift1m", 512, SIFT["n"], SIFT["d"], 2048, 20, seed)
    integer_bits_equal(prk, "sift1m k_scan 129", 300, SIFT["n"], SIFT["d"], 256,
                       129, seed)


def drive_bf16(data, storage, results):
    """Phase 10, the path: a ``dtype="bfloat16"`` index at the Sift1M shape,
    searched at M=10,000 and M=16, recall against the bf16 oracle, the
    two-pass path against the fused one after an add and a delete."""
    from repro_torch.search import Index
    from repro_torch.testing import assert_topk_close, public_scorer

    db, q, extra, dead = data
    label = f"sift1m bf16-compute {storage}"
    kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET, cluster="off",
              storage=storage, dtype="bfloat16")
    t0 = time.perf_counter()
    index = Index.build(db, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = index.plan
    live = torch.ones(db.shape[0], dtype=torch.bool, device="cuda")
    truth = exact_topk_bf16(SIFT["metric"], q, db, live, K)
    v, i = index.search(q)
    v16, i16 = index.search(q[:16])
    torch.cuda.synchronize()
    r1 = recall(i, truth)
    floor = plan.expected_recall - hoeffding_eps(q.shape[0])
    log(f"[{label}] build {build_s:.2f} s: L={plan.num_bins} bins of "
        f"{plan.bin_size}, k_scan={index.k_scan}; search M={q.shape[0]}: recall "
        f"{r1:.4f} against the bf16 oracle (floor {floor:.4f})")
    if not r1 >= floor:
        fail(f"{label}: recall {r1} < {floor}")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
        fail(f"{label}: non-finite or misshapen values")
    # the same rows, scanned in another split plan (and rescored in a batch
    # of another size): equal up to the order of f32 sums
    assert_topk_close(v[:16].cpu(), i[:16].cpu(), v16.cpu(), i16.cpu(),
                      score=public_scorer(SIFT["metric"], q[:16], db,
                                          dtype="bfloat16"))
    two_pass = Index.build(db, fused_select=False, **kw)
    for idx in (index, two_pass):
        idx.add(extra)
        idx.delete(dead)
    qa = q[:2_000]
    v, i = launches_of(lambda: index.search(qa), 2, f"{label} fused")
    tv, ti = launches_of(lambda: two_pass.search(qa), 1, f"{label} two-pass")
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[dead] = False
    if torch.isin(i.long(), dead).any() or torch.isin(ti.long(), dead).any():
        fail(f"{label}: a deleted id was returned")
    r2 = recall(i, exact_topk_bf16(SIFT["metric"], qa, rows, live, K))
    floor2 = index.plan.expected_recall - hoeffding_eps(qa.shape[0])
    log(f"[{label}] add 10000 + delete 50000: recall {r2:.4f} (floor "
        f"{floor2:.4f}); fused_select=False agrees with the fused path")
    if not r2 >= floor2:
        fail(f"{label}: recall after updates {r2} < {floor2}")
    assert_topk_close(v.cpu(), i.cpu(), tv.cpu(), ti.cpu(),
                      score=public_scorer(SIFT["metric"], qa, rows,
                                          dtype="bfloat16"))
    results[label] = dict(build_s=build_s, recall=r1, recall_after_updates=r2,
                          expected_recall=plan.expected_recall, k_scan=index.k_scan)
    del two_pass, index
    return label


def time_one_pass(prk, db, q, storage, results, empty_ms):
    """Phase 10, the timings: on a fresh ``dtype="bfloat16"`` index of the
    Sift1M data, both one-pass scan kernels at M=10,000 and M=16 beside
    one pass's tensor, score-operation and byte bounds (and the kernel's
    own epilogue count beside them), their plain versions, the
    whole search (M=16 also queued), and, for context, ``torch.matmul`` of
    the bf16 product alone (not the scan's function: no bias, no bin
    top-1; the port never calls it)."""
    from repro_torch.search import Index, get_metric, pad_queries_to

    index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                        cluster="off", storage=storage, dtype="bfloat16")
    pk = index.pack()
    ops = pk.operands()
    sdb, bias = ops[0], ops[1]
    scale = None if storage == "f32" else ops[2]
    form = prk.storage_form(sdb, scale, pk.int4_packed)
    bs, ks, i4 = pk.bin_size, index.k_scan, pk.int4_packed
    m, n_pad, d = q.shape[0], sdb.shape[0], SIFT["d"]
    d_pad = sdb.shape[1] * (2 if i4 else 1)
    row_bytes = sdb.shape[1] * sdb.element_size()
    qm = get_metric(SIFT["metric"]).prepare_queries(q.to(torch.bfloat16))
    qp = pad_queries_to(qm, d_pad).contiguous()
    kw = dict(bin_size=bs, int4_packed=i4)

    def fused(qq):
        return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), sdb, bias,
                              scale, k_scan=ks, width=d, **kw)

    def packed(qq):
        return prk.partial_reduce_packed(qq, sdb, bias, scale, **kw)

    def plain(fn, **extra):
        for s in range(0, m, 512):
            fn(qp[s : s + 512], sdb, bias, scale, **kw, **extra)

    rows16 = sdb if form == "bf16" else torch.ones(
        (n_pad, d_pad), dtype=torch.bfloat16, device="cuda")

    def gemm():
        for s in range(0, m, 1000):
            torch.matmul(qp[s : s + 1000], rows16.T)

    carries = fused(qm)
    splits = carries[0].shape[0]
    q16 = qm[:16].contiguous()
    c16 = fused(q16)
    t = {
        "fused": cuda_ms(lambda: fused(qm)),
        "packed": cuda_ms(lambda: packed(qm)),
        "fused_m16": cuda_ms(lambda: fused(q16), reps=20),
        "packed_m16": cuda_ms(lambda: packed(q16), reps=20),
        "merge": queued_ms(lambda: prk.fused_carry_merge(*carries)),
        "search": cuda_ms(lambda: index.search(q)),
        "search_m16": cuda_ms(lambda: index.search(q[:16]), reps=20),
        "search_m16_device": queued_ms(lambda: index.search(q[:16])),
        "fused_plain": cuda_ms(lambda: plain(prk.partial_reduce_fused_plain,
                                             k_scan=ks), reps=3),
        "packed_plain": cuda_ms(lambda: plain(prk.partial_reduce_packed_plain),
                                reps=3),
        "bf16_gemm": cuda_ms(gemm, reps=3),
    }
    stored = row_bytes * n_pad + 4.0 * n_pad * (1 if scale is None else 2)

    def bounds(rows, out_bytes):
        return scan_bounds(form, rows, n_pad, d,
                           2.0 * rows * d + stored + out_bytes, passes=1)
    fb = bounds(m, 8.0 * splits * m * ks)
    pb = bounds(m, 8.0 * m * (n_pad // bs))
    fb16 = bounds(16, 8.0 * c16[0].shape[0] * 16 * ks)
    pb16 = bounds(16, 8.0 * 16 * (n_pad // bs))
    fname, _, pname = names_of(form, 1)
    kernels = []
    for name, kind, key, b, b16 in (
            (fname, "partial_reduce_fused", "fused", fb, fb16),
            (pname, "partial_reduce_packed", "packed", pb, pb16)):
        kernels.append(dict(
            name=name, route="cuda", source=SRC, replaces=REPLACES[(kind, form)],
            launches=results["launches"].get(name, 0),
            plain_calls=results["plain_calls"].get(name, 0),
            index_agreement=results["index_agreement"].get(name),
            max_abs_err=results["max_abs_err"].get(name), ms=t[key],
            plain_ms=t[f"{key}_plain"], bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], library_ms=None,
            bound_parts=b["bound_parts"], epilogue_ms=b["epilogue_ms"],
            ms_m16=t[f"{key}_m16"],
            bound_ms_m16=b16["bound_ms"], bound_by_m16=b16["bound_by"],
            bound_parts_m16=b16["bound_parts"], stored_bytes_per_row=row_bytes,
            bf16_gemm_ms_not_the_scan=t["bf16_gemm"], index_storage=storage,
            smem=prk.scan_smem(form, kind == "partial_reduce_fused", d,
                               ks if kind == "partial_reduce_fused" else 0,
                               qparts=1)))
    kernels[0].update(splits=splits, splits_m16=c16[0].shape[0],
                      merge_ms=t["merge"], search_ms=t["search"],
                      qps=m / t["search"] * 1e3, search_ms_m16=t["search_m16"],
                      search_ms_m16_device=t["search_m16_device"],
                      recall=results[f"sift1m bf16-compute {storage}"]["recall"])
    log(f"timing one-pass {form} (dtype=bfloat16, storage={storage}) at M={m}, "
        f"n_pad={n_pad}, bin={bs}, k_scan={ks}, splits={splits} "
        f"({c16[0].shape[0]} at M=16; CUDA events, median):")
    for key, ms in t.items():
        log(f"  {key:18s} {ms:10.3f} ms")
    for label, ms, b in (("fused", t["fused"], fb), ("two-pass", t["packed"], pb),
                         ("fused M=16", t["fused_m16"], fb16),
                         ("two-pass M=16", t["packed_m16"], pb16)):
        parts = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in b["bound_parts"].items())
        log(f"  one-pass {form} {label} scan {ms:.3f} ms: "
            f"{100 * b['bound_ms'] / ms:.1f}% of its {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms ({parts}); this kernel's epilogue "
            f"{b['epilogue_ms']:.4f} ms")
        if ms < 0.95 * b["bound_ms"]:
            fail(f"one-pass {form} {label}: {ms} ms beats 0.95 x its bound")
    log(f"  search QPS {m / t['search'] * 1e3:.0f}; bf16 torch.matmul of the "
        f"product alone (not the scan's function) {t['bf16_gemm']:.3f} ms")
    del index
    return kernels


def phase_clusters_gaussian(prk, data, results):
    """Phase 11 (C3): the default build (``cluster="auto"``) on the Sift1M
    Gaussian data beside ``cluster="off"``.  The crossover enables pruning,
    the ``"h100"`` profile must veto it (the pruned scan priced at least
    as high as the dense one; both times printed), the build must run no
    k-means (no cluster timings, no tables, no miss check) and the search
    must equal ``cluster="off"`` bit for bit."""
    from repro_torch.search import Index

    db, q = data[:2]
    kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET)

    def timed(**extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = Index.build(db, **kw, **extra)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    prk.reset_counts()
    timed(cluster="off")  # the allocator's first growth, outside the times
    off, off_s = timed(cluster="off")
    auto, build_s = timed()
    cp, pk = auto.kernel_plan.cluster, auto.pack()
    veto = auto.kernel_plan.cluster_veto
    block = auto.explain()["cluster"]
    out = dict(build_s=build_s, off_build_s=off_s, timings=auto.pack_timings,
               veto=block, m=auto.kernel_plan.query_block,
               plan=dict(num_clusters=cp.num_clusters, probes=cp.probes,
                         scan_rows=cp.scan_rows, enabled=cp.enabled))
    log(f"[sift1m gaussian] Index.build(db) {build_s:.3f} s, cluster=\"off\" "
        f"{off_s:.3f} s (PR 18: 2.05 s against 0.03 s); cluster timings "
        f"{auto.pack_timings}; h100 veto at the plan's batch "
        f"{out['m']}: pruned {block.get('predicted_pruned_s')} s, dense "
        f"{block.get('predicted_dense_s')} s")
    if veto is None or cp.enabled or veto[0] < veto[1]:
        fail(f"gaussian data: the h100 profile must veto pruning ({veto})")
    if pk.cluster is not None or pk.cluster_rejected_miss is not None \
            or auto.pack_timings:
        fail("gaussian data: the default build ran k-means or the miss check")
    va, ia = auto.search(q)
    vo, io = off.search(q)
    torch.cuda.synchronize()
    if not (torch.equal(va, vo) and torch.equal(ia, io)):
        fail("gaussian data: the default build is not bit-identical to "
             "cluster=off")
    log("[sift1m gaussian] default search bit-identical to cluster=off")
    read_counts(prk, "cluster gaussian", ("f32",), results, two_pass=False)
    results["cluster_gaussian"] = out
    return out


def mixture_data(seed, n, d, m):
    """The mixture corpus of ``tests/test_cluster.py`` at the given shape,
    on the card: 64 components, centers N(0, 1) x 2.5, unit noise,
    queries from the same centers; rows to add and ids to delete."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((64, d), generator=g, device="cuda") * 2.5

    def draw(count):
        pick = torch.randint(0, 64, (count,), generator=g, device="cuda")
        return centers[pick] + torch.randn((count, d), generator=g, device="cuda")
    db, q, extra = draw(n), draw(m), draw(10_000)
    dead = torch.randperm(n, generator=g, device="cuda")[:50_000]
    return db, q, extra, dead


def phase_clusters_mixture(prk, seed, results):
    """Phase 12 (see the module docstring).  Returns what it measured."""
    from repro_torch.search import Index, plan_search

    db, q, extra, dead = mixture_data(seed, SIFT["n"], SIFT["d"], SIFT["m"])
    metric = SIFT["metric"]
    live = torch.ones(db.shape[0], dtype=torch.bool, device="cuda")
    truth = exact_topk(metric, q, db, live, K)
    rows = torch.cat([db, extra])
    live_after = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live_after[dead] = False
    qa = q[:2_000]
    truth_after = exact_topk(metric, qa, rows, live_after, K)
    out = {}
    for storage in ("f32", "int8"):
        label = f"mixture {storage}"
        kw = dict(metric=metric, k=K, recall_target=TARGET, storage=storage)
        prk.reset_counts()
        t0 = time.perf_counter()
        # the "a100" profile keeps the reference's decision (the card's own
        # vetoes the pruned scan), so the pruned path is measured here
        index = Index.build(db, profile="a100", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cp, cs = index.kernel_plan.cluster, index.pack().cluster
        got = (cp.num_clusters, cp.rows_per_cluster, cp.probes, cp.spill_capacity)
        if got != (1024, 1224, 32, 15_632) or not cp.enabled:
            fail(f"{label}: cluster plan {got}, enabled={cp.enabled}")
        if cs is None:
            fail(f"{label}: the miss check dropped the tables "
                 f"({index.pack().cluster_rejected_miss})")
        v, i = index.search(q)
        torch.cuda.synchronize()
        r1 = recall(i, truth)
        floor = index.expected_recall - hoeffding_eps(q.shape[0])
        log(f"[{label}] build {build_s:.2f} s {index.pack_timings}; plan C="
            f"{cp.num_clusters} R={cp.rows_per_cluster} probes={cp.probes} spill="
            f"{cp.spill_capacity} S={cp.scan_rows}, spill used "
            f"{cs.spill_count}; search M={q.shape[0]}: recall {r1:.4f} (floor "
            f"{floor:.4f}, E[recall] {index.expected_recall:.4f})")
        if not r1 >= floor:
            fail(f"{label}: recall {r1} < {floor}")
        if not torch.isfinite(v).all():
            fail(f"{label}: non-finite values")
        launches, plain = dict(prk.LAUNCHES), dict(prk.PLAIN_CALLS)
        if sum(launches.values()) or sum(plain.values()):
            fail(f"{label}: the pruned path launched {launches} or called "
                 f"{plain}; it has no kernel")
        log(f"[{label}] launches {launches}, plain calls {plain} (the pruned "
            f"scan is a gather and a bmm in plain PyTorch, as the reference's "
            f"is XLA)")
        timed = {}
        off = Index.build(db, cluster="off", **kw)

        def h100_ms(m, mode):
            """The "h100" profile's price of the pruned path (kept) or of
            the dense scan, at a batch of m."""
            return 1e3 * plan_search(
                n=index.capacity, d=SIFT["d"], k=K, m=m, metric=metric,
                recall_target=TARGET, storage=storage, backend="cuda",
                device="h100", cluster=mode, cluster_veto=False).predicted_s
        for name, idx, mode in (("pruned", index, "auto"), ("off", off, "off")):
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            timed[name] = dict(
                ms=cuda_ms(lambda: idx.search(q), reps=3),
                ms_m16=cuda_ms(lambda: idx.search(q[:16]), reps=20),
                ms_m16_device=queued_ms(lambda: idx.search(q[:16]), reps=20),
                predicted_ms=h100_ms(q.shape[0], mode),
                predicted_ms_m16=h100_ms(16, mode),
                peak_extra_bytes=torch.cuda.max_memory_allocated() - base_mem)
        _, io = off.search(q)
        timed["off"]["recall"] = recall(io, truth)
        del off
        index.add(extra)
        index.delete(dead)
        v, i = index.search(qa)
        if torch.isin(i.long(), dead).any():
            fail(f"{label}: a deleted id was returned")
        r2 = recall(i, truth_after)
        floor2 = index.expected_recall - hoeffding_eps(qa.shape[0])
        log(f"[{label}] add 10000 + delete 50000: recall {r2:.4f} (floor "
            f"{floor2:.4f}); spill used {index.pack().cluster.spill_count}")
        if not r2 >= floor2:
            fail(f"{label}: recall after updates {r2} < {floor2}")
        for name in ("pruned", "off"):
            tt = timed[name]
            log(f"  [{label}] {name:6s}: M={q.shape[0]} {tt['ms']:.3f} ms "
                f"(h100 prediction {tt['predicted_ms']:.3f}), M=16 "
                f"{tt['ms_m16']:.3f} ms, queued {tt['ms_m16_device']:.3f} ms "
                f"(prediction {tt['predicted_ms_m16']:.4f}); peak memory "
                f"above the index {tt['peak_extra_bytes'] / 2**30:.2f} GiB")
        out[storage] = dict(build_s=build_s, timings=index.pack_timings,
                            recall=r1, recall_after_updates=r2,
                            expected_recall=index.expected_recall,
                            spill_count=cs.spill_count, **timed)
        del index
    results["cluster_mixture"] = out
    return out


# Phase 13: the tiers served (storage, compute dtype, label)
SERVE_TIERS = (("f32", None, "f32"), ("int8", None, "int8"),
               ("f32", "bfloat16", "f32 at bf16 compute"))


def served_requests(seed, count, d):
    """A seeded stream of requests: 1-64 rows of unit-normal queries (host
    f32), each with its own k of at most K."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(1, 65)), d), dtype=np.float32),
             int(rng.integers(1, K + 1))) for _ in range(count)]


def served_mismatches(index, pairs):
    """(ticket results, queries, k) triples that differ from a direct
    ``Index.search`` of the same rows in any bit."""
    bad = []
    for got, q, k in pairs:
        direct = index.search(q)
        if not (torch.equal(got.values, direct.values[:, :k].cpu())
                and torch.equal(got.indices, direct.indices[:, :k].cpu())):
            diff = float((got.values - direct.values[:, :k].cpu()).abs().max())
            bad.append((q.shape[0], k, diff))
    return bad


def host_ms(fn, reps: int = 100) -> float:
    """Median host wall time of ``fn()`` (which ends in a synchronize),
    after three warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def serve_latency(index, server_cls, config_cls, q16):
    """The four times of one M=16 search: an eager ``Index.search`` call
    (CUDA events around one call, the host's Python included), a graph
    replay with its host round trip (pinned copy in, replay, copy out,
    synchronize), a served request from submit to result (a wall-clock
    server with no coalescing window, one client), and the card's time of
    replays queued back to back (and of eager searches)."""
    q_dev = torch.as_tensor(q16, device="cuda")
    graph = index.search_graph(16)
    pinned = torch.as_tensor(q16).to(index.query_dtype).pin_memory()
    out_v = torch.empty(graph.values.shape, dtype=graph.values.dtype,
                        pin_memory=True)
    out_i = torch.empty(graph.indices.shape, dtype=graph.indices.dtype,
                        pin_memory=True)

    def round_trip():
        graph.queries.copy_(pinned, non_blocking=True)
        index.replay_graph(graph)
        out_v.copy_(graph.values, non_blocking=True)
        out_i.copy_(graph.indices, non_blocking=True)
        torch.cuda.current_stream().synchronize()

    server = server_cls(index, config_cls(max_delay_s=0.0))
    try:
        served = host_ms(lambda: server.submit(q16).result(timeout=60))
    finally:
        server.close(timeout=60)
    return dict(eager_ms=cuda_ms(lambda: index.search(q_dev), reps=51),
                replay_round_trip_ms=host_ms(round_trip),
                served_ms=served,
                replay_queued_ms=queued_ms(lambda: index.replay_graph(graph)),
                eager_queued_ms=queued_ms(lambda: index.search(q_dev)))


def serve_wall_clock(index, data, server_cls, config_cls, label, seed):
    """Four submitting threads send 2,000 requests of 1-64 rows (groups of
    8 in flight each); after half of them, ``server.mutation()`` adds
    10,000 rows (growth: every graph is recaptured) and deletes 50,000.
    Requests submitted after the mutation must equal direct searches."""
    import threading

    import numpy as np

    _, _, extra, dead = data
    server = server_cls(index, config_cls())
    captures0 = index.cache_info()["captures"]
    per_thread, threads = 500, 4
    done = [0]
    lock = threading.Lock()
    tickets, errors = [], []

    def client(cid):
        try:
            reqs = served_requests(seed + 100 + cid, per_thread, SIFT["d"])
            for s in range(0, per_thread, 8):
                group = [(server.submit(q, k=k), q, k) for q, k in reqs[s:s + 8]]
                for t, q, k in group:
                    t.result(timeout=120)
                with lock:
                    tickets.extend(group)
                    done[0] += len(group)
        except Exception as e:  # surfaced below
            errors.append(e)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(c,)) for c in range(threads)]
    for w in workers:
        w.start()
    while done[0] < threads * per_thread // 2 and not errors \
            and any(w.is_alive() for w in workers):
        time.sleep(0.002)
    with server.mutation():
        index.add(extra)
        index.delete(dead)
    mutated_at = time.monotonic()
    for w in workers:
        w.join(300)
    elapsed = time.perf_counter() - t0
    server.close(timeout=60)
    if errors or any(w.is_alive() for w in workers):
        fail(f"[serve {label}] wall-clock run: {errors[:3]}")
    after = [(t.result(), q, k) for t, q, k in tickets if t.submitted_at > mutated_at]
    bad = served_mismatches(index, after)
    lat = sorted(t.latency_s for t, _, _ in tickets)
    st = server.stats()
    info = index.cache_info()
    out = dict(requests=len(tickets), rows=sum(q.shape[0] for _, q, _ in tickets),
               seconds=elapsed, batches=st["batches"],
               graph_replays=st["graph_replays"],
               eager_batches=st["eager_batches"], occupancy=st["occupancy"],
               p50_ms=1e3 * lat[len(lat) // 2],
               p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               recaptures=info["captures"] - captures0,
               invalidations=info["invalidations"], checked_after=len(after))
    out["qps"] = out["rows"] / elapsed
    out["requests_per_s"] = out["requests"] / elapsed
    log(f"[serve {label}] wall clock: {out['requests']} requests, "
        f"{out['rows']} rows in {elapsed:.3f} s: {out['qps']:.0f} QPS "
        f"({out['requests_per_s']:.0f} requests/s), p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f} ms, occupancy {out['occupancy']:.3f}, "
        f"graph_replays {out['graph_replays']} of {out['batches']} batches, "
        f"recaptures {out['recaptures']} after the mutation (add 10000 + "
        f"delete 50000); {len(after)} requests after it checked")
    if bad:
        fail(f"[serve {label}] {len(bad)} of {len(after)} requests after the "
             f"mutation differ from direct searches: {bad[:5]}")
    if out["graph_replays"] != out["batches"] or out["recaptures"] < 1:
        fail(f"[serve {label}] graph replays {out['graph_replays']} of "
             f"{out['batches']} batches, {out['recaptures']} recaptures")
    return out


def compare_bucket_kernels(prk, testing, index, buckets, label, seed, acc):
    """Each kernel against its plain version at every bucket's shape: the
    bucket's rows of seeded queries, prepared and cast as a search does,
    over the index's packed operands (each bucket has its own split
    plan)."""
    import numpy as np

    from repro_torch.search import get_metric

    pk = index.pack()
    ops = pk.operands()
    scale = None if pk.storage == "f32" else ops[2]
    rng = np.random.default_rng(seed)
    for b in buckets:
        q = torch.as_tensor(rng.standard_normal((b, index.dim), dtype=np.float32),
                            device="cuda").to(index.query_dtype)
        qm = get_metric(index.spec.metric).prepare_queries(q)
        compare_kernels(prk, testing, f"serve {label} bucket M={b}", qm, ops[0],
                        ops[1], pk.bin_size, index.k_scan, acc, scale=scale,
                        int4_packed=pk.int4_packed)


def phase_serve(prk, testing, data, results, seed, acc):
    """Phase 13: ``SearchServer`` on the card at the Sift1M shape, one CUDA
    graph per bucket, for the f32 tier, int8 and f32 at bf16 compute."""
    import numpy as np

    from repro_torch.search import (
        DISPATCH_COUNTS,
        Index,
        SearchServer,
        ServeConfig,
        VirtualClock,
    )
    from repro_torch.search.faults import FaultInjector

    db = data[0]
    out = {}
    for storage, dtype, label in SERVE_TIERS:
        t_phase = time.perf_counter()
        form, qparts = storage, 3
        if dtype == "bfloat16":
            form, qparts = "bf16" if storage == "f32" else storage, 1
        prk.reset_counts()
        DISPATCH_COUNTS.clear()
        index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                            storage=storage, dtype=dtype)
        server = SearchServer(index, clock=VirtualClock(), warmup=True)
        graphs = {b: index.search_graph(b) for b in server.buckets}
        row = dict(buckets=list(server.buckets),
                   capture_s={str(b): v for b, v in server.capture_s.items()},
                   captures=index.cache_info()["captures"],
                   capture_launches={str(b): g.launches for b, g in graphs.items()})
        log(f"[serve {label}] ladder {server.buckets}, captures "
            f"{row['captures']}, warm-up + capture s per bucket "
            + ", ".join(f"{b}: {v:.3f}" for b, v in server.capture_s.items()))
        want = names_of(form, qparts)[:2]
        for b, g in graphs.items():
            if g.plain_calls or any(g.launches.get(n, 0) != 1 for n in want):
                fail(f"[serve {label}] the graph of bucket {b} holds "
                     f"{g.launches} (plain {g.plain_calls}), not one of each of {want}")
        log(f"[serve {label}] each graph holds {want} once")
        # the path's launches: the warm-up and capture (a replay passes no
        # front end; the direct searches below are the checks')
        read_counts(prk, f"serve {label} (warm-up and capture)", (form,),
                    results, two_pass=False, qparts=qparts)
        compare_bucket_kernels(prk, testing, index, server.buckets, label,
                               seed + 2, acc)
        # the virtual clock: a seeded stream, every ticket a direct search
        reqs = served_requests(seed, 200, SIFT["d"])
        tickets = []
        for s in range(0, len(reqs), 10):
            tickets += [(server.submit(q, k=k), q, k) for q, k in reqs[s:s + 10]]
            server.run_until_idle()
        st = server.stats()
        bad = served_mismatches(index, [(t.result(), q, k) for t, q, k in tickets])
        log(f"[serve {label}] virtual clock: {len(reqs)} requests in "
            f"{st['batches']} batches ({st['graph_replays']} graph replays, "
            f"{st['eager_batches']} eager), occupancy {st['occupancy']:.3f}; "
            f"{len(reqs) - len(bad)} of {len(reqs)} bit-equal to direct searches")
        if bad:
            fail(f"[serve {label}] served results differ from direct searches "
                 f"(rows, k, max |diff|): {bad[:5]}")
        if st["graph_replays"] != st["batches"]:
            fail(f"[serve {label}] {st['graph_replays']} replays for "
                 f"{st['batches']} batches")
        row["virtual"] = dict(requests=len(reqs), batches=st["batches"],
                              graph_replays=st["graph_replays"],
                              occupancy=st["occupancy"])
        q16 = np.random.default_rng(seed + 1).standard_normal(
            (16, SIFT["d"]), dtype=np.float32)
        row["m16"] = serve_latency(index, SearchServer, ServeConfig, q16)
        m16 = row["m16"]
        log(f"[serve {label}] M=16: eager call {m16['eager_ms']:.4f} ms, graph "
            f"replay + host round trip {m16['replay_round_trip_ms']:.4f} ms, "
            f"served request {m16['served_ms']:.4f} ms, card time queued: "
            f"replay {m16['replay_queued_ms']:.4f} ms, eager "
            f"{m16['eager_queued_ms']:.4f} ms")
        # a transient fault at serve.dispatch: the retry gives the clean result
        inj = FaultInjector(schedule=[("serve.dispatch", 1, "transient")])
        faulty = SearchServer(index, clock=VirtualClock(), faults=inj)
        got = faulty.submit(q16).result()
        fs = faulty.stats()
        if served_mismatches(index, [(got, q16, K)]) or \
                (fs["transient_faults"], fs["dispatch_retries"]) != (1, 1):
            fail(f"[serve {label}] the retried dispatch differs or was not "
                 f"retried once: {fs['transient_faults']} faults, "
                 f"{fs['dispatch_retries']} retries")
        log(f"[serve {label}] transient fault at serve.dispatch: retried once, "
            f"result bit-equal to a direct search")
        row["wall"] = serve_wall_clock(index, data, SearchServer, ServeConfig,
                                       label, seed)
        row["dispatches"] = dict(DISPATCH_COUNTS)
        row["seconds"] = time.perf_counter() - t_phase
        log(f"[serve {label}] phase {row['seconds']:.1f} s")
        out[label] = row
        del index, server, faulty, graphs
    results["serve"] = out
    return out


def phase_snapshots(prk, seed, results):
    """Phase 14: snapshots on the card.  A card index of a mixture corpus
    (N=100,000, D=128, l2), f32 and int8, with cluster tables (the
    ``"a100"`` profile keeps them) and without (the default), saved and
    restored on the card: the same tables and the same search bits, and
    no preparation, quantization or k-means at restore; then a snapshot
    the port wrote on the CPU restored on the card, searching as the CPU
    index does (the kernels against the plain versions: the shared
    tie-aware helper)."""
    import tempfile

    from repro_torch.search import PACK_EVENTS, Index
    from repro_torch.testing import assert_topk_close

    db, q, _, _ = mixture_data(seed, 100_000, SIFT["d"], 500)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for storage in ("f32", "int8"):
            for profile, tables in ((None, False), ("a100", True)):
                label = f"{storage} {'with' if tables else 'without'} tables"
                index = Index.build(db, metric=SIFT["metric"], k=K,
                                    recall_target=TARGET, storage=storage,
                                    profile=profile)
                if (index.pack().cluster is not None) != tables:
                    fail(f"[snapshot {label}] tables {index.pack().cluster}")
                v, i = index.search(q)
                t0 = time.perf_counter()
                path = index.save(f"{tmp}/{storage}-{tables}")
                save_s = time.perf_counter() - t0
                PACK_EVENTS.clear()
                t0 = time.perf_counter()
                back = Index.restore(path)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                rv, ri = back.search(q)
                if dict(PACK_EVENTS) != {"restore": 1}:
                    fail(f"[snapshot {label}] restore did build work: "
                         f"{dict(PACK_EVENTS)}")
                if tables and not all(torch.equal(getattr(back.pack().cluster, n),
                                                  getattr(index.pack().cluster, n))
                                      for n in ("centroids", "cluster_rows",
                                                "spill_rows")):
                    fail(f"[snapshot {label}] restored tables differ")
                if not (torch.equal(v, rv) and torch.equal(i, ri)):
                    fail(f"[snapshot {label}] restored search differs")
                out[label] = dict(save_s=save_s, restore_s=restore_s)
                log(f"[snapshot {label}] save {save_s:.3f} s, restore on the "
                    f"card {restore_s:.3f} s, search bit-equal")
                del index, back
        cpu = Index.build(db[:20_000].cpu(), metric=SIFT["metric"], k=K,
                          storage="int8", cluster="off", device="cpu")
        path = cpu.save(f"{tmp}/cpu")
        PACK_EVENTS.clear()
        prk.reset_counts()
        card = Index.restore(path)
        v, i = card.search(q[:200])
        torch.cuda.synchronize()
        cv, ci = cpu.search(q[:200].cpu())
        assert_topk_close(cv.numpy(), ci.numpy(), v.cpu().numpy(), i.cpu().numpy())
        if dict(PACK_EVENTS) != {"restore": 1} or card.device.type != "cuda" \
                or not prk.LAUNCHES:
            fail(f"[snapshot cpu -> card] {dict(PACK_EVENTS)}, "
                 f"{dict(prk.LAUNCHES)}")
        log(f"[snapshot cpu -> card] an int8 index written on the CPU restored on "
            f"the card: its kernels {dict(prk.LAUNCHES)}, search agrees with the "
            f"CPU's")
    results["snapshots"] = out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import testing
    from repro_torch.kernels import build, partial_reduce as prk
    from repro_torch.search import DISPATCH_COUNTS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_lines()

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info()
    log(f"build: {time.perf_counter() - t0:.1f} s ({info['command']})")
    one_pass = []
    for row in build.report(info["library"], info["ptxas"]):
        label = kernel_label(row["kernel"])
        log(f"  {label}: {row['registers']} registers, stack frame "
            f"{row['stack']} B, spill stores {row['spill_stores']} B, loads "
            f"{row['spill_loads']} B, static smem {row['smem']} B, "
            f"{row['hgmma']} HGMMA"
            + "".join(f"\n    {w}" for w in row["warnings"]))
        if label.startswith("pr_scan_kernel") and not row["hgmma"]:
            fail(f"{label} has no tensor-core (HGMMA) instruction")
        if label.startswith(("pr_merge_kernel", "pr_scan_kernel")) and (
                row["stack"] or row["spill_stores"] or row["spill_loads"]):
            fail(f"{label} has a stack frame or spills")
        if "1 query part" in label:
            one_pass.append(label)
    if len(one_pass) != 2 * len(ONE_PASS_FORMS):
        fail(f"the build has {len(one_pass)} one-pass scan instantiations, "
             f"not {2 * len(ONE_PASS_FORMS)}: {one_pass}")
    for form in FORMS:
        ks = SIFT_PLAN[form][1]
        log(f"  scan shared memory at d={SIFT['d']}, {form}: fused (k_scan "
            f"{ks}) {prk.scan_smem(form, True, SIFT['d'], ks)}, two-pass "
            f"{prk.scan_smem(form, False, SIFT['d'])}")

    lib = build.load_library()
    empty_ms = queued_ms(lambda: build.check(
        lib, lib.pr_empty(torch.cuda.current_stream().cuda_stream), "empty kernel"))
    log(f"empty kernel launch: {empty_ms:.4f} ms (device time per call, "
        f"queued back to back)")

    names = sorted({n for form in FORMS for n in names_of(form)}
                   | {n for form in ONE_PASS_FORMS for n in names_of(form, 1)})
    acc = {"errs": dict.fromkeys(names, 0.0), "agree": dict.fromkeys(names, 0),
           "total": dict.fromkeys(names, 0)}
    phase_kernels(prk, testing, args.seed, acc)
    phase_merge_ties(prk, testing, args.seed)
    phase_one_pass_kernels(prk, testing, args.seed, acc)

    results = {"launches": {}, "plain_calls": {}}
    data = {cfg["name"]: make_data(cfg, args.seed + i)
            for i, cfg in enumerate((SIFT, GLOVE))}
    # Each path: the counts set to 0 just before it, read just after.
    prk.reset_counts()
    DISPATCH_COUNTS.clear()
    f32 = {"sift1m": drive(SIFT, data["sift1m"], SIFT["m"], results),
           "glove1.2m": drive(GLOVE, data["glove1.2m"], 2_000, results)}
    read_counts(prk, "f32", ("f32",), results)
    tiers = {}
    for storage in TIERS:
        prk.reset_counts()
        tiers[storage] = drive(SIFT, data["sift1m"], SIFT["m"], results, storage)
        if storage == "int4":
            tiers["glove int4"] = drive(GLOVE, data["glove1.2m"], 2_000, results,
                                        storage)
        read_counts(prk, storage, (storage,), results)
    log(f"searches {dict(DISPATCH_COUNTS)}")

    from repro_torch.search import Index

    sift_q, glove_q = data["sift1m"][1], data["glove1.2m"][1]
    shapes = []
    for cfg, q in ((SIFT, sift_q), (GLOVE, glove_q)):
        fresh = Index.build(data[cfg["name"]][0], metric=cfg["metric"], k=K,
                            recall_target=TARGET, cluster="off")
        shapes += [(f"{cfg['name']} before updates", cfg, fresh, q),
                   (f"{cfg['name']} after updates", cfg, f32[cfg["name"]], q)]
    shapes += [(f"sift1m {s} after updates", SIFT, tiers[s], sift_q) for s in TIERS]
    shapes.append(("glove1.2m int4 after updates", GLOVE, tiers["glove int4"],
                   glove_q[:2_000]))
    phase_main_shapes(prk, testing, shapes, acc)
    del f32, tiers, shapes
    results["max_abs_err"] = acc["errs"]
    results["index_agreement"] = {k: acc["agree"][k] / max(acc["total"][k], 1)
                                  for k in names}
    sift = data["sift1m"]
    db, q = sift[:2]
    del data
    kernels, row_bytes, merge_rows = [], {}, []
    for storage in FORMS:
        ks, row_bytes[storage] = time_form(prk, testing, db, q, storage, results,
                                           empty_ms, merge_rows)
        kernels += ks
    slow = [r for r in merge_rows if r["ms"] > r["topk_ms"]]
    log(f"merge slower than torch.topk on the same carries at "
        f"{len(slow)} of {len(merge_rows)} plans: "
        f"{[(r['label'], r['m']) for r in slow]}")
    next(k for k in kernels if k["name"] == "fused_carry_merge")["plans"] = [
        {key: r[key] for key in ("label", "m", "splits", "k_scan", "ms",
                                 "topk_ms", "bound_ms")} for r in merge_rows]
    log(f"stored bytes per row at D={SIFT['d']} (beside a 4-byte bias, and "
        f"a 4-byte scale for int8 and int4): {row_bytes}")
    if 2 * row_bytes["int4"] != row_bytes["int8"]:
        fail(f"int4 rows take {row_bytes['int4']} bytes, not half of int8's "
             f"{row_bytes['int8']}")
    fused = {k["name"]: k for k in kernels}
    bounds = {}
    for form in FORMS:
        entry = fused[names_of(form)[0]]
        bounds[form, SIFT["m"]] = entry["bound_parts"]["tensor_ms"]
        bounds[form, 16] = entry["bound_parts_m16"]["bytes_ms"]
    planner = phase_planner(prk, testing, (db, q),
                            make_data(GLOVE, args.seed + 1)[:2], bounds, results,
                            args.seed)

    # phase 10: the bf16 compute dtype, each path's counts from 0
    prk.reset_counts()
    for storage in ("f32", "int8", "int4"):
        drive_bf16(sift, storage, results)
    read_counts(prk, "bf16 compute", ONE_PASS_FORMS, results, qparts=1)
    for storage in ("f32", "int8", "int4"):
        kernels += time_one_pass(prk, db, q, storage, results, empty_ms)
    # phases 11 and 12: cluster pruning
    clusters = {"gaussian": phase_clusters_gaussian(prk, sift, results)}
    del sift, db, q
    clusters["mixture"] = phase_clusters_mixture(prk, args.seed + 7, results)
    # phase 13: serving, one CUDA graph per bucket; phase 14: snapshots
    serve = phase_serve(prk, testing, make_data(SIFT, args.seed), results,
                        args.seed, acc)
    snapshots = phase_snapshots(prk, args.seed + 9, results)
    for k in kernels:
        for key in ("launches", "plain_calls"):
            k[key] = results[key].get(k["name"], 0)
        if k["name"] in acc["errs"]:  # phase 13's bucket shapes included
            k["max_abs_err"] = acc["errs"][k["name"]]
            k["index_agreement"] = (acc["agree"][k["name"]]
                                    / max(acc["total"][k["name"]], 1))
    log(json.dumps({"planner": planner}))
    log(json.dumps({"clusters": clusters}))
    log(json.dumps({"serve": serve, "snapshots": snapshots}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
